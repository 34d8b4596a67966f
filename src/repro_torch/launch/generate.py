"""Batched text generation: prefill a prompt batch, then greedy
decode.  Counterpart of ``repro.launch.generate``.

    PYTHONPATH=src python -m repro_torch.launch.generate --arch llama3.2-1b \
        --batch 4 --prompt-len 1024 --new-tokens 32            # on the card
    PYTHONPATH=src python -m repro_torch.launch.generate --arch llama3.2-1b \
        --reduced --device cpu

The same flags as the JAX entry point plus ``--device`` (the card unless told
otherwise), the same printed lines, and the same telemetry: the counters
``serve.requests`` and ``serve.tokens_generated``, the spans
``serve.prefill`` and ``serve.decode_step`` (plus ``serve.init`` for the
weights' initialisation), and the ``kind="serve"`` run manifest written to
``runs.jsonl`` when ``REPRO_OBS_DIR`` is set.  One seed gives the JAX
entry point's weights and prompts (the port's threefry), so on the CPU in
float32 it prints the JAX entry point's tokens.  The prefill runs K2 once
per attention layer and K3 once per Mamba layer on the card; the decode loop
runs eagerly under ``torch.inference_mode()``.  :func:`generate` is the body
of ``main`` for a config already built (``chip_smoke.py`` drives it with a
config cut in depth).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import configs, resolve_device
from .. import random as jr
from ..configs.base import ArchConfig
from ..models import transformer as T
from ..obs.telemetry import emit_run_manifest, get_telemetry


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Parse the flags, build the config and :func:`generate`; returns what
    :func:`generate` returns."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.embeds_input:
        cfg = dataclasses.replace(cfg, embeds_input=False)  # decode over tokens
    return generate(cfg, batch=args.batch, prompt_len=args.prompt_len,
                    new_tokens=args.new_tokens, seed=args.seed,
                    device=args.device, arch=args.arch)


def generate(cfg: ArchConfig, batch: int = 4, prompt_len: int = 32,
             new_tokens: int = 16, seed: int = 0, device=None,
             arch: str | None = None) -> dict:
    """Initialise ``cfg``'s weights and a prompt batch from ``seed``,
    prefill, then greedy-decode ``new_tokens``; print the entry point's
    lines.  Returns the generated tokens ``[batch, new_tokens]`` (on the
    CPU), the prefill and per-token decode times in seconds, and the model.
    ``arch`` is the name recorded in the run manifest (default
    ``cfg.name``)."""
    device = resolve_device(device)
    tel = get_telemetry()
    tel.inc("serve.requests", batch)
    emit_run_manifest("serve", cfg,
                      extra={"arch": arch or cfg.name, "batch": batch,
                             "prompt_len": prompt_len,
                             "new_tokens": new_tokens,
                             "device": str(device)})

    key = jr.PRNGKey(seed)
    with tel.span("serve.init"):
        model = T.init_params(key, cfg, device=device)
        prompts = jr.randint(key, (batch, prompt_len), 0, cfg.vocab,
                             device=device)
        _sync(device)
    capacity = prompt_len + new_tokens

    with torch.inference_mode():
        t0 = time.perf_counter()
        with tel.span("serve.prefill"):
            logits, caches = T.prefill(model, tokens=prompts,
                                       capacity=capacity)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            _sync(device)
        t_prefill = time.perf_counter() - t0

        outs = [tok]
        t0 = time.perf_counter()
        for _ in range(new_tokens - 1):
            with tel.span("serve.decode_step"):
                logits, caches = T.decode_step(model, tok, caches)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            outs.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0
    tel.inc("serve.tokens_generated", batch * new_tokens)

    gen = torch.cat(outs, dim=1).cpu()
    per_tok = t_decode / max(new_tokens - 1, 1)
    print(f"[generate] {cfg.name}: batch={batch} "
          f"prefill({prompt_len} tok) {t_prefill*1e3:.1f} ms, "
          f"decode {new_tokens - 1} steps {per_tok * 1e3:.1f} ms/tok")
    for b in range(min(batch, 2)):
        print(f"[generate] sample {b}: {gen[b, :12].tolist()} ...")
    for name in ("serve.init", "serve.prefill", "serve.decode_step"):
        s = tel.span_stats(name)
        if s:
            print(f"[generate] span {name}: n={s['count']} "
                  f"total={s['total_s']*1e3:.1f} ms "
                  f"max={s['max_s']*1e3:.1f} ms")
    return {"tokens": gen, "prefill_s": t_prefill, "decode_s_per_token":
            per_tok, "model": model}


if __name__ == "__main__":
    main()
