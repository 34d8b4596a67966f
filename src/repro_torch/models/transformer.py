"""Generic decoder stack: embed → layers → norm → logits.  Counterpart of
``repro.models.transformer`` for the attention mixer and the dense SwiGLU
FFN; the ``mamba``, ``mlstm`` and ``slstm`` mixers and the ``moe`` FFN are
not ported yet and raise ``NotImplementedError``.

:class:`Transformer` is an ``nn.Module`` whose layers are an
``nn.ModuleList`` of :class:`Block` (JAX stacks them on a leading
``[n_repeats]`` axis and scans; layer ``r · len(plan) + i`` here is the
``r``-th slice of JAX's plan position ``i``).  Weights keep JAX's
``[n_in, n_out]`` layout.

Entry points (eager; call them under ``torch.inference_mode()``):
  init_params(key, cfg, device)                 → Transformer
  forward(model, tokens|embeds)                 → (logits [B,S,V] fp32, aux)
  prefill(model, tokens|embeds, capacity)       → (logits [B,1,V], caches)
  decode_step(model, token, caches)             → (logits [B,1,V], caches)
  init_caches(cfg, batch, capacity, dtype, device)
"""
from __future__ import annotations

import torch
from torch import nn

from .. import random as jr
from .. import resolve_device
from ..configs.base import ArchConfig
from . import attention
from .layers import dense_init, init_swiglu, rms_norm, swiglu

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` naming the first mixer or FFN of
    ``cfg`` that the port does not have yet."""
    for mixer, ffn in cfg.layer_plan():
        if mixer != "attn":
            raise NotImplementedError(
                f"{cfg.name}: the {mixer!r} mixer is not ported yet")
        if ffn == "moe":
            raise NotImplementedError(
                f"{cfg.name}: the 'moe' FFN is not ported yet")


class SwiGLU(nn.Module):
    def __init__(self, d: int, ff: int, dtype, device=None):
        super().__init__()
        self.w1 = _param((d, ff), dtype, device)
        self.w3 = _param((d, ff), dtype, device)
        self.w2 = _param((ff, d), dtype, device)

    def forward(self, x):
        return swiglu(x, self.w1, self.w3, self.w2)


class Block(nn.Module):
    """One layer: ``x + mixer(rms_norm(x))``, then ``+ ffn(rms_norm(x))``
    when the layer has an FFN (JAX's ``_apply_layer``)."""

    def __init__(self, cfg: ArchConfig, ffn: str, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.mixer = attention.Attention(cfg, dtype, device)
        if ffn != "none":
            self.ln2 = _param((cfg.d_model,), dtype, device)
            self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, dtype, device)

    def forward(self, x, positions, mode: str = "train", cache=None,
                capacity: int = 0):
        """Returns ``(x, new_cache)``."""
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        new_cache = cache
        if mode == "train":
            y = attention.attn_forward(self.mixer, cfg, h, positions)
        elif mode == "prefill":
            y, new_cache = attention.attn_prefill(self.mixer, cfg, h,
                                                  positions, capacity)
        else:
            y, new_cache = attention.attn_decode(self.mixer, cfg, h, cache)
        x = x + y
        if hasattr(self, "ffn"):
            x = x + self.ffn(rms_norm(x, self.ln2, cfg.norm_eps))
        return x, new_cache


class Transformer(nn.Module):
    """``embed [V, d]``, ``layers``, ``final_norm [d]`` and, unless the
    embeddings are tied, ``unembed [d, V]``.  Allocated uninitialised:
    :func:`init_params` or ``convert.transformer_from_jax`` fills it."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        device = resolve_device(device)
        dtype = _dtype(cfg)
        plan = cfg.layer_plan()
        self.embed = _param((cfg.vocab, cfg.d_model), dtype, device)
        self.layers = nn.ModuleList(
            Block(cfg, ffn, dtype, device)
            for _ in range(cfg.n_repeats) for _, ffn in plan)
        self.final_norm = _param((cfg.d_model,), dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = _param((cfg.d_model, cfg.vocab), dtype, device)

    def forward(self, tokens=None, embeds=None):
        return forward(self, tokens, embeds)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(block: Block, key, cfg: ArchConfig, dtype, device):
    kmix, kffn = jr.split(key)
    block.ln1.fill_(1.0)
    attention.init_attn(block.mixer, kmix)
    if hasattr(block, "ffn"):
        block.ln2.fill_(1.0)
        for name, w in init_swiglu(kffn, cfg.d_model, cfg.d_ff, dtype,
                                   device).items():
            getattr(block.ffn, name).copy_(w)


@torch.no_grad()
def init_params(key, cfg: ArchConfig, device=None) -> Transformer:
    """JAX's ``init_params`` through the port's threefry: one seed gives
    JAX's weights (normals within a few ulps, then the same cast to
    ``cfg.dtype``).  Each leaf is drawn, cast and written in turn, so the
    float32 and int64 temporaries of one leaf are freed before the next."""
    device = resolve_device(device)
    dtype = _dtype(cfg)
    model = Transformer(cfg, device)
    keys = jr.split(key, len(model.layers) + 3)
    for i, block in enumerate(model.layers):
        _init_layer(block, keys[i], cfg, dtype, device)
    model.embed.copy_(jr.normal(keys[-1], (cfg.vocab, cfg.d_model),
                                device=device) * 0.02)
    model.final_norm.fill_(1.0)
    if not cfg.tie_embeddings:
        model.unembed.copy_(dense_init(keys[-2], cfg.d_model, cfg.vocab,
                                       dtype, device))
    return model


def init_caches(cfg: ArchConfig, batch: int, capacity: int, dtype=None,
                device=None) -> list:
    """One empty :class:`attention.KVCache` per layer, capped at the
    sliding window when there is one."""
    check_ported(cfg)
    device = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    cap = min(capacity, cfg.sliding_window) if cfg.sliding_window \
        else capacity
    return [attention.init_cache(cfg, batch, cap, dtype, device)
            for _ in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# model-level API
# ---------------------------------------------------------------------------

def _embed(model: Transformer, tokens=None, embeds=None):
    if embeds is not None:
        return embeds.to(model.embed.dtype)
    return model.embed[tokens.long()]


def _logits(model: Transformer, x):
    x = rms_norm(x, model.final_norm, model.cfg.norm_eps)
    if model.cfg.tie_embeddings:
        return (x @ model.embed.T).float()     # a transposed view, no copy
    return (x @ model.unembed).float()


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def forward_hidden(model: Transformer, tokens=None, embeds=None):
    """Full-sequence causal forward → (hidden [B,S,d], aux)."""
    x = _embed(model, tokens, embeds)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    for block in model.layers:
        x, _ = block(x, positions)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(model: Transformer, tokens=None, embeds=None):
    """Full-sequence causal forward → (logits [B,S,V] fp32, aux)."""
    x, aux = forward_hidden(model, tokens, embeds)
    return _logits(model, x), aux


def prefill(model: Transformer, tokens=None, embeds=None,
            capacity: int | None = None):
    """Process a prompt, returning (last-position logits, caches)."""
    x = _embed(model, tokens, embeds)
    B, S, _ = x.shape
    capacity = capacity or S
    positions = _positions(B, S, x.device)
    caches = []
    for block in model.layers:
        x, cache = block(x, positions, "prefill", capacity=capacity)
        caches.append(cache)
    return _logits(model, x[:, -1:]), caches


def decode_step(model: Transformer, token, caches):
    """One-token decode.  token: [B, 1] ids → (logits [B,1,V], caches)."""
    x = _embed(model, tokens=token)
    new_caches = []
    for block, cache in zip(model.layers, caches):
        x, cache = block(x, None, "decode", cache)
        new_caches.append(cache)
    return _logits(model, x), new_caches
