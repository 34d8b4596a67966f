"""Resumable runs: segment checkpoints and kill-and-resume (counterpart of
``repro.fl.resume``).

The horizon is cut into ``cfg.checkpoint_every``-round segments (default
``eval_every``), each run by the engine's one round transition
(:func:`repro_torch.fl.engine.build_chunk_sim`: the same ``fold_in``
streams over absolute round ids, the same operations in the same order):

* **checkpoints** — after segment ``i`` the whole carry (``FLState``, the
  energy ledger and, with faults on, the fault state) goes to
  ``<ckpt_dir>/seg_i`` (:mod:`repro_torch.checkpoint`), the segment's round
  trace to ``seg_i_trace.npz``, and a ``seg_i.done`` marker commits the
  pair: a crash mid-write leaves no marker and the segment reruns.
* **resume** — a later :func:`run_resumable` on the same directory checks
  the run's fingerprint (horizon, seed, K, fault and guard configs, ...),
  restores the last committed carry and runs on from the first missing
  segment.  Segment boundaries change no stream and no operation order, so
  a killed-and-resumed run ends with the uninterrupted run's bits, faults
  included.
* **replay evals** — with ``cfg.eval_mode="replay"`` the rounds evaluate
  nothing; run_resumable evaluates the segment-boundary checkpoints at the end
  in one batched pass.

The device path and the stream path resume (both index streams are pure
functions of ``(data_key, t)``); the prestack path's host iterators carry
state across rounds, so it is refused.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .. import random as jr
from .. import resolve_device
from ..checkpoint import load_checkpoint, save_checkpoint
from ..core.channel import CellConfig
from ..core.selection import as_policy_fn
from ..data.device import StreamingSampler, data_stream_key
from ..data.synthetic import Dataset
from ..obs.telemetry import (config_fingerprint, emit_run_manifest,
                             env_fingerprint, get_telemetry)
from ..optim import Optimizer, sgd
from .engine import (RoundTrace, SimConfig, SimResult, _as_store, _gains,
                     _num_clients, _shards, _test_slice, _to_result,
                     build_chunk_sim, concat_traces, hoisted_policy,
                     init_carry, resolve_data_path)

__all__ = ["run_resumable", "segment_bounds", "completed_segments",
           "read_segment_manifest"]


def segment_bounds(rounds: int, stride: int) -> list:
    """``[(t0, t1), ...]`` covering ``[0, rounds)`` in ``stride``-round
    segments (the last may be shorter)."""
    C = max(1, int(stride))
    return [(t0, min(t0 + C, rounds)) for t0 in range(0, rounds, C)]


def _fingerprint(cfg: SimConfig, num_clients: int, data_path: str) -> dict:
    """What must match for a resume to be sound: whatever changes a
    stream, a shape or a round's arithmetic."""
    return {
        "rounds": cfg.rounds, "local_iters": cfg.local_iters,
        "batch_size": cfg.batch_size, "lr": cfg.lr, "seed": cfg.seed,
        "eval_every": cfg.eval_every, "eval_mode": cfg.eval_mode,
        "max_staleness": cfg.max_staleness, "aging_boost": cfg.aging_boost,
        "local_mode": cfg.local_mode, "data_stream": cfg.data_stream,
        "data_path": data_path, "num_clients": num_clients,
        "checkpoint_every": cfg.checkpoint_every,
        "faults": repr(cfg.faults), "guards": repr(cfg.guards),
        "metrics": repr(cfg.metrics),
    }


def _seg_base(ckpt_dir: str, i: int) -> str:
    return os.path.join(ckpt_dir, f"seg_{i:05d}")


def completed_segments(ckpt_dir: str, n_segments: int) -> int:
    """The number of leading segments with a ``.done`` marker; a gap ends
    the count (later segments rerun)."""
    n = 0
    for i in range(n_segments):
        if not os.path.exists(_seg_base(ckpt_dir, i) + ".done"):
            break
        n += 1
    return n


def _trace_numpy(trace: RoundTrace) -> dict:
    return {f: (v if isinstance(v, np.ndarray) else v.cpu().numpy())
            for f, v in zip(RoundTrace._fields, trace)}


def _save_segment(ckpt_dir: str, i: int, carry, trace: RoundTrace,
                  meta: dict) -> None:
    base = _seg_base(ckpt_dir, i)
    save_checkpoint(base, carry, metadata=meta)
    np.savez(base + "_trace.npz", **_trace_numpy(trace))
    with open(base + ".done", "w") as f:
        f.write("ok")


def _load_trace(ckpt_dir: str, i: int, device) -> RoundTrace:
    with np.load(_seg_base(ckpt_dir, i) + "_trace.npz") as data:
        return RoundTrace(**{
            f: (data[f] if f == "did_eval"
                else torch.from_numpy(data[f]).to(device))
            for f in RoundTrace._fields})


def _manifest_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "manifest.jsonl")


def _append_segment_manifest(ckpt_dir: str, entry: dict) -> None:
    with open(_manifest_path(ckpt_dir), "a") as f:
        f.write(json.dumps(entry, sort_keys=True) + "\n")


def read_segment_manifest(ckpt_dir: str) -> list:
    """Every segment-manifest entry in ``ckpt_dir``, in append order: one
    per *executed* segment, so a segment that ran twice (killed, then
    resumed) appears twice."""
    path = _manifest_path(ckpt_dir)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def run_resumable(init_params: Any, loss_fn: Callable, acc_fn: Callable,
                  client_data: Sequence[Dataset], test_ds: Dataset, policy,
                  h_all, cell: CellConfig, cfg: SimConfig, ckpt_dir: str,
                  opt: Optimizer | None = None,
                  stop_after_segment: Optional[int] = None,
                  data_budget_bytes: int | None = None,
                  device=None) -> SimResult | None:
    """Run (or continue) a checkpointed simulation on ``device`` (``None``
    means the card) and return the usual :class:`SimResult`.

    ``stop_after_segment=n`` returns ``None`` after committing ``n`` *new*
    segments (a kill, for the tests); the next call on ``ckpt_dir`` picks
    up where it stopped.  ``h_all`` is ``[K, rounds]``."""
    device = resolve_device(device)
    K = _num_clients(client_data)
    T = cfg.rounds
    policy_fn = as_policy_fn(policy)
    path = resolve_data_path(client_data, cfg, None, data_budget_bytes,
                             device)
    if path == "prestack":
        raise ValueError(
            "the prestack data path consumes stateful host iterators and "
            "cannot resume mid-stream; use data_path='device' or 'stream' "
            "(both draw from stateless fold_in index streams)")
    stride = cfg.checkpoint_every or cfg.eval_every
    bounds = segment_bounds(T, stride)
    os.makedirs(ckpt_dir, exist_ok=True)
    fp = _fingerprint(cfg, K, path)
    cfg_sha = config_fingerprint(cfg)
    env_fp = env_fingerprint()
    emit_run_manifest("run_resumable", cfg,
                      extra={"path": path, "num_clients": K,
                             "ckpt_dir": ckpt_dir, "segments": len(bounds)})

    test_x, test_y = _test_slice(test_ds, cfg, device)
    h_rounds = _gains(h_all, device)
    key = jr.PRNGKey(cfg.seed, device=device)
    chunk = build_chunk_sim(loss_fn, acc_fn, opt or sgd(cfg.lr), cfg, cell,
                            K, policy_fn,
                            data_mode="device" if path == "device"
                            else "prestack")
    if path == "device":
        store = _as_store(client_data, device)
        data_key = data_stream_key(cfg.seed, device=device)
    else:
        sampler = StreamingSampler(_shards(client_data, path),
                                   data_stream_key(cfg.seed),
                                   cfg.local_iters, cfg.batch_size,
                                   device=device)

    with torch.no_grad():
        pw_full = hoisted_policy(policy_fn, h_rounds)

        # --- restore ----------------------------------------------------
        done = completed_segments(ckpt_dir, len(bounds))
        like = init_carry(init_params, K, cfg, device)
        if done > 0:
            carry, meta = load_checkpoint(_seg_base(ckpt_dir, done - 1), like)
            if meta.get("fingerprint") != fp:
                raise ValueError(
                    f"checkpoint directory {ckpt_dir!r} holds a different "
                    f"run (saved {meta.get('fingerprint')} vs current {fp}); "
                    "use a fresh directory or matching config")
            traces = [_load_trace(ckpt_dir, i, device) for i in range(done)]
        else:
            carry, traces = like, []

        # --- run the remaining segments ----------------------------------
        fresh = 0
        tel = get_telemetry()
        for i in range(done, len(bounds)):
            t0, t1 = bounds[i]
            pw = (None if pw_full is None
                  else (pw_full[0][t0:t1], pw_full[1][t0:t1]))
            t_start = time.perf_counter()
            with tel.span("resume.segment"):
                if path == "device":
                    carry, tr = chunk(carry, range(t0, t1), h_rounds[t0:t1],
                                      pw, store, data_key, key, test_x,
                                      test_y)
                else:
                    xb, yb = sampler.chunk(t0, t1)
                    carry, tr = chunk(carry, range(t0, t1), h_rounds[t0:t1],
                                      xb, yb, pw, key, test_x, test_y)
                # the save reads the carry back, so the span covers the
                # segment's execution, not only its enqueue
                _save_segment(ckpt_dir, i, carry, tr,
                              {"t0": t0, "t1": t1, "segment": i,
                               "fingerprint": fp})
            _append_segment_manifest(ckpt_dir, {
                "segment": i, "t0": t0, "t1": t1, "seed": cfg.seed,
                "stride": stride, "config_sha": cfg_sha,
                "fingerprint": env_fp,
                "wall_s": time.perf_counter() - t_start,
                "written_unix": time.time(),
            })
            traces.append(tr)
            fresh += 1
            if stop_after_segment is not None and \
                    fresh >= stop_after_segment and i + 1 < len(bounds):
                return None                                # a kill

        trace = concat_traces(traces)
        if cfg.eval_mode == "replay":
            return _replay_result(carry, trace, cfg, bounds, ckpt_dir, like,
                                  loss_fn, acc_fn, test_x, test_y)
        return _to_result(carry, trace, cfg)


def _replay_result(carry, trace: RoundTrace, cfg: SimConfig, bounds,
                   ckpt_dir: str, like, loss_fn, acc_fn, test_x,
                   test_y) -> SimResult:
    """The strided evals after the run: every segment-boundary checkpoint's
    global model, evaluated in one batched pass (the models stacked on a
    leading axis, the test set broadcast to each)."""
    rows = torch.stack([load_checkpoint(_seg_base(ckpt_dir, i), like)[0][0]
                        .global_params for i in range(len(bounds))])
    g = like[0].layout.unflatten(rows)
    xs = test_x.expand((rows.shape[0],) + tuple(test_x.shape))
    ys = test_y.expand((rows.shape[0],) + tuple(test_y.shape))
    accs = acc_fn(g, xs, ys).to(torch.float32)
    losses = loss_fn(g, xs, ys).to(torch.float32)
    out = _to_result(carry, trace, cfg)
    return out._replace(test_acc=accs.cpu().numpy(),
                        test_loss=losses.cpu().numpy(),
                        eval_rounds=np.asarray([t1 - 1 for _, t1 in bounds]))
