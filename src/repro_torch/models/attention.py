"""GQA attention: full-causal / sliding-window for forward & prefill, and
single-token decode against a (ring-buffer) KV cache.  Counterpart of
``repro.models.attention``.

Layouts:  q [B,S,H,hd]; k,v [B,S,KV,hd]; cache k/v [B,C,KV,hd].  Weights are
kept in JAX's ``[n_in, n_out]`` layout (``x @ w``).

Full-sequence attention (:func:`attn_forward`, :func:`attn_prefill`) goes
through ``kernels.ops.flash_attention``: K2, the hand-written CUDA kernel,
on a CUDA tensor, its plain version on a CPU tensor — where the JAX package
runs the jnp ``_attend_chunked`` (its TPU production path is the Pallas
kernel with the same math).  Decode stays plain tensor code (an einsum and a
float32 softmax over the cache), as it is jnp in JAX.

Two behaviours of the reference are kept as they are (``ROADMAP.md`` lists
them as divergences from a true sliding window):

* :func:`attn_prefill` returns a cache of the ``capacity`` it is given
  (zero-padded, or the last ``capacity`` positions when the prompt is
  longer), not one capped at the window;
* :func:`attn_decode` writes slot ``pos % C`` and attends to every filled
  slot, with no window mask.

Unlike JAX's immutable caches, :func:`attn_decode` writes the new key and
value into the cache tensors in place (it saves a copy of the whole cache
per step) and returns a new :class:`KVCache` over the same tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .. import random as jr
from .. import resolve_device
from ..configs.base import ArchConfig
from ..kernels import ops
from . import pshard
from .layers import apply_rope, dense_init, rms_norm

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor   # [B, C, KV, hd]
    v: torch.Tensor   # [B, C, KV, hd]
    pos: int          # number of tokens already cached


class Attention(nn.Module):
    """The attention mixer's weights: ``wq [d, H·hd]``, ``wk``/``wv
    [d, KV·hd]``, ``wo [H·hd, d]`` and, with ``qk_norm``, ``q_norm``/``k_norm
    [hd]``.  Allocated uninitialised: :func:`init_attn` or
    ``convert.load_jax_tree`` fills them."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.wq = param(d, H * hd)
        self.wk = param(d, KV * hd)
        self.wv = param(d, KV * hd)
        self.wo = param(H * hd, d)
        if cfg.qk_norm:
            self.q_norm = param(hd)
            self.k_norm = param(hd)


@torch.no_grad()
def init_attn(p: Attention, key) -> None:
    """Fill ``p`` in place with JAX's ``init_attn`` draws for ``key``."""
    ks = jr.split(key, 4)
    for w, k in zip((p.wq, p.wk, p.wv, p.wo), ks):
        w.copy_(dense_init(k, *w.shape, w.dtype, w.device))
    if p.cfg.qk_norm:
        p.q_norm.fill_(1.0)
        p.k_norm.fill_(1.0)


def init_cache(cfg: ArchConfig, batch: int, capacity: int, dtype,
               device=None) -> KVCache:
    KV, hd = cfg.n_kv_heads, cfg.hd
    device = resolve_device(device)
    return KVCache(
        k=torch.zeros(batch, capacity, KV, hd, dtype=dtype, device=device),
        v=torch.zeros(batch, capacity, KV, hd, dtype=dtype, device=device),
        pos=0)


def _qkv(p: Attention, cfg: ArchConfig, x, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = pshard.whole_heads(x @ p.wq, H).reshape(B, S, H, hd)
    k = pshard.whole_heads(x @ p.wk, KV).reshape(B, S, KV, hd)
    v = pshard.whole_heads(x @ p.wv, KV).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores(q, k, cfg: ArchConfig):
    """q [B,S,H,hd], k [B,T,KV,hd] → scores [B,KV,G,S,T] (G = H/KV)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = pshard.whole_heads(q, KV, dim=2).reshape(B, S, KV, H // KV, hd)
    scale = torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    return torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) / scale


def _attend(scores, v, mask):
    """scores [B,KV,G,S,T], v [B,T,KV,hd] → out [B,S,H,hd] float32."""
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    B, S, KV, G, hd = out.shape
    return out.reshape(B, S, KV * G, hd)


def _full_attention(p: Attention, cfg: ArchConfig, x, positions):
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    out = ops.flash_attention(q, *pshard.gqa_heads(q, k, v), causal=True,
                              window=cfg.sliding_window)
    out = pshard.whole_heads(out.reshape(B, S, -1), cfg.n_heads)
    return (out.to(x.dtype) @ p.wo).to(x.dtype), k, v


def attn_forward(p: Attention, cfg: ArchConfig, x, positions):
    """Full-sequence causal (optionally sliding-window) attention."""
    return _full_attention(p, cfg, x, positions)[0]


def attn_prefill(p: Attention, cfg: ArchConfig, x, positions, capacity: int):
    """Forward + build the KV cache (last ``capacity`` positions)."""
    S = x.shape[1]
    y, k, v = _full_attention(p, cfg, x, positions)
    if capacity >= S:
        # zeros after the prompt (a concatenation: DTensor's ``pad`` fails
        # on some PyTorch releases)
        B, _, KV, hd = k.shape
        ck = torch.cat([k, k.new_zeros(B, capacity - S, KV, hd)], dim=1)
        cv = torch.cat([v, v.new_zeros(B, capacity - S, KV, hd)], dim=1)
    else:  # keep the most recent window
        ck, cv = k[:, S - capacity:].clone(), v[:, S - capacity:].clone()
    return y, KVCache(k=ck, v=cv, pos=S)


def attn_decode(p: Attention, cfg: ArchConfig, x, cache: KVCache):
    """One-token decode: x [B,1,d]; attends to cache + itself.  Writes the
    new k/v into ``cache``'s tensors in place."""
    B = x.shape[0]
    C = cache.k.shape[1]
    positions = torch.full((B, 1), cache.pos, dtype=torch.int64,
                           device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    slot = cache.pos % C                                   # ring slot
    pshard.write_slot(cache.k, slot, k[:, 0])
    pshard.write_slot(cache.v, slot, v[:, 0])
    scores = _gqa_scores(q, cache.k, cfg)                  # [B,KV,G,1,C]
    valid = torch.arange(C, device=x.device) <= min(cache.pos, C - 1)
    out = _attend(scores, cache.v, valid)                  # all once pos ≥ C
    # float32 @ the weight's dtype promotes to float32 in JAX; one 2-D
    # product, as matmul folds it on a plain tensor (on a DTensor matmul
    # would broadcast the weight into a batched product of another order)
    y = (out.reshape(B, -1) @ p.wo.float()).to(x.dtype).reshape(B, 1, -1)
    return y, KVCache(k=cache.k, v=cache.v, pos=cache.pos + 1)
