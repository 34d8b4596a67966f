"""Mamba (S6 selective-state-space) mixer.  Counterpart of
``repro.models.mamba``.  The recurrence per channel c and state n:

    h_t = exp(Δ_t·A) ⊙ h_{t-1} + (Δ_t·B_t)·x_t
    y_t = C_t·h_t + D ⊙ x_t

:func:`mamba_forward` (forward and prefill) runs the scan through
``kernels.ops.selective_scan``: K3, the hand-written CUDA kernel, on a CUDA
tensor, its plain sequential version on a CPU tensor — where the JAX
package runs a chunked ``lax.associative_scan`` (its TPU kernel is the
Pallas one with the same math).  Both give the final state that the
prefill's cache keeps.  :func:`mamba_decode` is the O(1) recurrence in plain
tensor code, as in JAX.

Weights keep JAX's ``[n_in, n_out]`` layout and dtypes: ``dt_proj``,
``dt_bias``, ``A_log`` and ``D`` are float32, the rest the model's dtype.
Cache: (conv tail ``[B, k-1, di]``, ssm state ``[B, di, N]`` float32).

The activation-sharding hints (:mod:`.pshard`) sit where JAX's do on the
tensors the port has: the input projection, the conv output and the scan
output (JAX ``mamba.py:104,107,133``).  JAX's hints on the chunk's
``[B, c, di, N]`` terms and the carried state (``:122,123,131``) have no
tensor here: K3 takes the whole sequence and keeps them inside.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import random as jr
from .. import resolve_device
from ..configs.base import ArchConfig
from ..kernels import ops
from .layers import dense_init
from .pshard import settle, shard_last


class MambaCache(NamedTuple):
    conv: torch.Tensor   # [B, k-1, di] last inputs to the causal conv
    ssm: torch.Tensor    # [B, di, N] float32


def _dims(cfg: ArchConfig):
    di = cfg.ssm_expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return di, dt_rank, cfg.ssm_state, cfg.ssm_conv


class Mamba(nn.Module):
    """The Mamba mixer's weights, named as JAX names them.  Allocated
    uninitialised: :func:`init_mamba` or ``convert.load_jax_tree`` fills
    them."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        device = resolve_device(device)
        d = cfg.d_model
        di, dt_rank, N, k = _dims(cfg)

        def param(shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)

        f32 = torch.float32
        self.in_proj = param((d, 2 * di))
        self.conv_w = param((k, di))
        self.conv_b = param((di,))
        self.x_proj = param((di, dt_rank + 2 * N))
        self.dt_proj = param((dt_rank, di), f32)
        self.dt_bias = param((di,), f32)
        self.A_log = param((di, N), f32)
        self.D = param((di,), f32)
        self.out_proj = param((di, d))


def _f32(v: float) -> float:
    return float(np.float32(v))


@torch.no_grad()
def init_mamba(p: Mamba, key) -> None:
    """Fill ``p`` in place with JAX's ``init_mamba`` draws for ``key``:
    uniform ``dt`` in log space on [1e-3, 0.1] and its inverse softplus as
    ``dt_bias``, S4D-real ``A_log = log(1..N)``, ``D = 1``."""
    di, N = p.A_log.shape
    k = p.conv_w.shape[0]
    dev = p.A_log.device
    ks = jr.split(key, 8)
    lo, hi = math.log(0.001), math.log(0.1)
    dt = torch.exp(jr.uniform(ks[0], (di,), device=dev) * _f32(hi - lo)
                   + _f32(lo))
    p.dt_bias.copy_(dt + torch.log1p(-torch.exp(-dt)))
    for w, kk in ((p.in_proj, ks[1]), (p.x_proj, ks[3]), (p.dt_proj, ks[4]),
                  (p.out_proj, ks[5])):
        w.copy_(dense_init(kk, *w.shape, w.dtype, dev))
    p.conv_w.copy_((jr.normal(ks[2], (k, di), device=dev)
                    / _f32(math.sqrt(float(k)))).to(p.conv_w.dtype))
    p.conv_b.zero_()
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev)
    p.A_log.copy_(torch.log(A)[None, :].expand(di, N))
    p.D.fill_(1.0)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(−|x|))``
    (no linear cut-off above a threshold, unlike ``F.softplus``)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_inputs(p: Mamba, cfg: ArchConfig, xc):
    """xc: [B,S,di] post-conv activations → (dt [B,S,di], B [B,S,N],
    C [B,S,N], A [di,N]), all float32."""
    _, dt_rank, N, _ = _dims(cfg)
    proj = settle((xc @ p.x_proj).float())     # its partial sums, reduced
    dt_in, Bc, Cc = proj.split([dt_rank, N, N], dim=-1)
    dt = softplus(dt_in @ p.dt_proj + p.dt_bias)
    return dt, Bc, Cc, -torch.exp(p.A_log)


def _conv(p: Mamba, x, cfg: ArchConfig, tail=None):
    """Causal depthwise conv1d.  x: [B,S,di]; tail: [B,k-1,di] or None.
    The taps are summed in the model dtype in JAX's order, then the bias is
    added and silu applied.  Returns (out, the new tail)."""
    k = cfg.ssm_conv
    if tail is None:                                    # zeros before x
        xp = torch.cat([x.new_zeros(x.shape[0], k - 1, x.shape[2]), x],
                       dim=1)                           # [B,S+k-1,di]
    else:
        xp = torch.cat([tail, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * p.conv_w[i] for i in range(k))
    return F.silu(out + p.conv_b), xp[:, -(k - 1):].clone()


def mamba_forward(p: Mamba, cfg: ArchConfig, x, return_cache: bool = False):
    """x: [B,S,d] → y [B,S,d] (+ a :class:`MambaCache` for decode)."""
    xin, z = shard_last(x @ p.in_proj).chunk(2, dim=-1)
    xc, tail = _conv(p, xin, cfg)
    xc = shard_last(xc)
    dt, Bc, Cc, A = _ssm_inputs(p, cfg, xc)
    y, h_last = ops.selective_scan(xc, dt, Bc, Cc, A, p.D)
    out = (shard_last(y).to(x.dtype) * F.silu(z)) @ p.out_proj
    if return_cache:
        return out, MambaCache(conv=tail, ssm=h_last)
    return out


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype,
                     device=None) -> MambaCache:
    di, _, N, k = _dims(cfg)
    device = resolve_device(device)
    return MambaCache(
        conv=torch.zeros(batch, k - 1, di, dtype=dtype, device=device),
        ssm=torch.zeros(batch, di, N, dtype=torch.float32, device=device))


def mamba_decode(p: Mamba, cfg: ArchConfig, x, cache: MambaCache):
    """One-token step.  x: [B,1,d] → (y [B,1,d], new cache)."""
    xin, z = (x @ p.in_proj).chunk(2, dim=-1)
    xc, tail = _conv(p, xin, cfg, tail=cache.conv)
    dt, Bc, Cc, A = _ssm_inputs(p, cfg, xc)                  # S = 1
    x32 = xc[:, 0].float()
    dt0 = dt[:, 0, :, None]                                  # [B,di,1]
    h = torch.exp(dt0 * A) * cache.ssm \
        + (dt0 * Bc[:, 0, None, :]) * x32[..., None]         # [B,di,N]
    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0]) + p.D * x32
    y = y[:, None].to(x.dtype) * F.silu(z)
    return y @ p.out_proj, MambaCache(conv=tail, ssm=h)
