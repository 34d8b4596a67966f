"""Shared neural building blocks: RMSNorm, RoPE, SwiGLU, initializers.

Counterparts of ``repro.models.layers``, with the casts in the same order:
``rms_norm`` normalises in float32 and casts back to ``x.dtype`` before it
multiplies by gamma; RoPE is computed in float32 on the half-split (not
interleaved) head dimension and cast back.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import random as jr


def dense_init(key, n_in: int, n_out: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """``normal(key, (n_in, n_out)) · √(1/n_in)`` in float32, then ``dtype``
    (the weight is used as ``x @ w``)."""
    scale = float(np.sqrt(np.float32(1.0 / n_in)))
    return (jr.normal(key, (n_in, n_out), device=device) * scale).to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    ang = positions[..., None].float() * freqs               # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                       # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def init_swiglu(key, d: int, ff: int, dtype, device=None) -> dict:
    k1, k2, k3 = jr.split(key, 3)
    return {"w1": dense_init(k1, d, ff, dtype, device),
            "w3": dense_init(k2, d, ff, dtype, device),
            "w2": dense_init(k3, ff, d, dtype, device)}
