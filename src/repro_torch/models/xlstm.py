"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory, parallelizable) and
sLSTM (scalar memory, a true recurrence with exponential gating and a
stabilizer).  Counterpart of ``repro.models.xlstm``.

mLSTM forward and prefill use JAX's chunkwise-parallel stabilized form: a
Python loop over blocks of ``c`` tokens carries the ``(C, n, m)``
matrix-memory state, and inside a block the ``[B, H, c, c]`` decay matrix is
masked to its lower triangle before its exponentials are summed.  Decode is
the matrix-memory recurrence

    C_t = f' C_{t-1} + i' v_t k_tᵀ,   n_t = f' n_{t-1} + i' k_t,
    h_t = o_t ⊙ (C_t q_t) / max(|n_tᵀ q_t|, exp(-m_t))

with the log-space stabilizer m_t.  sLSTM is one step per token, eagerly,
with per-head block-diagonal recurrent weights; its four input projections
are taken for the whole sequence at once (JAX takes them inside the scan,
one token at a time: the same products, summed in another order).

Weights keep JAX's ``[n_in, n_out]`` layout and dtypes: the mLSTM's gate
projections ``wi``/``wf`` and every sLSTM weight but ``out`` are float32,
the rest the model's dtype.  No kernel: JAX has none for xLSTM either.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.utils.flop_counter import register_flop_formula

from .. import random as jr
from .. import resolve_device
from ..configs.base import ArchConfig
from ..kernels.ops import _traced
from .costmode import cost_mode
from .layers import dense_init
from .mamba import softplus
from .pshard import whole_heads

#: the stabilizer's starting value, as JAX's ``jnp.full(..., -1e30)``
M_INIT = -1e30


class MLSTMCache(NamedTuple):
    C: torch.Tensor   # [B, H, hd, hd] float32
    n: torch.Tensor   # [B, H, hd] float32
    m: torch.Tensor   # [B, H] float32


class SLSTMCache(NamedTuple):
    c: torch.Tensor   # [B, d] float32
    n: torch.Tensor   # [B, d] float32
    h: torch.Tensor   # [B, d] float32
    m: torch.Tensor   # [B, d] float32


def _f32(v: float) -> float:
    return float(np.float32(v))


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wog``, ``out [d, d]`` in the model's dtype
    and the gate projections ``wi``, ``wf [d, H]`` in float32.  Allocated
    uninitialised: :func:`init_mlstm` or ``convert.load_jax_tree`` fills
    them."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        device = resolve_device(device)
        d, H = cfg.d_model, cfg.n_heads
        f32 = torch.float32
        self.wq = _param((d, d), dtype, device)
        self.wk = _param((d, d), dtype, device)
        self.wv = _param((d, d), dtype, device)
        self.wi = _param((d, H), f32, device)
        self.wf = _param((d, H), f32, device)
        self.wog = _param((d, d), dtype, device)
        self.out = _param((d, d), dtype, device)


@torch.no_grad()
def init_mlstm(p: MLSTM, key) -> None:
    """Fill ``p`` in place with JAX's ``init_mlstm`` draws for ``key``: 7
    keys, one a weight, in JAX's order."""
    ks = jr.split(key, 7)
    for w, k in zip((p.wq, p.wk, p.wv, p.wi, p.wf, p.wog, p.out), ks):
        w.copy_(dense_init(k, *w.shape, w.dtype, w.device))


def _mlstm_qkv(p: MLSTM, cfg: ArchConfig, x):
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    q = whole_heads(x @ p.wq, H).reshape(B, S, H, hd).float()
    k = whole_heads(x @ p.wk, H).reshape(B, S, H, hd).float() \
        / _f32(math.sqrt(hd))
    v = whole_heads(x @ p.wv, H).reshape(B, S, H, hd).float()
    x32 = x.float()
    return q, k, v, x32 @ p.wi, x32 @ p.wf          # gates [B,S,H] pre-act


def _mlstm_block(qc, kc, vc, ic, fc, C0, n0, m0):
    """One chunk of ``c`` tokens: ``qc``, ``kc``, ``vc [B,c,H,hd]``, the
    gates' pre-activations ``ic`` and log forget gates ``fc [B,c,H]``, the
    carried state → (h [B,c,H,hd], (C1, n1, m_end))."""
    c = qc.shape[1]
    F = torch.cumsum(fc, dim=1)                         # [B,c,H]
    Fh = F.transpose(1, 2)                              # [B,H,c]
    ih = ic.transpose(1, 2)
    # running stabilizer: m_t = F_t + max(m0, cummax_{s≤t}(ĩ_s − F_s))
    u = torch.cummax(ih - Fh, dim=2).values
    m = Fh + torch.maximum(m0[..., None], u)            # [B,H,c]
    w_state = torch.exp(m0[..., None] + Fh - m)         # inter-chunk path
    # intra-chunk decay D[t,s] = F_t − F_s + ĩ_s − m_t (s ≤ t)
    D = (Fh[..., :, None] - Fh[..., None, :] + ih[..., None, :]
         - m[..., :, None])                             # [B,H,c,c]
    mask = torch.tril(torch.ones(c, c, dtype=torch.bool, device=qc.device))
    Dp = torch.where(mask, torch.exp(D), 0.0)
    logits = torch.einsum("bshx,bthx->bhst", qc, kc)    # [B,H,c,c]
    W = logits * Dp
    num = (torch.einsum("bhst,bthx->bshx", W, vc)
           + torch.einsum("bhs,bhxy,bshy->bshx", w_state, C0, qc))
    den = (W.sum(-1) + w_state * torch.einsum("bhy,bshy->bhs", n0, qc)
           ).transpose(1, 2)[..., None]                 # [B,c,H,1]
    den = torch.maximum(den.abs(), torch.exp(-m).transpose(1, 2)[..., None])
    h = num / den                                       # [B,c,H,hd]
    # the state at the end of the chunk
    m_end = m[..., -1]                                  # [B,H]
    w_s = torch.exp(Fh[..., -1:] - Fh + ih - m_end[..., None])
    decay0 = torch.exp(m0 + Fh[..., -1] - m_end)        # [B,H]
    kT = kc.transpose(1, 2)                             # [B,H,c,hd]
    vT = vc.transpose(1, 2)
    C1 = decay0[..., None, None] * C0 \
        + torch.einsum("bhs,bhsx,bhsy->bhxy", w_s, vT, kT)
    n1 = decay0[..., None] * n0 + torch.einsum("bhs,bhsx->bhx", w_s, kT)
    return h, (C1, n1, m_end)


def mlstm_forward(p: MLSTM, cfg: ArchConfig, x, return_cache: bool = False,
                  chunk: int = 256):
    """Chunkwise-parallel stabilized mLSTM: x [B,S,d] → y [B,S,d] (+ an
    :class:`MLSTMCache`).  Chunks of ``c = min(chunk, S)`` tokens, or one
    chunk of ``S`` when ``c`` does not divide ``S`` or under
    ``costmode.cost_probe()`` (JAX's rule)."""
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    q, k, v, i_t, f_t = _mlstm_qkv(p, cfg, x)
    logf = -softplus(-f_t)                              # log σ(f̃)  [B,S,H]
    c = min(chunk, S)
    if S % c != 0 or cost_mode():
        c = S
    state = init_mlstm_cache(cfg, B, x.dtype, x.device)
    hs = []
    for s0 in range(0, S, c):
        blk = slice(s0, s0 + c)
        h, state = _mlstm_block(q[:, blk], k[:, blk], v[:, blk],
                                i_t[:, blk], logf[:, blk], *state)
        hs.append(h)
    hsv = torch.cat(hs, dim=1)                          # [B,S,H,hd]
    o = torch.sigmoid(whole_heads(x @ p.wog, H).float()).reshape(B, S, H, hd)
    y = (o * hsv).reshape(B, S, d).to(x.dtype) @ p.out
    if not return_cache:
        return y
    return y, MLSTMCache(*state)


def init_mlstm_cache(cfg: ArchConfig, batch: int, dtype,
                     device=None) -> MLSTMCache:
    H = cfg.n_heads
    hd = cfg.d_model // H
    device = resolve_device(device)
    f32 = torch.float32
    return MLSTMCache(
        C=torch.zeros(batch, H, hd, hd, dtype=f32, device=device),
        n=torch.zeros(batch, H, hd, dtype=f32, device=device),
        m=torch.full((batch, H), M_INIT, dtype=f32, device=device))


def mlstm_decode(p: MLSTM, cfg: ArchConfig, x, cache: MLSTMCache):
    """One-token step.  x: [B,1,d] → (y [B,1,d], new cache)."""
    B, _, d = x.shape
    H = cfg.n_heads
    hd = d // H
    q, k, v, i_t, f_t = _mlstm_qkv(p, cfg, x)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                 # [B,H,hd]
    logf = -softplus(-f_t[:, 0])                        # [B,H]
    logi = i_t[:, 0]
    m_new = torch.maximum(logf + cache.m, logi)
    fp = torch.exp(logf + cache.m - m_new)[..., None]
    ip = torch.exp(logi - m_new)[..., None]
    C = fp[..., None] * cache.C \
        + ip[..., None] * torch.einsum("bhx,bhy->bhxy", v, k)
    n = fp * cache.n + ip * k
    denom = torch.maximum(torch.einsum("bhx,bhx->bh", n, q).abs(),
                          torch.exp(-m_new))[..., None]
    hsv = torch.einsum("bhxy,bhy->bhx", C, q) / denom
    o = torch.sigmoid(whole_heads(x @ p.wog, H).float()).reshape(B, H, hd)
    y = (o * hsv).reshape(B, 1, d).to(x.dtype) @ p.out
    return y, MLSTMCache(C=C, n=n, m=m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

GATES = ("z", "i", "f", "o")


class SLSTM(nn.Module):
    """``out [d, d]`` in the model's dtype; for each gate g of z, i, f, o
    the float32 input projection ``w{g} [d, d]``, the per-head recurrent
    weights ``r{g} [H, hd, hd]`` and the bias ``b{g} [d]``.  Allocated
    uninitialised: :func:`init_slstm` or ``convert.load_jax_tree`` fills
    them."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        device = resolve_device(device)
        d, H = cfg.d_model, cfg.n_heads
        hd = d // H
        f32 = torch.float32
        self.out = _param((d, d), dtype, device)
        for g in GATES:
            setattr(self, "w" + g, _param((d, d), f32, device))
            setattr(self, "r" + g, _param((H, hd, hd), f32, device))
            setattr(self, "b" + g, _param((d,), f32, device))


@torch.no_grad()
def init_slstm(p: SLSTM, key) -> None:
    """Fill ``p`` in place with JAX's ``init_slstm`` draws for ``key``: 10
    keys; ``out`` from key 8, gate g's ``w`` from key g and ``r`` (a
    normal over ``√hd``) from key 4 + g; zero biases."""
    ks = jr.split(key, 10)
    p.out.copy_(dense_init(ks[8], *p.out.shape, p.out.dtype, p.out.device))
    H, hd, _ = p.rz.shape
    for i, g in enumerate(GATES):
        w, r, b = (getattr(p, n + g) for n in "wrb")
        w.copy_(dense_init(ks[i], *w.shape, torch.float32, w.device))
        r.copy_(jr.normal(ks[4 + i], (H, hd, hd), device=r.device)
                / _f32(math.sqrt(float(hd))))
        b.zero_()


def init_slstm_cache(cfg: ArchConfig, batch: int, dtype,
                     device=None) -> SLSTMCache:
    """Zero cell, hidden state and stabilizer; the normalizer starts at 1."""
    device = resolve_device(device)
    z = torch.zeros(batch, cfg.d_model, dtype=torch.float32, device=device)
    return SLSTMCache(c=z, n=torch.ones_like(z), h=z, m=z.clone())


def _slstm_step(p: SLSTM, cfg: ArchConfig, xw, cache: SLSTMCache):
    """One token: ``xw`` holds the four input projections ``x_t @ w{g}``
    (each [B, d], float32) → the new cache."""
    B, d = cache.h.shape
    H = cfg.n_heads
    hh = whole_heads(cache.h, H).reshape(B, H, d // H)

    def pre(g, xg):
        rec = torch.einsum("bhx,hxy->bhy", hh, getattr(p, "r" + g))
        return xg + rec.reshape(B, d) + getattr(p, "b" + g)

    z = torch.tanh(pre("z", xw[0]))
    i_t = pre("i", xw[1])
    f_t = pre("f", xw[2])
    o = torch.sigmoid(pre("o", xw[3]))
    logf = -softplus(-f_t)                       # σ-gated forget, log space
    m_new = torch.maximum(logf + cache.m, i_t)
    fp = torch.exp(logf + cache.m - m_new)
    ip = torch.exp(i_t - m_new)
    c = fp * cache.c + ip * z
    n = torch.maximum(fp * cache.n + ip, torch.exp(-m_new))
    return SLSTMCache(c=c, n=n, h=o * (c / n), m=m_new)


def _input_projections(p: SLSTM, x):
    xf = x.float()
    return [xf @ getattr(p, "w" + g) for g in GATES]


def _slstm_scan(p, cfg: ArchConfig, xw: list, cache: SLSTMCache):
    """The recurrence over the sequence → (h of every step ``[B,S,d]``,
    the final cache)."""
    hs = []
    for t in range(xw[0].shape[1]):
        cache = _slstm_step(p, cfg, [w[:, t] for w in xw], cache)
        hs.append(cache.h)
    return torch.stack(hs, dim=1), cache


_RB = tuple(n + g for n in "rb" for g in GATES)


class _Weights:
    """The recurrent weights and biases as attributes (``rz``, ``bz``,
    ...), as :func:`_slstm_step` reads them."""

    def __init__(self, tensors: dict):
        self.__dict__.update(tensors)


def _scan_plain(n_heads: int, xw: list, weights: list) -> tuple:
    B, _, d = xw[0].shape
    cfg = _HeadsOnly(n_heads)
    zero = torch.zeros(B, d, dtype=torch.float32, device=xw[0].device)
    cache = SLSTMCache(c=zero, n=torch.ones_like(zero), h=zero.clone(),
                       m=zero.clone())
    h, cache = _slstm_scan(_Weights(dict(zip(_RB, weights))), cfg, xw, cache)
    return (h, *cache)


class _HeadsOnly(NamedTuple):
    n_heads: int


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=())
def slstm_scan_op(xz: torch.Tensor, xi: torch.Tensor, xf: torch.Tensor,
                  xo: torch.Tensor, rz: torch.Tensor, ri: torch.Tensor,
                  rf: torch.Tensor, ro: torch.Tensor, bz: torch.Tensor,
                  bi: torch.Tensor, bf: torch.Tensor, bo: torch.Tensor,
                  n_heads: int) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The sLSTM recurrence as one operation: the input projections ``x{g}
    [B,S,d]`` and the recurrent weights and biases → ``(h [B,S,d], c, n,
    h_last, m [B,d])``, float32; the same loop as the eager path."""
    return _scan_plain(n_heads, [xz, xi, xf, xo],
                       [rz, ri, rf, ro, bz, bi, bf, bo])


@slstm_scan_op.register_fake
def _(xz, xi, xf, xo, rz, ri, rf, ro, bz, bi, bf, bo, n_heads):
    B, S, d = xz.shape
    state = [xz.new_empty((B, d), dtype=torch.float32) for _ in range(4)]
    return (xz.new_empty((B, S, d), dtype=torch.float32), *state)


_Grads12 = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@torch.library.custom_op("repro_torch::slstm_scan_backward",
                         mutates_args=())
def slstm_scan_backward(xz: torch.Tensor, xi: torch.Tensor,
                        xf: torch.Tensor, xo: torch.Tensor, rz: torch.Tensor,
                        ri: torch.Tensor, rf: torch.Tensor, ro: torch.Tensor,
                        bz: torch.Tensor, bi: torch.Tensor, bf: torch.Tensor,
                        bo: torch.Tensor, g_h: torch.Tensor,
                        g_c: torch.Tensor, g_n: torch.Tensor,
                        g_last: torch.Tensor, g_m: torch.Tensor,
                        n_heads: int) -> _Grads12:
    """The recurrence's backward: the loop recomputed under autograd and
    differentiated against the outputs' gradients → the 12 inputs'."""
    return _slstm_grads(xz, xi, xf, xo, rz, ri, rf, ro, bz, bi, bf, bo, g_h,
                        g_c, g_n, g_last, g_m, n_heads)


def _slstm_grads(*args) -> tuple:
    from ..kernels.ops import _recompute_grads
    *tensors, n_heads = args

    def plain(*t):
        return _scan_plain(n_heads, list(t[:4]), list(t[4:]))
    return _recompute_grads(plain, tuple(tensors[:12]), tuple(tensors[12:]))


@slstm_scan_backward.register_fake
def _(*args):
    from ..kernels.ops import _fake_recompute
    _fake_recompute(_slstm_grads, args)
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in args[:12])


def _scan_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:12])
    ctx.n_heads = inputs[12]


def _scan_grad(ctx, *grads):
    return (*slstm_scan_backward(*ctx.saved_tensors, *grads, ctx.n_heads),
            None)


slstm_scan_op.register_autograd(_scan_grad, setup_context=_scan_setup)


def slstm_scan_flops(B: int, S: int, d: int, n_heads: int) -> int:
    """The recurrence's matmul FLOPs: four per-head ``[hd] × [hd, hd]``
    products a step, ``8 · B · d · hd · S``."""
    return 8 * B * d * (d // n_heads) * S


@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def _(xz_shape, *args, n_heads=None, **kwargs) -> int:
    B, S, d = xz_shape
    return slstm_scan_flops(B, S, d, args[-1] if n_heads is None else n_heads)


@register_flop_formula(torch.ops.repro_torch.slstm_scan_backward)
def _(xz_shape, *args, **kwargs) -> int:
    # the recompute: the forward's products and their two gradients
    B, S, d = xz_shape
    return 3 * slstm_scan_flops(B, S, d, args[-1])


def slstm_forward(p: SLSTM, cfg: ArchConfig, x, return_cache: bool = False):
    """x: [B,S,d] → y [B,S,d] (+ the final :class:`SLSTMCache`): the true
    nonlinear recurrence, one step per token.  Under a dispatch mode or on
    DTensors (the dry run) the recurrence is one custom op
    (``repro_torch::slstm_scan``: the same loop, a fake implementation, a
    FLOP formula, a batch-split sharding rule and a recompute backward),
    which a fake run sees as one operation instead of ~100 a token."""
    xw = _input_projections(p, x)                # 4 × [B,S,d]
    weights = [getattr(p, n) for n in _RB]
    if _traced(*xw):
        h, *state = slstm_scan_op(*xw, *weights, cfg.n_heads)
    else:
        h, *state = _scan_plain(cfg.n_heads, xw, weights)
    y = h.to(x.dtype) @ p.out
    if return_cache:
        return y, SLSTMCache(*state)
    return y


@functools.lru_cache(maxsize=1)
def register_sharding_rules() -> None:
    """The sLSTM scan's DTensor sharding: the batch over any mesh dim
    (the weights whole, their gradients partial sums), or all
    replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    r, s0 = Replicate(), Shard(0)

    @register_sharding(torch.ops.repro_torch.slstm_scan.default)
    def _(*args):
        return [([r] * 5, [r] * 12 + [None]),
                ([s0] * 5, [s0] * 4 + [r] * 8 + [None])]

    @register_sharding(torch.ops.repro_torch.slstm_scan_backward.default)
    def _(*args):
        return [([r] * 12, [r] * 17 + [None]),
                ([s0] * 4 + [Partial()] * 8,
                 [s0] * 4 + [r] * 8 + [s0] * 5 + [None])]


def slstm_decode(p: SLSTM, cfg: ArchConfig, x, cache: SLSTMCache):
    """One-token step.  x: [B,1,d] → (y [B,1,d], new cache)."""
    cache = _slstm_step(p, cfg, [w[:, 0] for w in _input_projections(p, x)],
                        cache)
    return cache.h[:, None].to(x.dtype) @ p.out, cache
