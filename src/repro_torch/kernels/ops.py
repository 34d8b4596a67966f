"""Dispatch for the port's kernels: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to its plain version in :mod:`.ref`.  Nothing else —
no fallback from one to the other.

:func:`flash_attention` launches K2 (:mod:`.flash_attention`) and
:func:`selective_scan` K3 (:mod:`.selective_scan`).  When a gradient is
wanted of a CUDA tensor, each runs through an autograd ``Function`` whose
forward is the kernel and whose backward recomputes the function through
its plain version under autograd (:class:`_FlashAttention`,
:class:`_SelectiveScan`): the JAX package has no backward kernel either
(no ``custom_vjp`` under ``repro/kernels``).  The recompute costs one
plain forward and its backward per call: K3's plain scan is one step per
token.  On a CPU tensor autograd differentiates the plain version itself.
The three
modes of ``repro.kernels.ops`` for eq. (3) all launch the one K1 kernel
(:func:`.fl_aggregate.fl_aggregate_cuda`) with folded scalars:

* :func:`fl_aggregate` — dense rows = K, a {0, 1} mask, ``inv_k = 1/R``;
* :func:`fl_aggregate_subset` — a padded participant bucket, validity/K
  folded into the weights, ``inv_k = 1``;
* :func:`fl_aggregate_guarded` — fully folded weights, ``inv_k = 1``, with
  non-finite delta elements zeroed inside the reduction.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ref
from .fl_aggregate import fl_aggregate_cuda
from .flash_attention import flash_attention_cuda
from .selective_scan import selective_scan_cuda


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def fl_aggregate(global_p, deltas, mask):
    """Eq. (3): ``global + (1/R) Σ_r mask_r · δ_r`` for ``deltas: [R, M]``."""
    if not _on_card(global_p):
        return ref.fl_aggregate_ref(global_p, deltas, mask)
    R = deltas.shape[0]
    if R == 0:
        raise ValueError("fl_aggregate needs at least one delta row")
    return fl_aggregate_cuda(global_p, deltas, mask, 1.0 / R)


def fl_aggregate_subset(global_p, deltas, valid, num_clients):
    """Participant-subset eq. (3): ``deltas: [P, M]`` and validity lanes,
    averaged over the population ``num_clients`` (a number or a tensor)."""
    if not _on_card(global_p):
        return ref.fl_aggregate_subset_ref(global_p, deltas, valid,
                                           num_clients)
    v = valid.to(torch.float32)
    if isinstance(num_clients, torch.Tensor):
        w = v / num_clients.to(device=v.device, dtype=torch.float32)
    else:
        # the float32 quotient 1/K as a Python float: for validity lanes
        # of 0 and 1 the weights are v / K's bits, with no host-to-device
        # copy of K (a pageable copy waits for the stream)
        w = v * float(np.float32(1.0) / np.float32(num_clients))
    return fl_aggregate_cuda(global_p, deltas, w, 1.0, subset=True)


def fl_aggregate_guarded(global_p, deltas, weights):
    """Defensively-weighted eq. (3): ``global + Σ_r w_r · sanitize(δ_r)``,
    with non-finite delta elements zeroed inside the reduction."""
    if not _on_card(global_p):
        return ref.fl_aggregate_guarded_ref(global_p, deltas, weights)
    return fl_aggregate_cuda(global_p, deltas, weights, 1.0, guard=True)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _recompute_grads(ctx, plain, grad_outputs):
    """The backward of a kernel's ``Function``: the plain version of the
    saved inputs under autograd, differentiated against ``grad_outputs``;
    ``None`` for each input that needs no gradient."""
    saved = ctx.saved_tensors
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        outputs = plain(*inputs)
        if isinstance(outputs, torch.Tensor):
            outputs = (outputs,)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(outputs, wanted, grad_outputs,
                                         allow_unused=True))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)


class _FlashAttention(torch.autograd.Function):
    """K2 forward; the backward recomputes ``ref.flash_attention_ref``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention_cuda(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad_out):
        def plain(q, k, v):
            return ref.flash_attention_ref(q, k, v, causal=ctx.causal,
                                           window=ctx.window)
        return (*_recompute_grads(ctx, plain, (grad_out,)), None, None)


class _SelectiveScan(torch.autograd.Function):
    """K3 forward; the backward recomputes ``ref.selective_scan_ref``."""

    @staticmethod
    def forward(ctx, xc, dt, Bm, Cm, A, D):
        ctx.save_for_backward(xc, dt, Bm, Cm, A, D)
        return selective_scan_cuda(xc, dt, Bm, Cm, A, D)

    @staticmethod
    def backward(ctx, grad_y, grad_h):
        return _recompute_grads(ctx, ref.selective_scan_ref,
                                (grad_y, grad_h))


def flash_attention(q, k, v, causal: bool = True, window: int | None = None):
    """Causal (optionally sliding-window) GQA attention: ``q [B,S,H,hd]``,
    ``k``/``v [B,S,KV,hd]`` → ``[B,S,H,hd]`` in ``q.dtype``."""
    if not _on_card(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


def selective_scan(xc, dt, Bm, Cm, A, D):
    """Mamba S6 scan from a zero state: ``xc``, ``dt [B,S,d]``, ``Bm``,
    ``Cm [B,S,N]``, ``A [d,N]``, ``D [d]`` → ``(y [B,S,d], h_last [B,d,N])``
    in float32."""
    if not _on_card(xc):
        return ref.selective_scan_ref(xc, dt, Bm, Cm, A, D)
    if _wants_grad(xc, dt, Bm, Cm, A, D):
        return _SelectiveScan.apply(xc, dt, Bm, Cm, A, D)
    return selective_scan_cuda(xc, dt, Bm, Cm, A, D)
