"""Dispatch for the port's kernels: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to its plain version in :mod:`.ref`.  Nothing else —
no fallback from one to the other.

:func:`flash_attention` launches K2 (:mod:`.flash_attention`) and
:func:`selective_scan` K3 (:mod:`.selective_scan`).  Each is also a
``torch.library.custom_op`` (``repro_torch::flash_attention``,
``repro_torch::selective_scan``) with
* a fake implementation (the outputs' shapes only), so a ``FakeTensorMode``
  run allocates what the kernel allocates and never the plain version's
  ``[B, KV, G, S, S]`` scores;
* a FLOP formula for ``FlopCounterMode`` (K2's matmuls over the kept
  pairs; K3's elementwise work counts 0, as FlopCounterMode counts it in
  any op);
* a DTensor sharding rule (:func:`register_sharding_rules`: batch over any
  mesh dim, K2's heads and K3's channels over one);
* an autograd rule whose backward is a second custom op that recomputes the
  plain version under autograd: the JAX package has no backward kernel
  either (no ``custom_vjp`` under ``repro/kernels``).  The recompute costs
  one plain forward and its backward per call: K3's plain scan is one step
  per token.  A memory tracker that listens (:data:`BODY_TRACKER`) sees the
  recompute's own temporaries, on real tensors and, through the backward
  op's fake implementation, on fake ones.
Under autograd, under a dispatch mode and for a tensor subclass (a DTensor,
a fake tensor) the dispatchers take the custom op.  A plain CUDA tensor
with no gradient wanted calls the kernel's ctypes launch straight, and a
plain CPU tensor the plain version (under autograd, autograd differentiates
the plain version itself).  The op's own body is the same choice: the
kernel on a CUDA tensor, the plain version on a CPU one.  The three modes
of ``repro.kernels.ops`` for eq. (3) all launch the one K1 kernel
(:func:`.fl_aggregate.fl_aggregate_cuda`) with folded scalars:

* :func:`fl_aggregate` — dense rows = K, a {0, 1} mask, ``inv_k = 1/R``
  (also ``repro_torch::fl_aggregate`` under a dispatch mode or for a tensor
  subclass, with a fake implementation: a dry run sees its output only);
* :func:`fl_aggregate_subset` — a padded participant bucket, validity/K
  folded into the weights, ``inv_k = 1``;
* :func:`fl_aggregate_guarded` — fully folded weights, ``inv_k = 1``, with
  non-finite delta elements zeroed inside the reduction.

:func:`mlp_local_sgd` runs L local SGD steps of an MLP's client rows
(:mod:`.mlp_sgd`, a kernel with no Pallas counterpart).
"""
from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from . import ref
from .fl_aggregate import fl_aggregate_cuda
from .flash_attention import flash_attention_cuda
from .mlp_sgd import mlp_local_sgd_cuda
from .selective_scan import selective_scan_cuda


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def fl_aggregate(global_p, deltas, mask):
    """Eq. (3): ``global + (1/R) Σ_r mask_r · δ_r`` for ``deltas: [R, M]``."""
    if _traced(global_p, deltas, mask):
        return fl_aggregate_op(global_p, deltas, mask)
    return _fl_aggregate(global_p, deltas, mask)


def _fl_aggregate(global_p, deltas, mask):
    if not _on_card(global_p):
        return ref.fl_aggregate_ref(global_p, deltas, mask)
    R = deltas.shape[0]
    if R == 0:
        raise ValueError("fl_aggregate needs at least one delta row")
    return fl_aggregate_cuda(global_p, deltas, mask, 1.0 / R)


@torch.library.custom_op("repro_torch::fl_aggregate", mutates_args=())
def fl_aggregate_op(global_p: torch.Tensor, deltas: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """K1's plain mode on a CUDA tensor, ``ref.fl_aggregate_ref`` on a CPU
    one."""
    return _fl_aggregate(global_p, deltas, mask)


@fl_aggregate_op.register_fake
def _(global_p, deltas, mask):
    return torch.empty_like(global_p, memory_format=torch.contiguous_format)


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


def _traced(*tensors) -> bool:
    """True under a dispatch mode (``FakeTensorMode``,
    ``FlopCounterMode``, ...) or for a tensor subclass (a DTensor, a fake
    tensor): the custom op runs then, so the mode sees one operation."""
    return _get_current_dispatch_mode() is not None or any(
        type(t) not in (torch.Tensor, nn.Parameter) for t in tensors)


#: the memory tracker that listens to the recompute backwards' bodies
#: (``launch.dryrun.MemoryTracker`` sets it while a program runs): a
#: dispatch mode sees an op, never the operations of its body, so the body
#: reports them through ``BODY_TRACKER[0].body()``
BODY_TRACKER = [None]


# ---------------------------------------------------------------------------
# K2 and K3 as custom ops
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: Optional[int]) -> torch.Tensor:
    """K2 on a CUDA tensor, ``ref.flash_attention_ref`` on a CPU one."""
    if _on_card(q):
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


@flash_attention_op.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@torch.library.custom_op("repro_torch::flash_attention_backward",
                         mutates_args=())
def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, grad_out: torch.Tensor,
                             causal: bool, window: Optional[int]
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """K2's backward: ``ref.flash_attention_ref`` recomputed under autograd
    and differentiated against ``grad_out`` → ``(dq, dk, dv)``."""
    return _flash_attention_grads(q, k, v, grad_out, causal, window)


def _flash_attention_grads(q, k, v, grad_out, causal, window) -> tuple:
    def plain(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _recompute_grads(plain, (q, k, v), (grad_out,))


@flash_attention_backward.register_fake
def _(q, k, v, grad_out, causal, window):
    _fake_recompute(_flash_attention_grads, (q, k, v, grad_out, causal,
                                             window))
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in (q, k, v))


def _fa_setup(ctx, inputs, output):
    q, k, v, causal, window = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal, ctx.window = causal, window


def _fa_grad(ctx, grad_out):
    q, k, v = ctx.saved_tensors
    return (*flash_attention_backward(q, k, v, grad_out, ctx.causal,
                                      ctx.window), None, None)


flash_attention_op.register_autograd(_fa_grad, setup_context=_fa_setup)


@torch.library.custom_op("repro_torch::selective_scan", mutates_args=())
def selective_scan_op(xc: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                      Cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 on a CUDA tensor, ``ref.selective_scan_ref`` on a CPU one."""
    if _on_card(xc):
        return selective_scan_cuda(xc, dt, Bm, Cm, A, D)
    return ref.selective_scan_ref(xc, dt, Bm, Cm, A, D)


@selective_scan_op.register_fake
def _(xc, dt, Bm, Cm, A, D):
    B, S, d = xc.shape
    return (xc.new_empty((B, S, d), dtype=torch.float32),
            xc.new_empty((B, d, A.shape[1]), dtype=torch.float32))


@torch.library.custom_op("repro_torch::selective_scan_backward",
                         mutates_args=())
def selective_scan_backward(xc: torch.Tensor, dt: torch.Tensor,
                            Bm: torch.Tensor, Cm: torch.Tensor,
                            A: torch.Tensor, D: torch.Tensor,
                            grad_y: torch.Tensor, grad_h: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """K3's backward: ``ref.selective_scan_ref`` recomputed under autograd
    and differentiated against ``(grad_y, grad_h)``."""
    return _selective_scan_grads(xc, dt, Bm, Cm, A, D, grad_y, grad_h)


def _selective_scan_grads(xc, dt, Bm, Cm, A, D, grad_y, grad_h) -> tuple:
    return _recompute_grads(ref.selective_scan_ref, (xc, dt, Bm, Cm, A, D),
                            (grad_y, grad_h))


@selective_scan_backward.register_fake
def _(xc, dt, Bm, Cm, A, D, grad_y, grad_h):
    _fake_recompute(_selective_scan_grads, (xc, dt, Bm, Cm, A, D, grad_y,
                                            grad_h))
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in (xc, dt, Bm, Cm, A, D))


def _ss_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _ss_grad(ctx, grad_y, grad_h):
    return selective_scan_backward(*ctx.saved_tensors, grad_y, grad_h)


selective_scan_op.register_autograd(_ss_grad, setup_context=_ss_setup)


#: the recompute's peak for each set of fake inputs already run: the
#: plain scan's recompute on fake tensors takes minutes at S 4,096
_RECOMPUTE_PEAKS: dict = {}


def _fake_recompute(grads, args) -> None:
    """A backward op's fake implementation: where a memory tracker listens,
    the recompute runs on the fake inputs so that it sees the body's
    temporaries (the plain forward's saved scores or scan states and their
    gradients); the fake outputs are made by the caller.  Each distinct
    set of inputs runs once in a process: its peak is kept."""
    tracker = BODY_TRACKER[0]
    if tracker is None:
        return
    key = (grads, tuple((tuple(a.shape), a.dtype, tuple(a.stride()),
                         a.device.type)
                        if isinstance(a, torch.Tensor) else a for a in args))
    if key in _RECOMPUTE_PEAKS:
        tracker.transient(_RECOMPUTE_PEAKS[key])
        return
    with tracker.body() as nested:
        grads(*args)
    _RECOMPUTE_PEAKS[key] = nested.peak


def _recompute_grads(plain, inputs, grad_outputs) -> tuple:
    """The gradients of ``plain(*inputs)`` against ``grad_outputs`` with
    respect to every input: the plain version recomputed under autograd.
    An op's body runs below the autograd dispatch keys, so they are put
    back for the recompute (a dispatch mode above, such as
    ``FlopCounterMode``, stays out: it counts the op by its formula; a
    listening memory tracker sees it through :data:`BODY_TRACKER`)."""
    tracker = BODY_TRACKER[0]
    with (tracker.body() if tracker is not None and not tracker.inside
          else contextlib.nullcontext()):
        return _recompute(plain, inputs, grad_outputs)


def _recompute(plain, inputs, grad_outputs) -> tuple:
    exclude = torch._C._dispatch_tls_local_exclude_set().remove(
        torch._C.DispatchKey.AutogradFunctionality).remove(
        torch._C.DispatchKey.ADInplaceOrView)
    with torch._C._ForceDispatchKeyGuard(
            torch._C._dispatch_tls_local_include_set(), exclude), \
            torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        outputs = plain(*leaves)
        if isinstance(outputs, torch.Tensor):
            outputs = (outputs,)
        # contiguous, as the fake implementations give them: a DTensor
        # views its local gradients in the backward of a reshape
        return tuple(g.contiguous() for g in
                     torch.autograd.grad(outputs, leaves, grad_outputs))


# ---------------------------------------------------------------------------
# FLOPs, as torch.utils.flop_counter.FlopCounterMode counts them
# ---------------------------------------------------------------------------

def attended_pairs(S: int, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs that the mask keeps over a sequence of S:
    key j is kept for query i where ``j <= i`` (causal) and ``j > i −
    window`` (window)."""
    if window is None or window >= S:
        return S * (S + 1) // 2 if causal else S * S
    if causal:
        return window * (window + 1) // 2 + (S - window) * window
    return S * S - (S - window) * (S - window + 1) // 2


def flash_attention_flops(q_shape, causal: bool,
                          window: Optional[int]) -> int:
    """K2's own matmul FLOPs: Q·Kᵀ and P·V over the kept pairs, 2 FLOPs a
    multiply-add, ``4 · B · H · hd · pairs``."""
    B, S, H, hd = q_shape
    return 4 * B * H * hd * attended_pairs(S, causal, window)


def flash_attention_backward_flops(q_shape) -> int:
    """The recompute backward's matmul FLOPs: the plain version's two
    matmuls over every (query, key) pair and their four gradients,
    ``12 · B · H · hd · S²``."""
    B, S, H, hd = q_shape
    return 12 * B * H * hd * S * S


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, window, *args, **kwargs) -> int:
    return flash_attention_flops(q_shape, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _(q_shape, *args, **kwargs) -> int:
    return flash_attention_backward_flops(q_shape)


@register_flop_formula([torch.ops.repro_torch.selective_scan,
                        torch.ops.repro_torch.selective_scan_backward])
def _(*args, **kwargs) -> int:
    # elementwise work (exp, multiply-adds over the state): FlopCounterMode
    # counts 0 for it in any op, so the scan counts 0 too
    return 0


# ---------------------------------------------------------------------------
# DTensor sharding rules
# ---------------------------------------------------------------------------

def _mesh_sizes(spec) -> tuple:
    return tuple(spec.mesh.shape)


def _fa_strategies(q, k, n_out: int, n_in_tensors: int, n_rest: int):
    """Batch over any mesh dim; heads over one when both H and KV split
    into whole heads on every mesh dim; else replicated."""
    def entry(p):
        return ([p] * n_out, [p] * n_in_tensors + [None] * n_rest)
    out = [entry(Replicate()), entry(Shard(0))]
    H, KV = q.shape[2], k.shape[2]
    if all(H % n == 0 and KV % n == 0 for n in _mesh_sizes(q)):
        out.append(entry(Shard(2)))
    return out


@lru_cache(maxsize=1)
def register_sharding_rules() -> None:
    """Give DTensor the sharding of K2, K3 and their backwards (called
    once, by the launch layer, before a program runs on DTensors)."""
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _(q, k, v, causal, window):
        return _fa_strategies(q, k, 1, 3, 2)

    @register_sharding(torch.ops.repro_torch.flash_attention_backward.default)
    def _(q, k, v, grad_out, causal, window):
        return _fa_strategies(q, k, 3, 4, 2)

    @register_sharding(torch.ops.repro_torch.selective_scan.default)
    def _(xc, dt, Bm, Cm, A, D):
        r, s0 = Replicate(), Shard(0)
        return [([r, r], [r] * 6),
                ([s0, s0], [s0, s0, s0, s0, r, r]),
                # channels: y over d, the state over d, B and C whole
                ([Shard(2), Shard(1)], [Shard(2), Shard(2), r, r, s0, s0])]

    @register_sharding(torch.ops.repro_torch.selective_scan_backward.default)
    def _(xc, dt, Bm, Cm, A, D, grad_y, grad_h):
        r, s0, s2, p = Replicate(), Shard(0), Shard(2), Partial()
        return [([r] * 6, [r] * 8),
                # batch: A's and D's gradients are partial sums over it
                ([s0, s0, s0, s0, p, p], [s0, s0, s0, s0, r, r, s0, s0]),
                # channels: B's and C's gradients are partial sums
                ([s2, s2, p, p, s0, s0], [s2, s2, r, r, s0, s0, s2,
                                          Shard(1)])]


def flash_attention(q, k, v, causal: bool = True, window: int | None = None):
    """Causal (optionally sliding-window) GQA attention: ``q [B,S,H,hd]``,
    ``k``/``v [B,S,KV,hd]`` → ``[B,S,H,hd]`` in ``q.dtype``."""
    if _traced(q, k, v) or _on_card(q) and _wants_grad(q, k, v):
        return flash_attention_op(q, k, v, causal, window)
    if not _on_card(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


def selective_scan(xc, dt, Bm, Cm, A, D):
    """Mamba S6 scan from a zero state: ``xc``, ``dt [B,S,d]``, ``Bm``,
    ``Cm [B,S,N]``, ``A [d,N]``, ``D [d]`` → ``(y [B,S,d], h_last [B,d,N])``
    in float32."""
    args = (xc, dt, Bm, Cm, A, D)
    if _traced(*args) or _on_card(xc) and _wants_grad(*args):
        return selective_scan_op(*args)
    if not _on_card(xc):
        return ref.selective_scan_ref(*args)
    return selective_scan_cuda(*args)


def mlp_local_sgd(rows, xb, yb, lr: float, layout):
    """L local SGD steps of one-hidden-layer MLP client rows ``[R, W]`` on
    ``xb [R, L, B, ...]``, ``yb [R, L, B]``: the kernel on a CUDA tensor,
    the plain version on a CPU one."""
    if _on_card(rows):
        return mlp_local_sgd_cuda(rows, xb, yb, lr, layout)
    return ref.mlp_local_sgd_ref(rows, xb, yb, lr, layout)
