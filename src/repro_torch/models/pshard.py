"""Activation-sharding hints.  Counterpart of ``repro.models.pshard``.

JAX's hints are ``with_sharding_constraint`` calls, which constrain a value
and its cotangent; the port's are DTensor redistributions that do both
(:func:`constrain`).  :func:`shard_dim` on a DTensor whose mesh has
``axis`` redistributes dimension ``dim`` to ``Shard`` over that mesh
dimension and keeps the placements of the other mesh dimensions (the
nearest thing to JAX's ``UNCONSTRAINED``).  On a plain tensor, a mesh
without ``axis``, or a dimension that does not divide, every helper here
returns ``x`` itself: on one card they change no value and dispatch no
operation.

The rest are the port's own, for the places where GSPMD reshards
silently and DTensor needs to be told:

* :func:`whole_heads`: DTensor cannot view a dimension as ``[heads,
  head_dim]`` when its shards cut a head, so the dimension is gathered
  first, an all-gather that the dry run's collective counts record;
* :func:`gqa_heads`: KV heads repeated for their query heads where the
  query heads are split and the KV heads cannot be;
* :func:`replicate_over`, :func:`settle`, :func:`gather_dim`: a residual
  replicated over "model", pending partial sums reduced, a split gathered;
* :func:`write_slot`: a KV cache's ring write as an elementwise select.
"""
from __future__ import annotations

from collections import Counter

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

#: the redistributions the hints made that GSPMD would make silently
#: (``whole_heads`` gathers, ``gqa_heads`` expansions); the dry run
#: resets and records them
REDISTRIBUTIONS: Counter = Counter()


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _mesh_dim(x, axis: str) -> int | None:
    names = x.device_mesh.mesh_dim_names or ()
    return names.index(axis) if axis in names else None


def _splits(p, d: int) -> bool:
    """``p`` splits dim ``d`` (a ``Shard``, or the strided shard that a
    flattened split dim becomes)."""
    return p.is_shard() and p.dim == d


class _Constrain(torch.autograd.Function):
    """Redistribute to ``placements``; the gradient is redistributed to
    them too (a pending sum reduced), as JAX's sharding constraint
    constrains the cotangent."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements).view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if not is_dtensor(grad):
            return grad, None
        # the gradient of a pending sum is whole on every rank
        return grad.redistribute(grad.device_mesh, [
            Replicate() if p.is_partial() else p for p in ctx.placements]), \
            None


def constrain(x, placements):
    """``x`` (a DTensor) on ``placements``, its gradient too; anything
    else as it is."""
    if not is_dtensor(x):
        return x
    placements = tuple(placements)
    if tuple(x.placements) == placements and not (
            torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Constrain.apply(x, placements)


def shard_dim(x, dim: int, axis: str = "model"):
    """Shard dimension ``dim`` of ``x`` over mesh axis ``axis`` (if ``x``
    is a DTensor on a mesh with that axis and the dim divides)."""
    if not is_dtensor(x) or x.ndim == 0:
        return x
    m = _mesh_dim(x, axis)
    if m is None:
        return x
    size = x.device_mesh.shape[m]
    d = dim % x.ndim
    if size == 1 or x.shape[d] % size != 0 or x.shape[d] < size:
        return x
    placements = list(x.placements)
    if any(_splits(p, d) for i, p in enumerate(placements) if i != m):
        return x        # the dim is already split over another mesh dim
    placements[m] = Shard(d)
    return constrain(x, placements)


def shard_last(x, axis: str = "model"):
    return shard_dim(x, -1, axis)


def replicate_over(x, axis: str = "model"):
    """``x`` replicated over mesh axis ``axis``: a split there is gathered,
    a pending sum reduced."""
    if not is_dtensor(x):
        return x
    m = _mesh_dim(x, axis)
    if m is None:
        return x
    placements = list(x.placements)
    placements[m] = Replicate()
    return constrain(x, placements)


def settle(x):
    """A DTensor with pending partial sums reduced at once (on every mesh
    dim): DTensor keeps a vocab-parallel embedding's or gather's mask for
    one reduction only, so a value read twice must be reduced first.  Its
    gradient is held to the same placements (a layer's output then takes
    no sequence split from the residual's gradient into its own
    backward)."""
    if not is_dtensor(x):
        return x
    return constrain(x, [Replicate() if p.is_partial() else p
                         for p in x.placements])


def gather_dim(x, dim: int, axis: str = "model"):
    """Undo :func:`shard_dim`: dimension ``dim`` of a DTensor split over
    mesh axis ``axis`` is gathered."""
    if not is_dtensor(x) or x.ndim == 0:
        return x
    m = _mesh_dim(x, axis)
    if m is None or not _splits(x.placements[m], dim % x.ndim):
        return x
    return replicate_over(x, axis)


def whole_heads(x, n_heads: int, dim: int = -1):
    """``x`` whose dim ``dim`` holds ``n_heads`` heads (``[..., n_heads ·
    hd]`` by default) with each shard of that dim holding whole heads: a
    DTensor whose dim is split so that a shard would cut a head is
    gathered over those mesh dims.  Its gradient is held to the same
    placements, so the backward of a view to or from ``[heads, hd]``
    never cuts a head either."""
    if not is_dtensor(x):
        return x
    d = dim % x.ndim
    split = 1
    for i, p in enumerate(x.placements):
        if _splits(p, d):
            split *= x.device_mesh.shape[i]
    if split == 1 or n_heads % split == 0:
        return constrain(x, x.placements)
    REDISTRIBUTIONS["whole_heads"] += 1
    return constrain(x, [Replicate() if _splits(p, d) else p
                         for p in x.placements])


def gqa_heads(q, k, v):
    """``k``, ``v [B,S,KV,hd]`` for attention with ``q [B,S,H,hd]``: when
    ``q`` is a DTensor whose heads are split over a mesh dim that cannot
    split the KV heads whole, each KV head is repeated for its H/KV query
    heads and placed as ``q`` is (a local slice of a replicated tensor:
    no collective), so K2 runs on whole heads; else unchanged."""
    if not is_dtensor(q):
        return k, v
    H, KV = q.shape[2], k.shape[2]
    if H == KV or not any(_splits(p, 2) for p in q.placements) or all(
            KV % n == 0 for n in q.device_mesh.shape):
        return k, v
    B, S, _, hd = k.shape

    def expand(t):
        whole = [Replicate() if _splits(p, 2) else p for p in t.placements]
        t = constrain(t, whole)
        # the repeat's gradient sums over the repeats with the heads whole
        t = constrain(t[:, :, :, None].expand(B, S, KV, H // KV, hd)
                      .reshape(B, S, H, hd), whole)
        return constrain(t, [Shard(2) if _splits(qp, 2) else p
                             for qp, p in zip(q.placements, t.placements)])

    REDISTRIBUTIONS["gqa_heads"] += 1
    return expand(k), expand(v)


def write_slot(cache, slot: int, value) -> None:
    """``cache[:, slot] = value`` in place.  On a DTensor whose slot dim is
    split, an elementwise select over the dim instead: the shard that
    holds the slot takes the value, no shard is gathered (GSPMD lowers
    JAX's ``dynamic_update_slice`` so)."""
    if not is_dtensor(cache):
        cache[:, slot] = value
        return
    C = cache.shape[1]
    sel = torch.arange(C, device=cache.device) == slot
    sel = sel.reshape(1, C, *([1] * (cache.ndim - 2)))
    cache.copy_(torch.where(sel, value[:, None], cache))

