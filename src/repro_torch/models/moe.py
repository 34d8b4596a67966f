"""Mixture-of-Experts FFN with grouped capacity dispatch.  Counterpart of
``repro.models.moe``.

Tokens are split into groups of ``group_size`` (one group when the count is
ragged); each group routes its tokens independently into per-expert capacity
slots, ``C = capacity(g)``, filled in slot-priority order (all first choices,
then all second choices, each in token order) and dropped on overflow —
JAX's cumsum assignment.  Where JAX multiplies one-hot ``[G, g, E, C]``
dispatch and combine tensors into einsums, the port scatters each kept token
into its slot and gathers its experts' outputs back: the same slots, the
same products (a one-hot einsum copies exactly), without the ``O(g²)``
tensors.  The combine weights are cast to the model dtype before the
product, as JAX casts ``combine``, and the product is summed in float32 and
rounded once.  On DTensors (the dry run) it takes JAX's one-hot
contractions themselves.  Returns (output, the load-balance aux loss).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import random as jr
from .. import resolve_device
from ..configs.base import ArchConfig, MoEConfig
from .layers import dense_init
from .pshard import is_dtensor, replicate_over, settle, shard_dim

DEFAULT_GROUP = 1024


class MoE(nn.Module):
    """``router [d, E]`` float32 and the experts' SwiGLU weights stacked on
    a leading ``[E]`` axis: ``w1``, ``w3 [E, d, ff]``, ``w2 [E, ff, d]``.
    Allocated uninitialised: :func:`init_moe` or ``convert.load_jax_tree``
    fills them."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        device = resolve_device(device)
        m = cfg.moe
        d, E, ff = cfg.d_model, m.num_experts, m.d_ff_expert

        def param(shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.router = param((d, E), torch.float32)
        self.w1 = param((E, d, ff))
        self.w3 = param((E, d, ff))
        self.w2 = param((E, ff, d))


@torch.no_grad()
def init_moe(p: MoE, key) -> None:
    """Fill ``p`` in place with JAX's ``init_moe`` draws for ``key``: one
    key per weight stack, split again into one key per expert."""
    ks = jr.split(key, 4)
    p.router.copy_(dense_init(ks[0], *p.router.shape, torch.float32,
                              p.router.device))
    for w, k in zip((p.w1, p.w3, p.w2), ks[1:]):
        for e, ke in enumerate(jr.split(k, w.shape[0])):
            w[e].copy_(dense_init(ke, *w.shape[1:], w.dtype, w.device))


def capacity(group_tokens: int, m: MoEConfig) -> int:
    c = int(group_tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(4, (c + 3) // 4 * 4)


def _scatter_gather(p: MoE, xt, topv, topi, kept: list, slots: list,
                    C: int) -> torch.Tensor:
    """The experts over the ``[G, E, C, d]`` slot tensor: each kept token
    scattered into its slot (a dropped one into a spill slot C, cut off
    after), each expert output gathered back → float32 ``[G, g, d]``."""
    G, g, d = xt.shape
    E, k = p.router.shape[1], len(slots)
    gi = torch.arange(G, device=xt.device)[:, None].expand(G, g)
    xe = xt.new_zeros(G, E, C + 1, d)
    for j in range(k):
        spill = torch.where(kept[j], slots[j], C)
        xe = xe.index_put((gi, topi[:, :, j], spill), xt)
    ye = _experts(p, xe[:, :, :C])
    out = torch.zeros(G, g, d, dtype=torch.float32, device=xt.device)
    flat = ye.reshape(G, E * C, d)
    for j in range(k):
        w = (topv[:, :, j] * kept[j]).to(xt.dtype).float()
        idx = topi[:, :, j] * C + slots[j].clamp(max=C - 1)     # [G, g]
        y = torch.gather(flat, 1, idx[..., None].expand(G, g, d))
        out = out + w[..., None] * y.float()
    return out


def _expert_parallel(p: MoE, xt, topv, topi, kept: list, slots: list,
                     C: int) -> torch.Tensor:
    """JAX's formulation, for DTensors (experts split over "model"): the
    one-hot ``[G, g, E, C]`` dispatch and combine tensors, contracted with
    the tokens and the experts' outputs (DTensor shards einsums; a scatter
    into an expert-split tensor it cannot differentiate)."""
    E = p.router.shape[1]
    e_ids = torch.arange(E, device=xt.device)
    c_ids = torch.arange(C, device=xt.device)
    dispatch = combine = None
    for j in range(len(slots)):
        slot = ((topi[:, :, j, None, None] == e_ids[:, None])
                & (slots[j][..., None, None] == c_ids)
                & kept[j][..., None, None]).to(torch.float32)  # [G,g,E,C]
        part = slot * topv[:, :, j, None, None]
        dispatch = slot if dispatch is None else dispatch + slot
        combine = part if combine is None else combine + part
    # the tokens' sums over the dp dims reduced; the combine split over
    # the experts as they are, so its contraction is one reduction
    xe = settle(torch.einsum("gtec,gtd->gecd", dispatch.to(xt.dtype), xt))
    ye = _experts(p, xe)
    # "gtec,gecd->gtd" as one batched product over the flattened (e, c),
    # E outermost and split over "model" in both: DTensor's search over an
    # einsum's strategies on a 3-D mesh takes minutes
    G, g, E, C = combine.shape
    combine = shard_dim(combine.to(xt.dtype).reshape(G, g, E * C), 2)
    ye = shard_dim(ye.reshape(G, E * C, ye.shape[-1]), 1)
    return settle(torch.bmm(combine, ye))


def _experts(p: MoE, xe) -> torch.Tensor:
    """SwiGLU of each expert over its slots ``[G, E, C, d]``.  Expert
    stacks split over "data" as well (masked-dp's FSDP) are gathered over
    it first, FSDP's all-gather before use."""
    w1, w3, w2 = (replicate_over(w, "data") for w in (p.w1, p.w3, p.w2))
    xe = shard_dim(xe, 1)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, w1))
    h = shard_dim(h, 1) * torch.einsum("gecd,edf->gecf", xe, w3)
    return shard_dim(torch.einsum("gecf,efd->gecd", h, w2), 1)


def moe_forward(p: MoE, cfg: ArchConfig, x: torch.Tensor,
                group_size: int = DEFAULT_GROUP):
    """x: [B, S, d] → ([B, S, d], aux loss, a float32 scalar)."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, k = B * S, m.num_experts, m.top_k
    g = min(group_size, T)
    if T % g != 0:
        g = T          # ragged small/test shapes: one group
    G = T // g
    C = capacity(g, m)
    xt = replicate_over(x.reshape(G, g, d))     # tokens whole over model

    gates = torch.softmax(xt.float() @ p.router, dim=-1)         # [G, g, E]
    topv, topi = torch.topk(gates, k, dim=-1)                    # [G, g, k]
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)

    # slot of each (token, choice) in its expert, in slot-priority order
    counts = torch.zeros(G, E, dtype=torch.int64, device=x.device)
    slots, kept = [], []
    for j in range(k):
        oh = F.one_hot(topi[:, :, j], E)                         # [G, g, E]
        pos = torch.cumsum(oh, dim=1) - oh + counts[:, None, :]
        slot = (pos * oh).sum(-1)                                # [G, g]
        slots.append(slot)
        kept.append(slot < C)
        counts = counts + oh.sum(1)

    if is_dtensor(x):
        out = _expert_parallel(p, xt, topv, topi, kept, slots, C)
    else:
        out = _scatter_gather(p, xt, topv, topi, kept, slots, C)

    frac = torch.mean(F.one_hot(topi[..., 0], E).float(), dim=(0, 1))
    mean_gate = torch.mean(gates, dim=(0, 1))
    aux = E * torch.sum(frac * mean_gate)
    return out.to(x.dtype).reshape(B, S, d), aux
