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
rounded once.  Returns (output, the load-balance aux loss).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import random as jr
from .. import resolve_device
from ..configs.base import ArchConfig, MoEConfig
from .layers import dense_init

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
    xt = x.reshape(G, g, d)

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

    # expert compute on the [G, E, C, d] slot tensor (empty slots stay 0)
    gi = torch.arange(G, device=x.device)[:, None].expand(G, g)
    xe = x.new_zeros(G, E, C, d)
    for j in range(k):
        keep = kept[j]
        xe[gi[keep], topi[:, :, j][keep], slots[j][keep]] = xt[keep]
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p.w1)) \
        * torch.einsum("gecd,edf->gecf", xe, p.w3)
    ye = torch.einsum("gecf,efd->gecd", h, p.w2)

    out = torch.zeros(G, g, d, dtype=torch.float32, device=x.device)
    for j in range(k):
        w = (topv[:, :, j] * kept[j]).to(x.dtype).float()
        y = ye[gi, topi[:, :, j], slots[j].clamp(max=C - 1)]     # [G, g, d]
        out = out + w[..., None] * y.float()

    frac = torch.mean(F.one_hot(topi[..., 0], E).float(), dim=(0, 1))
    mean_gate = torch.mean(gates, dim=(0, 1))
    aux = E * torch.sum(frac * mean_gate)
    return out.to(x.dtype).reshape(B, S, d), aux
