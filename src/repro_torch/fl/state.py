"""FL state (counterpart of ``repro.fl.state``, its dense eq.-3 path).

``FLState`` holds the server's global model plus the stacked per-client
states: each client's local model ``x_k`` and its anchor ``y_k``, the last
global model it received (paper eq. 2).  Unlike the JAX pytree, every model
is one flat float32 row — the global model ``[W]``, the clients and anchors
``[K, W]`` — and :class:`ParamLayout` gives per-layer views into a row.  So
eq. 2 is one subtraction and eq. 3 one K1 kernel launch per round, not one
per layer.  ``W`` is the parameter count rounded up to a multiple of 4:
every row then starts 16-byte aligned, which the kernel's vector path needs
(the 159,010-parameter MLP gets 2 zero columns that stay zero).

The guarded, subset and scheme aggregators are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..kernels import ops

_ROW_ALIGN = 4   # float32 elements per 16 bytes


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """Where each leaf of a list-of-dicts param tree lives in a flat row.

    Leaves are ordered as JAX flattens the same tree (layers in order, each
    layer's keys sorted).
    """

    entries: tuple   # ((layer, name, shape, offset), ...)
    size: int        # parameter count
    width: int       # row length: size rounded up to a multiple of 4

    @classmethod
    def of(cls, params) -> "ParamLayout":
        entries, off = [], 0
        for i, layer in enumerate(params):
            for name in sorted(layer):
                shape = tuple(layer[name].shape)
                entries.append((i, name, shape, off))
                off += math.prod(shape)
        width = -(-off // _ROW_ALIGN) * _ROW_ALIGN
        return cls(tuple(entries), off, width)

    def flatten(self, params, device=None) -> torch.Tensor:
        """One ``[W]`` float32 row holding ``params`` (zero padded)."""
        device = device or params[0][self.entries[0][1]].device
        flat = torch.zeros(self.width, dtype=torch.float32, device=device)
        for i, name, shape, off in self.entries:
            flat[off:off + math.prod(shape)] = \
                params[i][name].reshape(-1).to(device)
        return flat

    def unflatten(self, flat: torch.Tensor):
        """Per-layer views into ``flat: [..., W]`` (leading axes kept)."""
        lead = flat.shape[:-1]
        layers = [{} for _ in range(1 + max(e[0] for e in self.entries))]
        for i, name, shape, off in self.entries:
            n = math.prod(shape)
            layers[i][name] = flat[..., off:off + n].view(*lead, *shape)
        return layers


class FLState(NamedTuple):
    global_params: torch.Tensor  # [W], the server's x_t
    client_params: torch.Tensor  # [K, W], x_{k,t}
    anchor_params: torch.Tensor  # [K, W], y_{k,t}
    round: torch.Tensor          # int32 scalar
    last_tx: torch.Tensor        # [K] int32, round of last transmission
    layout: ParamLayout


def init_fl_state(params, num_clients: int, device=None) -> FLState:
    layout = ParamLayout.of(params)
    g = layout.flatten(params, device)
    stacked = g.expand(num_clients, layout.width).clone()
    return FLState(global_params=g, client_params=stacked,
                   anchor_params=stacked.clone(),
                   round=torch.zeros((), dtype=torch.int32, device=g.device),
                   last_tx=torch.zeros(num_clients, dtype=torch.int32,
                                       device=g.device),
                   layout=layout)


def pseudo_gradients(state: FLState) -> torch.Tensor:
    """Eq. (2): δ_k = x_k − y_k, ``[K, W]``."""
    return state.client_params - state.anchor_params


def masked_aggregate(global_params: torch.Tensor, deltas: torch.Tensor,
                     mask: torch.Tensor, num_clients: int) -> torch.Tensor:
    """Eq. (3): x ← x + (1/K) Σ_{k∈C_t} δ_k, in one K1 launch on the card
    (its plain version on the CPU)."""
    if deltas.shape[0] != num_clients:
        raise ValueError(f"dense aggregation takes one delta row per client: "
                         f"{deltas.shape[0]} rows for K={num_clients}")
    return ops.fl_aggregate(global_params, deltas, mask)


def broadcast_to_participants(state: FLState, new_global: torch.Tensor,
                              mask: torch.Tensor) -> FLState:
    """Protocol Step 5: participants receive x_t (both x_k and y_k reset)."""
    m = mask.bool()
    client = torch.where(m[:, None], new_global[None], state.client_params)
    anchor = torch.where(m[:, None], new_global[None], state.anchor_params)
    last_tx = torch.where(m, state.round, state.last_tx)
    return state._replace(global_params=new_global, client_params=client,
                          anchor_params=anchor, round=state.round + 1,
                          last_tx=last_tx)
