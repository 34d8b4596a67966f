"""FL state and aggregation (counterpart of ``repro.fl.state``).

``FLState`` holds the server's global model plus the stacked per-client
states: each client's local model ``x_k`` and its anchor ``y_k``, the last
global model it received (paper eq. 2).  Unlike the JAX pytree, every model
is one flat float32 row — the global model ``[W]``, the clients and anchors
``[K, W]`` — and :class:`ParamLayout` gives per-layer views into a row.  So
eq. 2 is one subtraction and eq. 3 one K1 kernel launch per round, not one
per layer.  ``W`` is the parameter count rounded up to a multiple of 4
(the 159,010-parameter MLP gets 2 zero columns that stay zero).  K1 takes
rows at any alignment; the padding stays so that every row starts 16-byte
aligned, and each row slice K1 copies is then exactly its own 16-byte
chunks, with no neighbouring bytes at either end.

Every aggregator here is one K1 launch on the card (its plain version on
the CPU), in one of K1's three modes (:mod:`repro_torch.kernels.ops`):

* :func:`masked_aggregate` — eq. 3, the plain mode;
* :func:`subset_aggregate` — eq. 3 over a padded participant bucket, the
  subset mode;
* :func:`guarded_aggregate` (active guards), :func:`weighted_aggregate`,
  :func:`scheme_aggregate` — eq. 3 with folded per-row weights, the
  weighted (guarded) mode, which zeroes non-finite delta elements inside
  the reduction.  So a NaN row of weight 0 adds nothing here, on either
  device, where the JAX package's CPU path propagates it (``0·NaN``) and
  its TPU kernel zeroes it; the port follows the kernel.

The guard and scheme weights are a handful of ``[R]`` operations.

Under the dense engine's client-axis placement (:mod:`repro_torch.fl.
placement`) the client and anchor rows are :class:`RowBlocks`, one block
of rows a card.  :func:`finite_rows` and :func:`update_norms` then reduce
each block on its card and join the results on the first; eq. 3 is one K1
launch a block, the partial rows added on the first card in block order
(:func:`masked_aggregate` in K1's subset mode, :func:`weighted_aggregate`
and so the guard and scheme aggregators in its weighted mode); and
:func:`broadcast_to_participants` resets each block on its card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .. import resolve_device
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


class RowBlocks(tuple):
    """A ``[K, ...]`` tensor as contiguous row blocks in row order, each on
    its own device (:mod:`repro_torch.fl.placement`).  Block 0 lies on the
    first device, where the global row and the ``[K]`` ledgers live."""

    @property
    def device(self) -> torch.device:
        return self[0].device

    @property
    def shape(self) -> torch.Size:
        return torch.Size((sum(b.shape[0] for b in self),)
                          + tuple(self[0].shape[1:]))

    def slices(self, v: torch.Tensor) -> list:
        """``v [K, ...]`` cut into the blocks' rows, each slice on its
        block's device."""
        out, start = [], 0
        for b in self:
            out.append(v[start:start + b.shape[0]].to(b.device,
                                                      non_blocking=True))
            start += b.shape[0]
        return out

    def replicas(self, v: torch.Tensor) -> list:
        """``v`` on each block's device, copied once a device."""
        on = {}
        for b in self:
            if b.device not in on:
                on[b.device] = v.to(b.device, non_blocking=True)
        return [on[b.device] for b in self]

    def join(self, fn) -> torch.Tensor:
        """``fn`` of each block on its device (a row-wise function), the
        results joined on the first device in block order."""
        return torch.cat([fn(b).to(self.device, non_blocking=True)
                          for b in self])

    def gather(self) -> torch.Tensor:
        """The whole ``[K, ...]`` tensor on the first device."""
        return self.join(lambda b: b)


class FLState(NamedTuple):
    global_params: torch.Tensor  # [W], the server's x_t
    client_params: torch.Tensor  # [K, W], x_{k,t} (RowBlocks when placed)
    anchor_params: torch.Tensor  # [K, W], y_{k,t} (RowBlocks when placed)
    round: torch.Tensor          # int32 scalar
    last_tx: torch.Tensor        # [K] int32, round of last transmission
    layout: ParamLayout

    def gathered(self) -> "FLState":
        """This state with a placed run's client and anchor rows gathered
        into ``[K, W]`` tensors on the first device; an unplaced state as
        it is."""
        if not isinstance(self.client_params, RowBlocks):
            return self
        return self._replace(client_params=self.client_params.gather(),
                             anchor_params=self.anchor_params.gather())


def replicate(params, k: int):
    """Each leaf of ``params`` (a tensor, or nested lists and dicts of
    them) broadcast to ``[k, *shape]``: a view, as JAX's
    ``broadcast_to``."""
    if isinstance(params, torch.Tensor):
        return params[None].expand(k, *params.shape)
    if isinstance(params, dict):
        return {n: replicate(v, k) for n, v in params.items()}
    return type(params)(replicate(v, k) for v in params)


def init_fl_state(params, num_clients: int, device=None,
                  devices=None) -> FLState:
    """Every client and anchor row the global row.  ``devices`` (d
    devices, the first where ``device`` resolves) splits them into
    :class:`RowBlocks` of K/d rows, each made on its device."""
    layout = ParamLayout.of(params)
    g = layout.flatten(params, device)
    if devices is None:
        stacked = g.expand(num_clients, layout.width).clone()
        client, anchor = stacked, stacked.clone()
    else:
        n = num_clients // len(devices)
        client, anchor = (RowBlocks(
            g.to(dev).expand(n, layout.width).clone() for dev in devices)
            for _ in range(2))
    return FLState(global_params=g, client_params=client,
                   anchor_params=anchor,
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
    if isinstance(deltas, RowBlocks):
        return _block_sums(global_params, deltas, mask, lambda g, d, m:
                          ops.fl_aggregate_subset(g, d, m, num_clients))
    return ops.fl_aggregate(global_params, deltas, mask)


def _block_sums(global_params: torch.Tensor, deltas: RowBlocks,
               weights: torch.Tensor, launch) -> torch.Tensor:
    """Eq. 3 over row blocks, GSPMD's partial sums and all-reduce written
    out: ``launch(g, δ_s, w_s)`` (one K1 launch) on each block's device,
    block 0 from the global row and the others from a zero row, the
    partial rows added on the first device in block order.  Every launch
    is issued before anything waits."""
    out = None
    for s, (d, w) in enumerate(zip(deltas, deltas.slices(weights))):
        g = global_params if s == 0 else torch.zeros_like(global_params,
                                                          device=d.device)
        part = launch(g, d, w)
        out = part if out is None else out + part.to(out.device,
                                                     non_blocking=True)
    return out


def _reset_rows(rows: torch.Tensor, m: torch.Tensor,
                new_global: torch.Tensor) -> torch.Tensor:
    return torch.where(m[:, None], new_global[None], rows)


def broadcast_to_participants(state: FLState, new_global: torch.Tensor,
                              mask: torch.Tensor) -> FLState:
    """Protocol Step 5: participants receive x_t (both x_k and y_k reset);
    placed rows on each block's device, with the new global row copied to
    each device once."""
    m = mask.bool()
    if isinstance(state.client_params, RowBlocks):
        ms = state.client_params.slices(m)
        gs = state.client_params.replicas(new_global)
        client, anchor = (RowBlocks(map(_reset_rows, rows, ms, gs))
                          for rows in (state.client_params,
                                       state.anchor_params))
    else:
        client = _reset_rows(state.client_params, m, new_global)
        anchor = _reset_rows(state.anchor_params, m, new_global)
    last_tx = torch.where(m, state.round, state.last_tx)
    return state._replace(global_params=new_global, client_params=client,
                          anchor_params=anchor, round=state.round + 1,
                          last_tx=last_tx)


def subset_aggregate(global_params: torch.Tensor, deltas_p: torch.Tensor,
                     valid: torch.Tensor, num_clients) -> torch.Tensor:
    """Participant-subset eq. (3): x ← x + (1/K) Σ_p valid_p · δ_p over a
    padded bucket ``deltas_p: [P, W]``; ``num_clients`` is the population K
    (a number or a 0-dim tensor)."""
    return ops.fl_aggregate_subset(global_params, deltas_p, valid,
                                   num_clients)


def finite_rows(deltas: torch.Tensor) -> torch.Tensor:
    """``[R] bool``: False where any element of the row is NaN/Inf."""
    if isinstance(deltas, RowBlocks):
        return deltas.join(finite_rows)
    return torch.isfinite(deltas).all(dim=1)


def update_norms(deltas: torch.Tensor) -> torch.Tensor:
    """Per-row L2 norm, ``[R]`` float32; non-finite elements count 0.  One
    sum over the flat row (padding included, which is 0), where JAX sums
    each leaf and then the leaves: the same norm to rounding."""
    if isinstance(deltas, RowBlocks):
        return deltas.join(update_norms)
    d = deltas.to(torch.float32)
    d = torch.where(torch.isfinite(d), d, 0.0)
    return torch.sqrt(torch.sum(d * d, dim=1))


def guard_scale(deltas: torch.Tensor, staleness: torch.Tensor,
                 guards) -> torch.Tensor:
    """The per-row guard weights of :func:`guard_weights`, ``[R]``."""
    w = torch.ones(staleness.shape[0], dtype=torch.float32,
                   device=deltas.device)
    if guards.quarantine:
        w = w * finite_rows(deltas).to(torch.float32)
    if guards.clip_norm is not None:
        n = update_norms(deltas)
        w = w * torch.clamp(
            guards.clip_norm / torch.clamp(n, min=1e-30), max=1.0)
    if guards.staleness_power != 0.0:
        s = staleness.to(torch.float32)
        w = w * (1.0 + torch.clamp(s, min=0.0)) ** (-guards.staleness_power)
    if guards.staleness_cap is not None:
        w = w * (staleness <= guards.staleness_cap).to(torch.float32)
    return w


def guard_weights(deltas: torch.Tensor, staleness: torch.Tensor,
                  guards) -> tuple:
    """Defensive per-row weights and sanitized deltas, ``(w [R], deltas')``;
    ``guards`` is a :class:`repro_torch.fl.faults.GuardConfig`.

    * quarantine: non-finite rows get weight 0 **and** are zeroed in
      ``deltas'``;
    * norm clip: finite rows are scaled by ``min(1, clip/‖δ‖)``, folded into
      the weight (the deltas are untouched);
    * staleness: ``(1 + Δτ)^{-power}`` and the hard cap Δτ ≤
      ``staleness_cap``.

    The aggregators below use only ``w``: K1's weighted mode zeroes the
    non-finite elements of a quarantined row itself.
    """
    w = guard_scale(deltas, staleness, guards)
    out = deltas
    if guards.quarantine:
        out = torch.where(finite_rows(deltas)[:, None], deltas, 0.0)
    return w, out


def guarded_aggregate(global_params: torch.Tensor, deltas: torch.Tensor,
                      mask: torch.Tensor, num_clients, staleness: torch.Tensor,
                      guards) -> torch.Tensor:
    """Eq. (3) with server-side defenses: x ← x + (1/K) Σ_k m_k·g_k·δ_k.

    ``guards=None`` (or an all-off config) is :func:`masked_aggregate`.
    Otherwise one K1 launch in its weighted mode, with ``m·g/K`` and the raw
    deltas."""
    if guards is None or not guards.active:
        return masked_aggregate(global_params, deltas, mask, num_clients)
    m = mask.to(torch.float32) * guard_scale(deltas, staleness, guards)
    inv = 1.0 / torch.as_tensor(num_clients, dtype=torch.float32,
                                device=m.device)
    return weighted_aggregate(global_params, deltas, m * inv)


def guarded_subset_aggregate(global_params: torch.Tensor,
                             deltas_p: torch.Tensor, valid: torch.Tensor,
                             num_clients, staleness_p: torch.Tensor,
                             guards) -> torch.Tensor:
    """Participant-subset form of :func:`guarded_aggregate`: rows are the
    padded transmitting bucket."""
    if guards is None or not guards.active:
        return subset_aggregate(global_params, deltas_p, valid, num_clients)
    v = valid.to(torch.float32) * guard_scale(deltas_p, staleness_p, guards)
    inv = 1.0 / torch.as_tensor(num_clients, dtype=torch.float32,
                                device=v.device)
    return ops.fl_aggregate_guarded(global_params, deltas_p, v * inv)


# ---------------------------------------------------------------------------
# staleness-aware aggregators (the competing async-FL schemes)
#
# The paper's eq.-3 update weighs every delivered pseudo-gradient by 1/K.
# The related-work baselines replace that constant with per-update weights
# from staleness Δτ, the scheme's selection probability, or the update's
# age, as one branch-free weight program over AggParams.  All are delta-form
# adaptations x ← x + Σ_k a_k·δ_k, where the a_k of the normalized kinds
# sum to the mixing rate α over the delivered set (docs/schemes.md).
# ---------------------------------------------------------------------------

_AGG_KINDS = ("paper", "fedasync", "csmaafl", "age")
_STALENESS_FNS = ("constant", "hinge", "poly")


class AggParams(NamedTuple):
    """:class:`AggregatorConfig` as float32 0-dim tensors; the one-hot
    ``kind_*`` / ``sfn_*`` lanes make the weight program branch-free."""

    kind_paper: torch.Tensor
    kind_fedasync: torch.Tensor
    kind_csmaafl: torch.Tensor
    kind_age: torch.Tensor
    sfn_constant: torch.Tensor
    sfn_hinge: torch.Tensor
    sfn_poly: torch.Tensor
    mix: torch.Tensor
    hinge_a: torch.Tensor
    hinge_b: torch.Tensor
    poly_a: torch.Tensor
    age_a: torch.Tensor
    prob_floor: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    """Staleness-aware aggregation scheme.

    Kinds:

    * ``"paper"`` — eq. 3: a_k = m_k / K, through the weighted path
      (``SimConfig.aggregator=None`` keeps the plain eq.-3 path).
    * ``"fedasync"`` — FedAsync-style mixing (arXiv:1903.03934): raw weight
      s(Δτ_k), normalized over the delivered set, scaled by ``mix`` (α).
    * ``"csmaafl"`` — CSMAAFL-style (arXiv:2306.01207): raw =
      s(Δτ_k)/max(p_k, prob_floor), normalized, scaled by α, debiasing the
      channel-aware contention.
    * ``"age"`` — Hu–Chen–Larsson (arXiv:2212.07356): raw =
      (1 + Δτ_k)^{+age_a}, so long-unheard clients count more.

    ``staleness_fn`` picks s(Δτ) for fedasync/csmaafl: ``"constant"`` (1),
    ``"hinge"`` (1 for Δτ ≤ b, else 1/(a·(Δτ−b))) or ``"poly"``
    ((1+Δτ)^{−a}).
    """

    kind: str = "paper"
    staleness_fn: str = "constant"
    mix: float = 0.6           # α — server mixing rate of the normalized kinds
    hinge_a: float = 10.0
    hinge_b: float = 4.0
    poly_a: float = 0.5
    age_a: float = 0.5
    prob_floor: float = 1e-2   # csmaafl importance-weight clamp

    def __post_init__(self):
        if self.kind not in _AGG_KINDS:
            raise ValueError(f"unknown aggregator kind {self.kind!r} "
                             f"(expected one of {_AGG_KINDS})")
        if self.staleness_fn not in _STALENESS_FNS:
            raise ValueError(f"unknown staleness_fn {self.staleness_fn!r} "
                             f"(expected one of {_STALENESS_FNS})")

    def params(self, device=None) -> AggParams:
        """The scalars as float32 0-dim tensors on ``device`` (``None``
        means the card)."""
        device = resolve_device(device)

        def f32(v):
            return torch.tensor(float(v), dtype=torch.float32, device=device)

        return AggParams(
            kind_paper=f32(self.kind == "paper"),
            kind_fedasync=f32(self.kind == "fedasync"),
            kind_csmaafl=f32(self.kind == "csmaafl"),
            kind_age=f32(self.kind == "age"),
            sfn_constant=f32(self.staleness_fn == "constant"),
            sfn_hinge=f32(self.staleness_fn == "hinge"),
            sfn_poly=f32(self.staleness_fn == "poly"),
            mix=f32(self.mix), hinge_a=f32(self.hinge_a),
            hinge_b=f32(self.hinge_b), poly_a=f32(self.poly_a),
            age_a=f32(self.age_a), prob_floor=f32(self.prob_floor))


def staleness_scale(staleness: torch.Tensor, ap: AggParams) -> torch.Tensor:
    """FedAsync's s(Δτ) per row over the one-hot ``sfn_*`` selector:
    constant 1, hinge ``1/(a·(Δτ−b))`` past the knee, or polynomial
    ``(1+Δτ)^{−a}``.  Finite and positive for Δτ ≥ 0."""
    s = torch.clamp(staleness.to(torch.float32), min=0.0)
    hinge = torch.where(
        s <= ap.hinge_b, 1.0,
        1.0 / torch.clamp(ap.hinge_a * (s - ap.hinge_b), min=1e-6))
    poly = (1.0 + s) ** (-ap.poly_a)
    return ap.sfn_constant * 1.0 + ap.sfn_hinge * hinge + ap.sfn_poly * poly


def scheme_weights(mask: torch.Tensor, staleness: torch.Tensor,
                   probs: torch.Tensor, ap: AggParams,
                   num_clients) -> torch.Tensor:
    """Per-row delta weights a_k of the configured aggregation scheme.

    ``mask`` is the effective delivery mask (possibly scaled by guard
    weights), ``staleness`` the per-row Δτ, ``probs`` the policy's selection
    probabilities, ``num_clients`` the population size.  For the normalized
    kinds Σ a_k = mix whenever any delivered mass exists (0 otherwise); for
    the paper kind a_k = m_k / K.
    """
    m = mask.to(torch.float32)
    s = staleness_scale(staleness, ap)
    raw_age = (1.0 + torch.clamp(staleness.to(torch.float32), min=0.0)) \
        ** ap.age_a
    inv_p = 1.0 / torch.maximum(probs.to(torch.float32), ap.prob_floor)
    raw = (ap.kind_paper * 1.0
           + ap.kind_fedasync * s
           + ap.kind_csmaafl * s * inv_p
           + ap.kind_age * raw_age)
    mraw = m * raw
    norm = mraw / torch.clamp(torch.sum(mraw), min=1e-30)
    a_paper = m / torch.as_tensor(num_clients, dtype=torch.float32,
                                  device=m.device)
    return ap.kind_paper * a_paper + (1.0 - ap.kind_paper) * ap.mix * norm


def weighted_aggregate(global_params: torch.Tensor, deltas: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """x ← x + Σ_r a_r·δ_r: one K1 launch in its weighted mode (the weights
    carry the masking, the 1/K or normalization and any guard scaling);
    over :class:`RowBlocks`, one launch a block."""
    weights = weights.to(torch.float32)
    if isinstance(deltas, RowBlocks):
        return _block_sums(global_params, deltas, weights,
                          ops.fl_aggregate_guarded)
    return ops.fl_aggregate_guarded(global_params, deltas, weights)


def scheme_aggregate(global_params: torch.Tensor, deltas: torch.Tensor,
                     mask: torch.Tensor, num_clients,
                     staleness: torch.Tensor, probs: torch.Tensor, agg,
                     guards=None) -> torch.Tensor:
    """Aggregation under a pluggable scheme (``agg``: an
    :class:`AggregatorConfig` or its :class:`AggParams`), with optional
    guards folded into the mask before the scheme weights are computed."""
    ap = (agg.params(global_params.device)
          if isinstance(agg, AggregatorConfig) else agg)
    m = mask.to(torch.float32)
    if guards is not None and guards.active:
        m = m * guard_scale(deltas, staleness, guards)
    a = scheme_weights(m, staleness, probs, ap, num_clients)
    return weighted_aggregate(global_params, deltas, a)


def scheme_subset_aggregate(global_params: torch.Tensor,
                            deltas_p: torch.Tensor, valid: torch.Tensor,
                            num_clients, staleness_p: torch.Tensor,
                            probs_p: torch.Tensor, agg,
                            guards=None) -> torch.Tensor:
    """Participant-subset form of :func:`scheme_aggregate`: rows are the
    padded transmitting bucket, ``num_clients`` the population."""
    return scheme_aggregate(global_params, deltas_p, valid, num_clients,
                            staleness_p, probs_p, agg, guards=guards)
