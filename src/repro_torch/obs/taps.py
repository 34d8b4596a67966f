"""Metrics taps: per-round reducers carried through every execution path
(counterpart of ``repro.obs.taps``).

The paper's argument is about *dynamics* — staleness Δ_k, per-client energy
(eq. 5), the selection-probability trade-off — that end-of-run curves do
not show.  A :class:`MetricsSpec` turns on a set of per-round reducers whose
accumulators are fixed-shape tensors carried beside the round state:

* **participation counts** — ``tx_count [K] int32``: how often each
  client's Bernoulli/Δ_k decision fired;
* **staleness histogram** — ``stale_hist [bins] int32``: Δτ at transmission
  over *delivered* uploads (the last bin is open-ended);
* **energy by cause** — ``energy_cause [3] float32``: eq.-5 Joules split
  into voluntary uploads, Δ_k-forced uploads and the retry overhead paid to
  the lossy-uplink fault process;
* **guard interventions** — ``guard_events [3] int32``: quarantined
  (non-finite), norm-clipped and staleness-capped updates (only with active
  ``cfg.guards``);
* **aggregation-weight stats** — ``weight_entropy`` (the entropy of each
  round's normalized aggregation weights, summed over rounds) and
  ``weight_max`` (the running largest weight).

The rules the engines keep, as JAX's do:

* **disabled means absent** — ``SimConfig.metrics=None`` or
  :meth:`MetricsSpec.none` adds nothing to any carry and launches nothing:
  a run is the untapped run operation for operation.  Taps read and never
  write the round's tensors, so a tapped run's trajectory is the untapped
  run's bit for bit too.
* **fixed shapes, None fields** — a disabled tap is a ``None`` field of the
  :class:`MetricsState` NamedTuple; the checkpoint writer skips ``None``,
  so any subset resumes.
* **split accumulation** — the sparse path reduces the ledger taps
  (participation, staleness, energy) after phase A from its ``[T, P]``
  participant lanes and accumulates the train taps (guards, weights) in
  phase B over the bucket; :func:`merge_metrics` joins the halves.  Integer
  taps equal the dense engine's; float sums agree to float associativity.

Counters are ``int32`` and sums ``float32``, JAX's dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from .. import resolve_device

__all__ = ["MetricsSpec", "MetricsState", "init_metrics", "metrics_active",
           "update_ledger_taps", "update_train_taps", "metrics_round_update",
           "merge_metrics", "metrics_summary", "metrics_numpy",
           "stack_metrics"]


@dataclasses.dataclass(frozen=True)
class MetricsSpec:
    """Which per-round reducers to run.

    The default constructor is the default tap set — everything on.
    :meth:`none` is all-off, which runs the same operations as
    ``metrics=None``."""

    participation: bool = True     # tx_count [K]
    staleness_hist: bool = True    # stale_hist [staleness_bins]
    staleness_bins: int = 8        # linear bins 0..bins-2, last bin open
    energy_by_cause: bool = True   # energy_cause [3]
    guard_events: bool = True      # guard_events [3] (needs active guards)
    weight_stats: bool = True      # weight_entropy / weight_max scalars

    def __post_init__(self):
        if self.staleness_bins < 2:
            raise ValueError("staleness_bins must be >= 2 "
                             f"(got {self.staleness_bins})")

    @classmethod
    def none(cls) -> "MetricsSpec":
        return cls(participation=False, staleness_hist=False,
                   energy_by_cause=False, guard_events=False,
                   weight_stats=False)

    @property
    def ledger_active(self) -> bool:
        """Taps computable from the ``[K]`` decision/ledger vectors alone."""
        return (self.participation or self.staleness_hist
                or self.energy_by_cause)

    def train_active(self, guards=None) -> bool:
        """Taps that need the deltas or the aggregation weights."""
        return self.weight_stats or (
            self.guard_events and guards is not None
            and getattr(guards, "active", False))


class MetricsState(NamedTuple):
    """Fixed-shape accumulators; a disabled tap's field is ``None``."""

    tx_count: Any = None        # [K] int32 — decision-mask fires per client
    stale_hist: Any = None      # [bins] int32 — Δτ of delivered uploads
    energy_cause: Any = None    # [3] float32 — (voluntary, forced, retry)
    guard_events: Any = None    # [3] int32 — (quarantined, clipped, capped)
    weight_entropy: Any = None  # float32 — Σ_rounds H(normalized weights)
    weight_max: Any = None      # float32 — running max weight
    rounds: Any = None          # int32 — ledger rounds accumulated
    agg_rounds: Any = None      # int32 — train rounds accumulated


def _guards_on(guards) -> bool:
    return guards is not None and getattr(guards, "active", False)


def metrics_active(spec: MetricsSpec | None, guards=None,
                   parts: str = "all") -> bool:
    """Would :func:`init_metrics` make any accumulator?  The engines decide
    their carry's structure on it, so it agrees with :func:`init_metrics`
    exactly."""
    if spec is None:
        return False
    ledger = parts in ("all", "ledger") and spec.ledger_active
    train = parts in ("all", "train") and spec.train_active(guards)
    return ledger or train


def init_metrics(spec: MetricsSpec | None, num_clients: int, guards=None,
                 parts: str = "all", device=None) -> MetricsState | None:
    """Zeroed accumulators for the enabled taps on ``device`` (``None``
    means the card), or ``None`` when nothing is enabled.

    ``parts`` selects the subset of the sparse path's split accumulation:
    ``"ledger"`` (phase A), ``"train"`` (phase B), or ``"all"`` (the dense
    engine and the legacy loop)."""
    if not metrics_active(spec, guards, parts):
        return None
    device = resolve_device(device)
    ledger = parts in ("all", "ledger") and spec.ledger_active
    train = parts in ("all", "train") and spec.train_active(guards)
    ge = train and spec.guard_events and _guards_on(guards)
    ws = train and spec.weight_stats

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    i32, f32 = torch.int32, torch.float32
    return MetricsState(
        tx_count=(zeros((num_clients,), i32)
                  if ledger and spec.participation else None),
        stale_hist=(zeros((spec.staleness_bins,), i32)
                    if ledger and spec.staleness_hist else None),
        energy_cause=(zeros((3,), f32)
                      if ledger and spec.energy_by_cause else None),
        guard_events=zeros((3,), i32) if ge else None,
        weight_entropy=zeros((), f32) if ws else None,
        weight_max=zeros((), f32) if ws else None,
        rounds=zeros((), i32) if ledger else None,
        agg_rounds=zeros((), i32) if train else None,
    )


def _count(b: torch.Tensor) -> torch.Tensor:
    """The number of True lanes, as an int32 0-dim tensor."""
    return torch.sum(b.to(torch.int32)).to(torch.int32)


def energy_by_cause(e_round: torch.Tensor, forced: torch.Tensor,
                    e_base: torch.Tensor) -> torch.Tensor:
    """``[voluntary, forced, retry]`` Joules of one round's ``[K]`` lanes
    (or a whole run's ``[T, P]`` lanes): the energy paid split by the Δ_k
    flag, and ``Σ relu(paid − decided)``."""
    f = forced.to(torch.float32)
    e = e_round.to(torch.float32)
    retry = torch.clamp(e - e_base.to(torch.float32), min=0.0)
    return torch.stack([torch.sum(e * (1.0 - f)), torch.sum(e * f),
                        torch.sum(retry)])


def staleness_histogram(hist: torch.Tensor, staleness: torch.Tensor,
                        delivered: torch.Tensor) -> torch.Tensor:
    """``hist`` plus one count per delivered lane in its staleness bin
    (clipped to ``[0, bins-1]``), as JAX's ``.at[b].add``."""
    b = torch.clamp(staleness.to(torch.int64), 0, hist.shape[0] - 1)
    return hist.scatter_add(0, b.reshape(-1),
                            (delivered > 0).to(torch.int32).reshape(-1))


def update_ledger_taps(ms: MetricsState, spec: MetricsSpec, *,
                       mask: torch.Tensor, forced: torch.Tensor,
                       e_base: torch.Tensor, e_round: torch.Tensor,
                       staleness: torch.Tensor,
                       delivered: torch.Tensor) -> MetricsState:
    """One round of the ``[K]``-vector taps (the dense round step and the
    legacy loop).  ``e_base`` is the eq.-5 decision energy *before* the
    fault pipeline, ``e_round`` what was paid (retries, dropped uploads)."""
    del spec
    upd = {}
    if ms.tx_count is not None:
        upd["tx_count"] = ms.tx_count + (mask > 0).to(torch.int32)
    if ms.stale_hist is not None:
        upd["stale_hist"] = staleness_histogram(ms.stale_hist, staleness,
                                                delivered)
    if ms.energy_cause is not None:
        upd["energy_cause"] = ms.energy_cause + energy_by_cause(
            e_round, forced, e_base)
    if ms.rounds is not None:
        upd["rounds"] = ms.rounds + 1
    return ms._replace(**upd)


def _effective_weights(deltas, delivered, staleness, probs, num_clients,
                       guards, agg_params):
    """The engines' aggregation weights, recomputed: guard weights fold
    into the delivery mask, then the scheme's weights or the paper's m/K
    (a few row-vector operations, so the aggregators keep their
    signatures and the untapped run its operations)."""
    from ..fl.state import guard_scale, scheme_weights

    m = delivered.to(torch.float32)
    if _guards_on(guards):
        m = m * guard_scale(deltas, staleness, guards)
    if agg_params is not None:
        return scheme_weights(m, staleness, probs, agg_params, num_clients)
    return m / torch.as_tensor(num_clients, dtype=torch.float32,
                               device=m.device)


def update_train_taps(ms: MetricsState, spec: MetricsSpec, *,
                      deltas: torch.Tensor, delivered: torch.Tensor,
                      staleness: torch.Tensor, probs: torch.Tensor,
                      num_clients, guards=None,
                      agg_params=None) -> MetricsState:
    """One round of the delta/weight taps.  The rows may be the population
    (dense, legacy) or the participant bucket (sparse phase B): counts
    agree exactly, float reductions to associativity."""
    from ..fl.state import finite_rows, update_norms

    del spec
    upd = {}
    dlv = delivered if delivered.dtype == torch.bool else delivered > 0
    if ms.guard_events is not None:
        none = torch.zeros_like(dlv)
        q = dlv & ~finite_rows(deltas)
        c = (dlv & (update_norms(deltas) > guards.clip_norm)
             if guards.clip_norm is not None else none)
        s = (dlv & (staleness > guards.staleness_cap)
             if guards.staleness_cap is not None else none)
        upd["guard_events"] = ms.guard_events + torch.stack(
            [_count(q), _count(c), _count(s)])
    if ms.weight_entropy is not None:
        a = _effective_weights(deltas, dlv, staleness, probs, num_clients,
                               guards, agg_params)
        p = a / torch.clamp(torch.sum(a), min=1e-30)
        ent = -torch.sum(torch.where(
            a > 0, p * torch.log(torch.clamp(p, min=1e-30)), 0.0))
        upd["weight_entropy"] = ms.weight_entropy + ent
        upd["weight_max"] = torch.maximum(ms.weight_max, torch.max(a))
    if ms.agg_rounds is not None:
        upd["agg_rounds"] = ms.agg_rounds + 1
    return ms._replace(**upd)


def metrics_round_update(ms: MetricsState, spec: MetricsSpec, *,
                         mask, forced, e_base, e_round, staleness,
                         delivered, deltas, probs, num_clients,
                         guards=None, agg_params=None) -> MetricsState:
    """The dense round step's one-call update: ledger taps, then train
    taps."""
    ms = update_ledger_taps(ms, spec, mask=mask, forced=forced,
                            e_base=e_base, e_round=e_round,
                            staleness=staleness, delivered=delivered)
    if ms.agg_rounds is not None:
        ms = update_train_taps(ms, spec, deltas=deltas, delivered=delivered,
                               staleness=staleness, probs=probs,
                               num_clients=num_clients, guards=guards,
                               agg_params=agg_params)
    return ms


def merge_metrics(a: MetricsState | None,
                  b: MetricsState | None) -> MetricsState | None:
    """Join split accumulations (sparse phase A's ledger taps and phase B's
    train taps) field by field, taking whichever half made the buffer."""
    if a is None:
        return b
    if b is None:
        return a
    return MetricsState(*[(x if x is not None else y)
                          for x, y in zip(a, b)])


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def metrics_numpy(ms: MetricsState | None) -> MetricsState | None:
    """The accumulators read back as numpy arrays (``None`` fields kept):
    what ``SimResult.metrics`` holds."""
    if ms is None:
        return None
    return MetricsState(*[None if x is None else _np(x) for x in ms])


def stack_metrics(lanes: Sequence[MetricsState | None],
                  shape: tuple) -> MetricsState | None:
    """Lane results' taps stacked field by field under the leading axes
    ``shape`` (the matrices' lane axes), or ``None`` untapped."""
    if lanes[0] is None:
        return None

    def stack(xs):
        a = np.stack([_np(x) for x in xs])
        return a.reshape(tuple(shape) + a.shape[1:])

    return MetricsState(*[None if xs[0] is None else stack(xs)
                          for xs in zip(*lanes)])


def metrics_summary(ms: MetricsState | None) -> dict:
    """Host readback: one dict of plain numbers and lists a tap (manifest-
    and JSON-friendly)."""
    if ms is None:
        return {}
    out = {}
    if ms.tx_count is not None:
        tx = _np(ms.tx_count)
        out["tx_count"] = tx.tolist()
        out["tx_total"] = int(tx.sum())
    if ms.stale_hist is not None:
        out["stale_hist"] = _np(ms.stale_hist).tolist()
    if ms.energy_cause is not None:
        e = _np(ms.energy_cause)
        out["energy_voluntary"] = float(e[0])
        out["energy_forced"] = float(e[1])
        out["energy_retry_overhead"] = float(e[2])
    if ms.guard_events is not None:
        g = _np(ms.guard_events)
        out["guard_quarantined"] = int(g[0])
        out["guard_clipped"] = int(g[1])
        out["guard_stale_capped"] = int(g[2])
    if ms.weight_entropy is not None:
        n = max(int(_np(ms.agg_rounds)), 1)
        out["weight_entropy_mean"] = float(_np(ms.weight_entropy)) / n
        out["weight_max"] = float(_np(ms.weight_max))
    if ms.rounds is not None:
        out["rounds"] = int(_np(ms.rounds))
    return out
