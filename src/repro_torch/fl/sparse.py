"""Participant-centric sparse rounds (counterpart of ``repro.fl.sparse``):
per-participant cost at any population.

The dense engine (:mod:`repro_torch.fl.engine`) carries every per-round
structure at population width ``[K]``: the round batch, local training, the
``[K, W]`` client and anchor rows.  Only ~pK clients transmit a round, so
this module splits the round into two phases whose expensive one scales with
the transmitting set:

* **Phase A — participation** (:func:`build_participation_program`):
  ``[K]`` vectors only (probabilities, Bernoulli draws, Δ_k staleness, the
  eq.-5 energy ledger), through the dense engine's
  :func:`~repro_torch.fl.engine.apply_round_decision` on the same
  ``fold_in(base_key, t)`` stream, so masks and energies are the dense
  engine's.  Its outputs are participant-sized: each round's transmitting
  ids (ascending, padded to a bucket with ``K``), anchor slots and energies.
* **Batch gather** (:func:`repro_torch.data.device.gather_participant_rounds`):
  participants' minibatches come from the per-client stream
  ``fold_in(fold_in(data_key, t), k)``, so only ``[T, P, L, B, ...]`` is
  gathered from the store.
* **Phase B — training** (:func:`build_sparse_train_program`): no tensor has
  a K-sized axis.  The carry is the global-model history ``[T+1, W]`` (slot
  s = the model broadcast after round s-1) as flat rows of the port's
  :class:`~repro_torch.fl.state.ParamLayout`; each round gathers its
  participants' anchors ``hist[slot_p]``, trains them as one ``[P, W]``
  bucket and applies the participant-subset eq. 3 (one K1 launch) with the
  population K as a number.  One build serves every K that shares a
  bucket (:func:`train_trace_count` counts the builds).

The sparse path implements ``SimConfig.local_mode="participants"``: a
client trains ``local_iters`` steps from its last received global in the
round it transmits.  The dense engine runs the same mode, and the two agree
(masks bit for bit, floats to rounding); the paper's default
``"continuous"`` mode trains every client every round and stays dense.

With ``cfg.faults`` set, phase A runs :func:`~repro_torch.fl.faults.
apply_faults` after each round's decision, as the dense engine does: the
compaction stays over the decision mask, the participant lanes carry what
was delivered and corrupted, and the ``last_tx`` and anchor ledgers advance
on delivered uploads only.  Phase B corrupts the flagged rows of its bucket
and aggregates over the delivered ones.

With ``cfg.metrics`` enabling taps the accumulation is split, as in JAX:
phase A emits two more participant lanes (``forced_p``, ``base_p``) and
:func:`_reduce_ledger_taps` reduces the ledger taps from the ``[T, P]``
trace after the round loop; phase B accumulates the train taps over its
bucket; :func:`~repro_torch.obs.taps.merge_metrics` joins them.  Integer
taps equal the dense engine's.

A run's spans: ``sparse.phase_a`` (through its ``n_tx`` readback), then
``sparse.train`` over ``sparse.gather`` (the participant gather) and
``sparse.phase_b`` (through its readback), then ``sparse.densify`` (the
trace's readbacks and the ``[T, K]`` densification on the host); the first
four are timed on the card too while a profiler records
(:mod:`repro_torch.obs.telemetry`).
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from .. import random as jr
from .. import resolve_device
from ..core.channel import CellConfig
from ..core.selection import (as_policy_fn, participant_bucket,
                              participants_from_mask, policy_ledger_ok)
from ..data.device import (DeviceDataStore, data_stream_key,
                           from_client_datasets, gather_participant_rounds)
from ..data.synthetic import Dataset
from ..obs.taps import (MetricsState, energy_by_cause, init_metrics,
                        merge_metrics, metrics_active, metrics_numpy,
                        staleness_histogram, update_train_taps)
from ..obs.telemetry import emit_run_manifest, get_telemetry
from ..optim import Optimizer, sgd
from .engine import (SimResult, _as_store, apply_round_decision,
                     check_modes, make_local_train)
from .faults import apply_faults, corrupt_deltas, init_fault_state
from .state import (FLState, ParamLayout, guarded_subset_aggregate,
                    scheme_subset_aggregate, subset_aggregate)

#: phase-B programs built.  Shapes depend only on (bucket, T, model), so a
#: K sweep sharing a bucket builds one (tests/test_torch_sparse.py).
TRAIN_TRACE_COUNT = 0


def train_trace_count() -> int:
    return TRAIN_TRACE_COUNT


#: process-wide one-shot flag of the bucket-spill warning (a sweep that
#: overflows every call should not drown the log)
_SPILL_WARNED = False


def _warn_spill_once(bucket: int, grown: int, realized: int) -> None:
    global _SPILL_WARNED
    if _SPILL_WARNED:
        return
    _SPILL_WARNED = True
    warnings.warn(
        f"participant bucket overflow: a round realized {realized} "
        f"transmitters > bucket {bucket}; spilling — regrowing the bucket "
        f"to {grown} and rerunning phase A (exact, but builds another "
        "phase-B program). Pass SimConfig(participant_bucket=...) with more "
        "headroom, or overflow='error' to fail instead.",
        RuntimeWarning, stacklevel=3)


class _DecisionView(NamedTuple):
    """The two ``FLState`` fields :func:`apply_round_decision` and a ledger
    policy read: phase A builds no parameter rows."""

    round: torch.Tensor    # int32 scalar
    last_tx: torch.Tensor  # [K] int32


class ParticipationTrace(NamedTuple):
    """Phase A's per-round outputs, leading axis T, all participant-sized
    but the overflow counter.  Lanes past a round's transmitters are padding
    (``part_idx == K``, ``valid`` False, every other lane 0)."""

    part_idx: torch.Tensor     # [P] int32 transmitting ids, padded with K
    valid: torch.Tensor        # [P] bool
    anchor_slot: torch.Tensor  # [P] int32 history slot of each anchor
    e_p: torch.Tensor          # [P] f32 Joules (eq. 5, with the retries)
    delivered: torch.Tensor    # [P] bool: the upload survived the faults
    corrupt: torch.Tensor      # [P] bool: delivered but poisoned
    stale: torch.Tensor        # [P] int32 staleness Δτ at transmission
    prob: torch.Tensor         # [P] f32 nominal policy prob (pre aging boost)
    n_tx: torch.Tensor         # int32 realized transmitters (overflow check)
    # metrics-tap lanes, only when cfg.metrics enables ledger taps
    forced_p: Any = None       # [P] bool: a Δ_k-forced transmission
    base_p: Any = None         # [P] f32 decision energy, before the faults


def _compact(mask, e_round, probs, t, last_tx, anchor_slot, bucket: int,
             delivered=None, corrupt=None, taps: bool = False, forced=None,
             e_base=None) -> ParticipationTrace:
    """One round's (``[K]`` rows, ``t`` an int) or every round's (``[T, K]``
    rows, ``t`` ``[T, 1]``) participant lanes over the decision ``mask``;
    ``last_tx`` and ``anchor_slot`` are the ledgers before the round,
    ``delivered`` and ``corrupt`` the fault outcomes (``None``: every
    upload lands clean).  ``taps`` adds the tap lanes from ``forced`` and
    ``e_base`` (``None``: nothing forced, the energy paid)."""
    idx, valid, n_tx = participants_from_mask(mask, bucket)
    kc = torch.clamp(idx.long(), 0, mask.shape[-1] - 1)

    def lane(v, fill):
        return torch.where(valid, v.gather(-1, kc), fill)

    del_p = valid if delivered is None else lane(delivered > 0, False)
    cor_p = (torch.zeros_like(valid) if corrupt is None
             else lane(corrupt, False))
    e_p = lane(e_round, 0.0)
    tr = ParticipationTrace(
        idx, valid, lane(anchor_slot, 0), e_p, del_p, cor_p,
        torch.where(valid, t - last_tx.gather(-1, kc), 0),
        lane(probs.to(torch.float32), 0.0), n_tx)
    if taps:
        tr = tr._replace(
            forced_p=(torch.zeros_like(valid) if forced is None
                      else lane(forced, False)),
            base_p=e_p if e_base is None else lane(e_base, 0.0))
    return tr


def _reduce_ledger_taps(tr: ParticipationTrace, spec, num_clients: int,
                        rounds: int) -> MetricsState:
    """The ledger taps of a whole run from phase A's ``[T, P]`` lanes, in
    one pass after the round loop.  The pad sentinel ``K`` of ``part_idx``
    lands in a spare slot ``K`` that is sliced off (JAX's ``mode="drop"``
    scatter); padded lanes are neither valid nor delivered and carry no
    energy.  Integer taps equal the dense engine's per-round accumulation
    (the lanes are exactly the mask's fires); the energy sums in another
    order."""
    dev = tr.valid.device
    tx = stale = ec = None
    if spec.participation:
        tx = torch.zeros(num_clients + 1, dtype=torch.int32, device=dev)
        tx = tx.scatter_add(0, tr.part_idx.reshape(-1).long(),
                            tr.valid.reshape(-1).to(torch.int32))
        tx = tx[:num_clients]
    if spec.staleness_hist:
        stale = staleness_histogram(
            torch.zeros(spec.staleness_bins, dtype=torch.int32, device=dev),
            tr.stale, tr.delivered)
    if spec.energy_by_cause:
        ec = energy_by_cause(tr.e_p, tr.forced_p, tr.base_p)
    return MetricsState(tx_count=tx, stale_hist=stale, energy_cause=ec,
                        rounds=torch.tensor(rounds, dtype=torch.int32,
                                            device=dev))


def build_participation_program(policy_fn, cfg, cell: CellConfig,
                                num_clients: int, bucket: int,
                                hoist_rounds: bool | None = None) -> Callable:
    """Phase A: ``(h_rounds [T, K], base_key) -> (last_tx [K], energy [K],
    ParticipationTrace[T])``, and a fourth output, the ledger taps'
    :class:`~repro_torch.obs.taps.MetricsState`, when ``cfg.metrics``
    enables any.

    The policy must be ``state_free`` or a *ledger* policy reading only the
    ``(round, last_tx)`` view phase A carries: state-free policies answer
    every round at once, ledger policies run round by round against a
    :class:`_DecisionView`.

    **Full round hoist**: when the decision is round-local (a state-free
    policy and no ``max_staleness`` forcing, which reads the ledger), every
    round's mask and energy come from one batched decision over ``[T, K]``,
    the staleness and anchor ledgers from exclusive cumulative maxima, and
    the index sets from one compaction of the ``[T, K]`` mask.  Integers are
    those of the round-by-round path; the energy ledger sums over rounds in
    another order (JAX's order on each path).  ``hoist_rounds`` pins the
    choice: ``True`` raises if the preconditions fail, ``False`` takes the
    round-by-round path, ``None`` chooses.
    """
    hoist = getattr(policy_fn, "state_free", False)
    if not hoist and not getattr(policy_fn, "ledger", False):
        raise ValueError(
            "sparse participation requires a state_free or ledger policy "
            "(phase A carries only the (round, last_tx) ledger); policies "
            "reading trained parameters must use the dense engine")
    K = num_clients
    faults = cfg.faults
    # guards play no part in the ledger taps
    ltap = metrics_active(cfg.metrics, None, parts="ledger")
    full_hoist = hoist and faults is None and cfg.max_staleness is None
    if hoist_rounds is not None:
        if hoist_rounds and not full_hoist:
            raise ValueError(
                "hoist_rounds=True needs a state_free policy, faults=None "
                "and max_staleness=None (everything else carries sequential "
                "state through the rounds)")
        full_hoist = bool(hoist_rounds)

    def taps(out):
        if not ltap:
            return out
        return out + (_reduce_ledger_taps(out[2], cfg.metrics, K,
                                          cfg.rounds),)

    @torch.no_grad()
    def program(h_rounds, base_key):
        T = cfg.rounds
        dev = h_rounds.device
        ts = torch.arange(T, dtype=torch.int32, device=dev)
        round_keys = jr.fold_in(base_key, ts)     # [T, 2]
        zeros = torch.zeros(K, dtype=torch.int32, device=dev)
        if hoist:
            probs_all, w_all = policy_fn(ts, h_rounds, None)

        if full_hoist:
            tsc = ts[:, None]
            view = _DecisionView(round=tsc, last_tx=zeros)   # never read
            mask, _, _, e_all = apply_round_decision(
                probs_all, w_all, round_keys, h_rounds, view, cfg, cell, K)
            fire = mask > 0
            # the ledgers before round t as exclusive cumulative maxima:
            # last_tx = max{s < t : fired at s} (0 if none), anchor slot =
            # that + 1 (0 if none), the integers of the per-round updates
            lt_inc = torch.cummax(torch.where(fire, tsc, 0), dim=0).values
            slot_inc = torch.cummax(torch.where(fire, tsc + 1, 0),
                                    dim=0).values
            lt_excl = torch.cat([zeros[None], lt_inc[:-1]])
            slot_excl = torch.cat([zeros[None], slot_inc[:-1]])
            # no forcing and no faults: nothing forced, e_base = e_round
            tr = _compact(mask, e_all, probs_all, tsc, lt_excl, slot_excl,
                          bucket, taps=ltap)
            return taps((lt_inc[-1], torch.sum(e_all, dim=0), tr))

        last_tx, anchor_slot = zeros, zeros
        energy = torch.zeros(K, dtype=torch.float32, device=dev)
        if faults is not None:
            fp = faults.params(dev)
            fstate = init_fault_state(K, dev)
        rows = []
        for t in range(T):
            h_t = h_rounds[t]
            view = _DecisionView(round=ts[t], last_tx=last_tx)
            probs, w = ((probs_all[t], w_all[t]) if hoist
                        else policy_fn(t, h_t, view))
            mask, forced, _, e_round = apply_round_decision(
                probs, w, round_keys[t], h_t, view, cfg, cell, K)
            e_base = e_round
            delivered = corrupt = None
            if faults is not None:   # the dense engine's salted streams
                out, fstate = apply_faults(t, base_key, mask, e_round,
                                           fstate, fp, faults)
                delivered, corrupt, e_round = (out.delivered, out.corrupt,
                                               out.e_round)
            energy = energy + e_round
            rows.append(_compact(mask, e_round, probs, t, last_tx,
                                 anchor_slot, bucket, delivered, corrupt,
                                 ltap, forced, e_base))
            # the ledgers advance on delivered uploads: a lost one's
            # staleness keeps growing
            fire = (mask if delivered is None else delivered) > 0
            last_tx = torch.where(fire, t, last_tx)
            anchor_slot = torch.where(fire, t + 1, anchor_slot)
        tr = ParticipationTrace(*(None if lanes[0] is None
                                  else torch.stack(lanes)
                                  for lanes in zip(*rows)))
        return taps((last_tx, energy, tr))

    return program


# ---------------------------------------------------------------------------
# phase B: the K-independent participant training program
# ---------------------------------------------------------------------------

#: (bucket, T, model/cfg signature) -> phase-B program; populations of any
#: size that share a bucket share the entry
_TRAIN_CACHE: dict = {}


def _train_cache_key(cfg, opt_token, loss_fn, acc_fn, params, sample_shape,
                     test_shape, bucket: int):
    shapes = tuple((i, name, tuple(params[i][name].shape),
                    str(params[i][name].dtype))
                   for i, name, _, _ in ParamLayout.of(params).entries)
    return (bucket, cfg.rounds, cfg.local_iters, cfg.batch_size,
            cfg.eval_every, opt_token, id(loss_fn), id(acc_fn), shapes,
            tuple(sample_shape), tuple(test_shape), repr(cfg.faults),
            repr(cfg.guards), repr(cfg.aggregator), repr(cfg.metrics))


def build_sparse_train_program(loss_fn: Callable, acc_fn: Callable,
                               opt: Optimizer, cfg) -> Callable:
    """Phase B: ``(params, xb [T,P,L,B,...], yb [T,P,L,B], valid [T,P],
    slot [T,P], num_clients, test_x, test_y[, delivered, corrupt, stale,
    probs, agg_params]) -> (global [W], (acc [T], loss [T], did_eval
    [T]))``, and a third output, the train taps'
    :class:`~repro_torch.obs.taps.MetricsState` over the bucket, when
    ``cfg.metrics`` enables any.

    No tensor of the program has a K-sized axis: the carry is the history
    ``[T+1, W]``, training runs over the ``[P, W]`` bucket, and the 1/K of
    eq. 3 takes the population as a number.  Each round aggregates as JAX's
    does: ``cfg.aggregator`` set → :func:`scheme_subset_aggregate` (active
    guards fold in), else active ``cfg.guards`` →
    :func:`guarded_subset_aggregate`, both K1's weighted mode; otherwise
    :func:`subset_aggregate`, K1's subset mode, each over the ``delivered``
    lanes (default ``valid``).  With ``cfg.faults`` set the ``corrupt``
    rows are poisoned first (:func:`~repro_torch.fl.faults.corrupt_deltas`).
    ``stale`` and ``probs`` default to zeros (read by the weighted
    aggregators only); ``agg_params`` replaces ``cfg.aggregator.params()``,
    so one program serves a whole scheme panel.  Building one bumps
    :data:`TRAIN_TRACE_COUNT`.
    """
    global TRAIN_TRACE_COUNT
    TRAIN_TRACE_COUNT += 1
    local_train = make_local_train(loss_fn, opt)
    T = cfg.rounds
    guards = cfg.guards if cfg.guards is not None and cfg.guards.active \
        else None
    agg = cfg.aggregator
    faults = cfg.faults
    ttap = metrics_active(cfg.metrics, guards, parts="train")

    @torch.no_grad()
    def program(params, xb_all, yb_all, valid_all, slot_all, num_clients,
                test_x, test_y, delivered_all=None, corrupt_all=None,
                stale_all=None, probs_all=None, agg_params=None):
        dev = xb_all.device
        layout = ParamLayout.of(params)
        hist = torch.zeros((T + 1, layout.width), dtype=torch.float32,
                           device=dev)
        hist[0] = layout.flatten(params, dev)
        if delivered_all is None:
            delivered_all = valid_all
        if stale_all is None:
            stale_all = torch.zeros(valid_all.shape, dtype=torch.int32,
                                    device=dev)
        if probs_all is None:
            probs_all = torch.zeros(valid_all.shape, dtype=torch.float32,
                                    device=dev)
        ap = None
        if agg is not None:
            ap = agg.params(dev) if agg_params is None else agg_params
        if faults is not None:
            fp = faults.params(dev)
        accs = torch.zeros(T, dtype=torch.float32, device=dev)
        losses = torch.zeros(T, dtype=torch.float32, device=dev)
        did = torch.zeros(T, dtype=torch.bool)
        ms = init_metrics(cfg.metrics, 0, guards, parts="train", device=dev)
        for t in range(T):
            anchors = hist[slot_all[t].long()]
            deltas = local_train(anchors, xb_all[t], yb_all[t],
                                 layout) - anchors
            if faults is not None:
                deltas = corrupt_deltas(deltas, corrupt_all[t], fp, faults)
            deliv = delivered_all[t]
            if ap is not None:
                g_new = scheme_subset_aggregate(
                    hist[t], deltas, deliv, num_clients, stale_all[t],
                    probs_all[t], ap, guards=guards)
            elif guards is not None:
                g_new = guarded_subset_aggregate(
                    hist[t], deltas, deliv, num_clients, stale_all[t],
                    guards)
            else:
                g_new = subset_aggregate(hist[t], deltas, deliv,
                                         num_clients)
            hist[t + 1] = g_new
            if ttap:
                ms = update_train_taps(
                    ms, cfg.metrics, deltas=deltas, delivered=deliv,
                    staleness=stale_all[t], probs=probs_all[t],
                    num_clients=num_clients, guards=guards, agg_params=ap)
            if t % cfg.eval_every == 0 or t == T - 1:
                g = layout.unflatten(g_new)
                accs[t] = acc_fn(g, test_x, test_y)
                losses[t] = loss_fn(g, test_x, test_y)
                did[t] = True
        out = (hist[T], (accs, losses, did))
        return out + (ms,) if ttap else out

    return program


def _cached_train_program(key, build: Callable) -> Callable:
    if key not in _TRAIN_CACHE:
        _TRAIN_CACHE[key] = build()
    return _TRAIN_CACHE[key]


# ---------------------------------------------------------------------------
# runner: phase A -> participant gather -> phase B -> SimResult
# ---------------------------------------------------------------------------


def _auto_bucket(policy_fn, h_rounds: torch.Tensor, cfg,
                 num_clients: int) -> int:
    """Bucket from the expected transmitting mass: the largest Σp of a
    round, with Poisson-tail headroom (:func:`participant_bucket`).  Ledger
    policies are asked at zero staleness (``state=None``), as JAX does; the
    spill path stays exact whatever the estimate."""
    T = cfg.rounds
    if getattr(policy_fn, "state_free", False):
        ts = torch.arange(T, dtype=torch.int32, device=h_rounds.device)
        probs = policy_fn(ts, h_rounds, None)[0]
    else:   # a ledger policy answers one round at a time
        probs = torch.stack([policy_fn(t, h_rounds[t], None)[0]
                             for t in range(T)])
    expected = float(torch.max(torch.sum(probs.to(torch.float32), dim=-1)))
    return participant_bucket(expected, cap=num_clients)


def make_sparse_runner(loss_fn: Callable, acc_fn: Callable,
                       client_data: Sequence[Dataset] | DeviceDataStore,
                       test_ds: Dataset, policy, cell: CellConfig, cfg,
                       opt: Optimizer | None = None, device=None,
                       train_program: Callable | None = None) -> Callable:
    """Participant-centric counterpart of ``engine.make_runner``.

    Returns ``runner(params, h_all, seed=None, agg_params=None) ->
    SimResult`` with the dense engine's result contract: the ``[T, K]``
    participation, per-round energy and, under faults, deliveries and
    corruptions are rebuilt on the host from the participant trace, and
    ``result.state`` holds the final global row and ``last_tx`` but no
    ``[K, W]`` client rows (the sparse path never builds them).
    ``agg_params`` replaces ``cfg.aggregator.params()`` for one run.

    ``client_data`` is a list of shards or a pre-built
    :class:`DeviceDataStore` (at a million clients a list of datasets is
    not viable); a store must already lie on ``device`` (``None`` means
    the card): it is never copied.  ``train_program`` is a phase-B
    program to use in place of the cached one (a scheme matrix builds one
    for all its lanes).
    """
    device = resolve_device(device)
    store = (_as_store(client_data, device)
             if isinstance(client_data, DeviceDataStore) else None)
    if opt is None:
        # a value token for the default optimizer: every runner building
        # sgd(cfg.lr) shares one phase-B cache entry
        opt = sgd(cfg.lr)
        opt_token = ("default-sgd", float(cfg.lr))
    else:
        opt_token = (id(opt.init), id(opt.update))
    policy_fn = as_policy_fn(policy)
    if cfg.local_mode != "participants":
        raise ValueError(
            "the sparse path implements local_mode='participants'; "
            "continuous local training is population-shaped by definition — "
            "use the dense engine for it")
    if cfg.data_stream != "client":
        raise ValueError(
            "sparse participation samples minibatches per participant and "
            "needs the per-client stream: set SimConfig(data_stream='client')")
    if cfg.overflow not in ("spill", "error"):
        raise ValueError(f"unknown overflow policy {cfg.overflow!r} "
                         "(expected spill|error)")
    if cfg.eval_mode == "replay":
        raise ValueError(
            "the sparse path evaluates in its round loop; eval_mode='replay' "
            "belongs to the resumable dense path (fl.resume)")
    check_modes(cfg)
    ltap = metrics_active(cfg.metrics, None, parts="ledger")
    ttap = metrics_active(cfg.metrics, cfg.guards, parts="train")
    if store is None:
        store = from_client_datasets(client_data, device=device)
    K = store.num_clients
    data_key = data_stream_key(cfg.seed, device=device)
    test_x = test_ds.x[: cfg.eval_batch].to(device)
    test_y = test_ds.y[: cfg.eval_batch].to(device)
    T = cfg.rounds
    tel = get_telemetry()
    emit_run_manifest("make_sparse_runner", cfg, extra={"num_clients": K})
    phase_a: dict = {}

    def _phase_a(bucket: int, h_rounds, key):
        if bucket not in phase_a:
            phase_a[bucket] = build_participation_program(
                policy_fn, cfg, cell, K, bucket)
        with tel.span("sparse.phase_a", (device,)):
            out = phase_a[bucket](h_rounds, key)
            return out, out[2].n_tx.cpu().numpy()

    def runner(params, h_all, seed: int | None = None,
               agg_params=None) -> SimResult:
        key = jr.PRNGKey(cfg.seed if seed is None else seed, device=device)
        h_rounds = torch.as_tensor(h_all, dtype=torch.float32).to(device).T
        bucket = cfg.participant_bucket or _auto_bucket(policy_fn, h_rounds,
                                                        cfg, K)
        pa, n_tx = _phase_a(bucket, h_rounds, key)
        if (n_tx > bucket).any():
            if cfg.overflow == "error":
                raise RuntimeError(
                    f"participant bucket overflow: round "
                    f"{int(n_tx.argmax())} realized {int(n_tx.max())} "
                    f"transmitters > bucket {bucket} — pass "
                    "SimConfig(participant_bucket=...) with more headroom")
            # spill: regrow toward the dense width (the next power of two
            # times the bucket at or above the realized max, capped at K)
            # and rerun phase A, whose decisions do not depend on the bucket
            grown = max(bucket, 1)
            while grown < int(n_tx.max()):
                grown *= 2
            grown = min(grown, K)
            _warn_spill_once(bucket, grown, int(n_tx.max()))
            bucket = grown
            pa, n_tx = _phase_a(bucket, h_rounds, key)
        last_tx, energy, ptr = pa[:3]
        ms_a = pa[3] if ltap else None
        train = train_program or _cached_train_program(
            _train_cache_key(cfg, opt_token, loss_fn, acc_fn, params,
                             store.x.shape[2:], test_x.shape, bucket),
            lambda: build_sparse_train_program(loss_fn, acc_fn, opt, cfg))
        with tel.span("sparse.train", (device,)):
            with tel.span("sparse.gather", (device,)):
                xb_all, yb_all = gather_participant_rounds(
                    store, data_key, ptr.part_idx, cfg.local_iters,
                    cfg.batch_size)
            with tel.span("sparse.phase_b", (device,)):   # to its readback
                out = train(
                    params, xb_all, yb_all, ptr.valid, ptr.anchor_slot, K,
                    test_x, test_y, ptr.delivered, ptr.corrupt, ptr.stale,
                    ptr.prob, agg_params)
                g_final, (accs, losses, did) = out[:2]
                accs, losses = accs.cpu().numpy(), losses.cpu().numpy()
        ms_b = out[2] if ttap else None

        with tel.span("sparse.densify"):
            # the trace's readbacks and its densification on the host
            # (numpy, O(T·K))
            idx = ptr.part_idx.cpu().numpy()
            val = ptr.valid.cpu().numpy()
            e_p = ptr.e_p.cpu().numpy()
            t_of = np.broadcast_to(np.arange(T)[:, None], idx.shape)
            sel = (t_of[val], idx[val])

            def dense(lanes):
                out = np.zeros((T, K), np.float32)
                out[sel] = lanes.cpu().numpy()[val]
                return out

            parts = np.zeros((T, K), np.float32)
            parts[sel] = 1.0
            e_round = np.zeros((T, K), np.float32)
            e_round[sel] = e_p[val]
            ev = np.where(did.numpy())[0]
            state = FLState(global_params=g_final, client_params=None,
                            anchor_params=None,
                            round=torch.tensor(T, dtype=torch.int32,
                                               device=device),
                            last_tx=last_tx, layout=ParamLayout.of(params))
            return SimResult(
                test_acc=accs[ev],
                test_loss=losses[ev],
                eval_rounds=ev,
                energy_per_client=energy.cpu().numpy(),
                energy_timeline=np.cumsum(e_round.sum(axis=1)),
                participation=parts,
                state=state,
                delivered=dense(ptr.delivered) if cfg.faults is not None
                else None,
                corrupted=dense(ptr.corrupt) if cfg.faults is not None
                else None,
                metrics=metrics_numpy(merge_metrics(ms_a, ms_b)))

    runner.store = store
    return runner


def resolve_participation(cfg, policy_fn, data_path: str,
                          num_clients: int) -> str:
    """``cfg.participation`` as ``"dense"`` or ``"sparse"``.

    ``"auto"`` picks sparse exactly when its preconditions hold: the
    participants-only local mode, a state-free or ledger policy
    (:func:`repro_torch.core.selection.policy_ledger_ok`), the device data
    path and the per-client stream; anything else stays dense.
    ``"sparse"`` raises on an unmet precondition (here for the data path,
    in :func:`make_sparse_runner` for the others) rather than changing the
    semantics quietly.
    """
    del num_clients
    mode = cfg.participation
    if mode not in ("dense", "sparse", "auto"):
        raise ValueError(f"unknown participation {mode!r} "
                         "(expected dense|sparse|auto)")
    ok = (cfg.local_mode == "participants" and policy_ledger_ok(policy_fn)
          and data_path == "device" and cfg.data_stream == "client")
    if mode == "auto":
        return "sparse" if ok else "dense"
    if mode == "sparse" and data_path != "device":
        raise ValueError("sparse participation gathers from the device "
                         f"store; data path {data_path!r} is not supported")
    return mode
