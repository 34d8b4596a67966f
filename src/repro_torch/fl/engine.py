"""Eager FL simulation engine (counterpart of ``repro.fl.engine``, its dense
path on the device data store).

The paper's per-round protocol (§II, Fig. 1) — policy, autonomous Bernoulli
participation, Δ_k forced transmission, bandwidth reservation, energy ledger
(eq. 5), local SGD, masked aggregation (eq. 3), broadcast — runs as a Python
loop over rounds whose tensors all stay on the device; the only readback is
the stacked per-round trace at the end.  PyTorch is eager, so the JAX
package's ``lax.scan`` and host-loop engines collapse into this one loop.

* **PRNG** — participation draws ``uniform(fold_in(PRNGKey(seed), t), (K,))``
  and minibatches come from ``fold_in(data_key, t)`` (``data_stream=
  "round"``) or client by client from ``fold_in(fold_in(data_key, t), k)``
  (``"client"``), bit for bit the JAX streams (:mod:`repro_torch.random`),
  so both packages realize the same masks and train on the same examples.
* **policies** — a ``state_free`` policy is solved once for all rounds (the
  JAX engine's hoisted ``vmap``); any other policy runs each round.
* **evals** — at ``t % eval_every == 0 or t == rounds - 1``.
* **aggregation** — as JAX's ``round_step``: ``aggregator`` set →
  ``scheme_aggregate`` (guards fold in), else active ``guards`` →
  ``guarded_aggregate``, both one K1 launch a round in its weighted mode;
  otherwise ``masked_aggregate``, K1's plain mode.  The scheme weights read
  the staleness ledger before the broadcast and the policy's nominal
  probabilities, from before the aging boost.
* **faults** — with ``cfg.faults`` set, :func:`repro_torch.fl.faults.
  apply_faults` runs after each round's decision on its salted streams: the
  energy ledger takes its retry-inclusive energy, and the *delivered* set
  takes the mask's place in the participants-mode keep, every aggregator,
  the staleness ledger and the broadcast; :func:`~repro_torch.fl.faults.
  corrupt_deltas` poisons the flagged rows before aggregation.  The
  participation masks are the clean run's.

Ported: ``data_path`` ``"device"`` (and ``"auto"``, which resolves to it),
both ``data_stream`` values, every ``participation`` value (``"sparse"``,
and ``"auto"`` where its preconditions hold, dispatch to
:mod:`repro_torch.fl.sparse` as JAX's ``make_runner`` does), both
``local_mode`` values, ``max_staleness``, ``aging_boost``, ``guards``,
``aggregator``, ``faults``, ``participant_bucket`` and ``overflow`` (read
by the sparse runner only).  ``metrics``, ``eval_mode="replay"``,
``checkpoint_every``, ``stream_chunk`` and the ``"stream"`` and
``"prestack"`` data paths raise ``NotImplementedError`` naming the field.

The matrix sweeps (:func:`run_seed_matrix`, :func:`run_scenario_matrix`)
run their lanes one after another through the dense runner, the lanes of
JAX's ``vmap`` of the same program.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from .. import random as jr
from .. import resolve_device
from ..core.channel import CellConfig, rate_nats
from ..core.selection import _schedule_policy, as_policy_fn, online_policy
from ..data.device import (DeviceDataStore, data_stream_key,
                           from_client_datasets, sample_round,
                           sample_round_client_stream)
from ..data.synthetic import Dataset
from ..obs.telemetry import emit_run_manifest, get_telemetry
from ..optim import Optimizer, sgd
from .faults import apply_faults, corrupt_deltas, init_fault_state
from .state import (FLState, broadcast_to_participants, guarded_aggregate,
                    init_fl_state, masked_aggregate, pseudo_gradients,
                    scheme_aggregate)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """The JAX ``SimConfig``'s fields and defaults; see the module docstring
    for which settings this port runs."""

    rounds: int = 50
    local_iters: int = 5          # paper: 5 for MNIST
    batch_size: int = 10          # paper: 10 for MNIST
    lr: float = 0.01              # paper: 0.01
    eval_every: int = 5
    seed: int = 0
    max_staleness: int | None = None   # Δ_k enforcement (None: Bernoulli)
    aging_boost: bool = False          # raise p as staleness → Δ_k
    eval_batch: int = 2048
    data_path: str = "auto"
    stream_chunk: int = 256
    local_mode: str = "continuous"     # or "participants"
    participation: str = "dense"
    participant_bucket: int | None = None
    data_stream: str = "round"
    faults: Any = None        # a repro_torch.fl.faults.FaultConfig
    guards: Any = None        # a repro_torch.fl.faults.GuardConfig
    aggregator: Any = None    # a repro_torch.fl.state.AggregatorConfig
    eval_mode: str = "inscan"
    checkpoint_every: int | None = None
    overflow: str = "spill"
    metrics: Any = None


#: settings ported only in part: field -> the values this port runs
_PORTED = {
    "data_path": ("auto", "device"),
    "eval_mode": ("inscan",),
    "metrics": (None,),
    "checkpoint_every": (None,),
    "stream_chunk": (256,),
}


def check_ported(cfg: SimConfig) -> None:
    """Raise ``NotImplementedError`` naming any setting not ported yet."""
    for field, ok in _PORTED.items():
        value = getattr(cfg, field)
        if not any(value is v or value == v for v in ok):
            raise NotImplementedError(
                f"SimConfig.{field}={value!r} is not ported to repro_torch "
                f"yet (ported: {', '.join(map(repr, ok))})")
    if cfg.local_mode not in ("continuous", "participants"):
        raise ValueError(f"unknown local_mode {cfg.local_mode!r} "
                         "(expected continuous|participants)")


def resolve_data_path(cfg: SimConfig) -> str:
    """``cfg.data_path`` as a path name, checked as JAX's
    ``resolve_data_path`` checks it: ``"auto"`` is ``"device"`` here (the
    port has no stream path), and the per-client stream needs the device
    path."""
    path = "device" if cfg.data_path == "auto" else cfg.data_path
    if path not in ("prestack", "device", "stream"):
        raise ValueError(f"unknown data_path {path!r} "
                         "(expected auto|prestack|device|stream)")
    if cfg.data_stream not in ("round", "client"):
        raise ValueError(f"unknown data_stream {cfg.data_stream!r} "
                         "(expected round|client)")
    if cfg.data_stream == "client" and path != "device":
        raise ValueError(
            "the per-client minibatch stream is defined on the device data "
            f"path only (resolved path: {path!r}); pass data_path='device'")
    return path


class SimResult(NamedTuple):
    test_acc: np.ndarray           # [n_evals]
    test_loss: np.ndarray          # [n_evals]
    eval_rounds: np.ndarray        # [n_evals]
    energy_per_client: np.ndarray  # [K] cumulative Joules
    energy_timeline: np.ndarray    # [rounds] cumulative total energy
    participation: np.ndarray      # [rounds, K] realized decision masks
    state: FLState
    # with cfg.faults set, float32 [rounds, K]: the updates that landed at
    # the server, and those of them that were corrupted; None on clean runs
    delivered: np.ndarray | None = None
    corrupted: np.ndarray | None = None


def grant_forced_bandwidth(w: torch.Tensor, forced: torch.Tensor,
                           num_clients: int) -> torch.Tensor:
    """Staleness-aware bandwidth reservation: a client transmitting only
    because its Δ_k bound expired gets at least an equal 1/K share.  When
    Σw ≤ 1 still holds, non-forced clients keep their optimal slices; only
    when the grant overflows the band do they shrink, proportionally, into
    the room left.  With no forced client this is the identity."""
    forced_f = forced.to(w.dtype)
    granted = torch.where(forced, torch.clamp(w, min=1.0 / num_clients), w)
    g = torch.sum(granted * forced_f)             # requested forced mass
    b = torch.sum(w * (1.0 - forced_f))           # non-forced (optimal) mass
    g_scale = torch.where(g > 1.0, 1.0 / torch.clamp(g, min=1e-30), 1.0)
    room = 1.0 - torch.clamp(g, max=1.0)
    nf_scale = torch.where(b > room, room / torch.clamp(b, min=1e-30), 1.0)
    return torch.where(forced, granted * g_scale, w * nf_scale)


def apply_round_decision(probs: torch.Tensor, w: torch.Tensor, t: int,
                         h_t: torch.Tensor, state: FLState,
                         base_key: torch.Tensor, cfg: SimConfig,
                         cell: CellConfig, num_clients: int):
    """Protocol Steps 3-4 + energy ledger given the round's (probs, w).

    Returns ``(mask, forced, w, e_round)``; the participation draw is
    ``uniform(fold_in(base_key, t), (K,))``.  ``state`` is read only for
    its ledger (``round``, ``last_tx``), and only with ``max_staleness``
    set.  Without it, ``t`` may also be a tensor ``[T]`` of rounds with
    ``probs``, ``w`` and ``h_t`` ``[T, K]``: every round's decision at
    once, each row the one-round result.
    """
    K = num_clients
    probs = probs.to(torch.float32)
    w = w.to(torch.float32)
    if cfg.max_staleness is not None:
        since = state.round - state.last_tx
    if cfg.aging_boost and cfg.max_staleness is not None:
        c = torch.clamp(since.to(torch.float32) / cfg.max_staleness, 0.0, 1.0)
        probs = 1.0 - (1.0 - probs) * (1.0 - c * c)
    u = jr.uniform(jr.fold_in(base_key, t), (K,), device=probs.device)
    mask = (u < probs).to(torch.float32)
    forced = torch.zeros_like(mask, dtype=torch.bool)
    if cfg.max_staleness is not None:
        stale = since >= cfg.max_staleness
        forced = stale & (mask == 0.0)
        mask = torch.maximum(mask, stale.to(torch.float32))
        w = grant_forced_bandwidth(w, forced, K)
    R = rate_nats(w, h_t, cell.tx_power_w, cell.bandwidth_hz,
                  cell.noise_w_per_hz)
    e_round = mask * cell.tx_power_w * cell.model_size_nats \
        / torch.clamp(R, min=1e-30)
    e_round = torch.where(mask > 0.0, e_round, 0.0)
    return mask, forced, w, e_round


def make_local_train(loss_fn: Callable, opt: Optimizer):
    """Local SGD of R clients at once (all K, or a participant bucket):
    ``(flat [R, W], xb [R, L, B, ...], yb [R, L, B], layout) -> flat``.
    ``loss_fn`` takes params stacked over clients and returns the ``[R]``
    per-client mean losses; the gradient of their sum with respect to the
    stacked row is each client's own gradient (JAX's
    ``vmap(grad(loss_fn))``)."""

    def local_train(flat, xb, yb, layout):
        state = opt.init(flat)
        for i in range(xb.shape[1]):
            with torch.enable_grad():
                p = flat.detach().requires_grad_(True)
                loss = loss_fn(layout.unflatten(p), xb[:, i], yb[:, i]).sum()
                (g,) = torch.autograd.grad(loss, p)
            upd, state = opt.update(g, state, flat)
            flat = flat + upd
        return flat

    return local_train


def make_runner(loss_fn: Callable, acc_fn: Callable,
                client_data: Sequence[Dataset] | DeviceDataStore,
                test_ds: Dataset, policy, cell: CellConfig, cfg: SimConfig,
                opt: Optimizer | None = None, device=None) -> Callable:
    """Build the device data store once and return
    ``runner(params, h_all, seed=None) -> SimResult``.

    ``h_all`` is ``[K, rounds]``; ``device=None`` means the card;
    ``client_data`` is a list of shards or a :class:`DeviceDataStore`
    already on ``device``.  Where ``cfg.participation`` resolves to
    ``"sparse"`` (:func:`repro_torch.fl.sparse.resolve_participation`) the
    runner is :func:`repro_torch.fl.sparse.make_sparse_runner`'s, else the
    dense engine's.
    """
    from .sparse import make_sparse_runner, resolve_participation

    policy_fn = as_policy_fn(policy)
    path = resolve_data_path(cfg)
    K = _num_clients(client_data)
    if resolve_participation(cfg, policy_fn, path, K) == "sparse":
        # opt passed as given: the sparse runner keys its phase-B cache on
        # the default optimizer's (kind, lr)
        return make_sparse_runner(loss_fn, acc_fn, client_data, test_ds,
                                  policy_fn, cell, cfg, opt, device=device)
    return _dense_runner(loss_fn, acc_fn, client_data, test_ds, policy_fn,
                         cell, cfg, opt, device=device)


def _num_clients(client_data) -> int:
    return (client_data.num_clients
            if isinstance(client_data, DeviceDataStore) else len(client_data))


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == \
        (b.index if b.index is not None else current)


def _as_store(client_data, device: torch.device) -> DeviceDataStore:
    """A list of shards packed on ``device``, or a store already there
    (never copied)."""
    if not isinstance(client_data, DeviceDataStore):
        return from_client_datasets(client_data, device=device)
    if not _same_device(client_data.x.device, device):
        raise ValueError(f"the data store lies on {client_data.x.device}, "
                         f"the runner on {device}; move it first")
    return client_data


def solve_once(policy, h_all: torch.Tensor):
    """``policy`` as a policy function; a state-free one is solved here,
    once for all rounds of ``h_all: [K, T]``, and replayed: lanes that
    share ``h_all`` then share the solve, with the bits of solving it
    again."""
    fn = as_policy_fn(policy)
    if not getattr(fn, "state_free", False):
        return fn
    T = h_all.shape[1]
    probs, w = fn(torch.arange(T, device=h_all.device), h_all.T, None)
    return _schedule_policy(types.SimpleNamespace(p=probs.T, w=w.T))


def _dense_runner(loss_fn: Callable, acc_fn: Callable, client_data,
                  test_ds: Dataset, policy, cell: CellConfig, cfg: SimConfig,
                  opt: Optimizer | None = None, device=None) -> Callable:
    """The dense engine's ``runner(params, h_all, seed=None,
    fault_params=None, agg_params=None) -> SimResult``.  The two keywords
    replace ``cfg.faults.params()`` and ``cfg.aggregator.params()`` for one
    run: what the matrix sweeps sweep."""
    policy_fn = as_policy_fn(policy)
    resolve_data_path(cfg)
    check_ported(cfg)
    device = resolve_device(device)
    store = _as_store(client_data, device)
    K = store.num_clients
    T = cfg.rounds
    hoist = getattr(policy_fn, "state_free", False)
    faults = cfg.faults
    guards = cfg.guards if cfg.guards is not None and cfg.guards.active \
        else None
    opt = opt or sgd(cfg.lr)
    local_train = make_local_train(loss_fn, opt)
    sample = (sample_round_client_stream if cfg.data_stream == "client"
              else sample_round)
    data_key = data_stream_key(cfg.seed, device=device)
    test_x = test_ds.x[: cfg.eval_batch].to(device)
    test_y = test_ds.y[: cfg.eval_batch].to(device)

    @torch.no_grad()
    def run(params, h_all, seed: int | None = None, fault_params=None,
            agg_params=None) -> tuple[SimResult, np.ndarray]:
        key = jr.PRNGKey(cfg.seed if seed is None else seed, device=device)
        h_rounds = torch.as_tensor(h_all, dtype=torch.float32).to(device).T
        state = init_fl_state(params, K, device=device)
        layout = state.layout
        ap = None
        if cfg.aggregator is not None:
            ap = (cfg.aggregator.params(device) if agg_params is None
                  else agg_params)
        if faults is not None:
            fp = faults.params(device) if fault_params is None \
                else fault_params
            fstate = init_fault_state(K, device)
        if hoist:   # every round's policy (the (P1') solves) at once
            probs_all, w_all = policy_fn(torch.arange(T, device=device),
                                         h_rounds, None)
        energy = torch.zeros(K, dtype=torch.float32, device=device)
        masks, e_rounds, accs, losses, eval_rounds = [], [], [], [], []
        delivers, corrupts = [], []
        for t in range(T):
            h_t = h_rounds[t]
            probs, w = ((probs_all[t], w_all[t]) if hoist
                        else policy_fn(t, h_t, state))
            mask, _, w, e_round = apply_round_decision(
                probs, w, t, h_t, state, key, cfg, cell, K)
            delivered = mask
            if faults is not None:   # what lands, on the salted streams
                out, fstate = apply_faults(t, key, mask, e_round, fstate,
                                           fp, faults)
                delivered, e_round = out.delivered, out.e_round
                delivers.append(delivered)
                corrupts.append(out.corrupt)
            energy = energy + e_round
            xb, yb = sample(store, data_key, t, cfg.local_iters,
                            cfg.batch_size)
            client = local_train(state.client_params, xb, yb, layout)
            if cfg.local_mode == "participants":
                # only clients whose update lands move; the rest keep
                # client == anchor, so their pseudo-gradient stays zero
                client = torch.where(delivered.bool()[:, None], client,
                                     state.client_params)
            state = state._replace(client_params=client)
            deltas = pseudo_gradients(state)
            if faults is not None:
                deltas = corrupt_deltas(deltas, out.corrupt, fp, faults)
            if ap is not None or guards is not None:
                staleness = state.round - state.last_tx
            if ap is not None:   # probs: nominal, before the aging boost
                new_global = scheme_aggregate(
                    state.global_params, deltas, delivered, K, staleness,
                    probs, ap, guards=guards)
            elif guards is not None:
                new_global = guarded_aggregate(state.global_params, deltas,
                                               delivered, K, staleness,
                                               guards)
            else:
                new_global = masked_aggregate(state.global_params, deltas,
                                              delivered, K)
            state = broadcast_to_participants(state, new_global, delivered)
            if t % cfg.eval_every == 0 or t == T - 1:
                g = layout.unflatten(state.global_params)
                accs.append(acc_fn(g, test_x, test_y))
                losses.append(loss_fn(g, test_x, test_y))
                eval_rounds.append(t)
            masks.append(mask)
            e_rounds.append(e_round)
        e_round_all = torch.stack(e_rounds).cpu().numpy()

        def trace(rows):
            return (torch.stack(rows).to(torch.float32).cpu().numpy()
                    if faults is not None else None)

        return SimResult(
            test_acc=torch.stack(accs).cpu().numpy(),
            test_loss=torch.stack(losses).cpu().numpy(),
            eval_rounds=np.asarray(eval_rounds),
            energy_per_client=energy.cpu().numpy(),
            energy_timeline=np.cumsum(e_round_all.sum(axis=1)),
            participation=torch.stack(masks).cpu().numpy(),
            state=state, delivered=trace(delivers),
            corrupted=trace(corrupts)), e_round_all

    def runner(params, h_all, seed: int | None = None, fault_params=None,
               agg_params=None) -> SimResult:
        return run(params, h_all, seed, fault_params, agg_params)[0]

    # the run with its per-round energy [T, K] beside it (the matrices')
    runner.with_e_round = run
    return runner


# ---------------------------------------------------------------------------
# scenario fan-out: lanes over seeds and ρ
# ---------------------------------------------------------------------------


class MatrixResult(NamedTuple):
    """Stacked lane results; leading axes ``[R, S, ...]`` for
    :func:`run_scenario_matrix`, ``[S, ...]`` for :func:`run_seed_matrix`."""

    acc: np.ndarray            # [..., n_evals]
    loss: np.ndarray           # [..., n_evals]
    eval_rounds: np.ndarray    # [n_evals]
    energy: np.ndarray         # [..., K] cumulative per-client Joules
    e_round: np.ndarray        # [..., T, K]
    participation: np.ndarray  # [..., T, K]
    metrics: Any = None        # the metrics taps are not ported: None


def _matrix_result(lanes: list, shape: tuple) -> MatrixResult:
    """Stack ``(SimResult, e_round)`` lanes, lane-major, under the leading
    axes ``shape``."""
    def stack(rows):
        a = np.stack(rows)
        return a.reshape(shape + a.shape[1:])

    return MatrixResult(
        acc=stack([r.test_acc for r, _ in lanes]),
        loss=stack([r.test_loss for r, _ in lanes]),
        eval_rounds=lanes[0][0].eval_rounds,
        energy=stack([r.energy_per_client for r, _ in lanes]),
        e_round=stack([e for _, e in lanes]),
        participation=stack([r.participation for r, _ in lanes]))


def _lanes_check(h_stack, seeds, cfg: SimConfig) -> torch.Tensor:
    h = torch.as_tensor(h_stack, dtype=torch.float32)
    if h.dim() != 3 or h.shape[0] != len(seeds):
        raise ValueError(f"h_stack must be [S, K, T] with one lane per "
                         f"seed: {tuple(h.shape)} for {len(seeds)} seeds")
    if h.shape[2] != cfg.rounds:
        raise ValueError(f"h_stack has {h.shape[2]} rounds, "
                         f"cfg.rounds={cfg.rounds}")
    return h


def run_seed_matrix(init_params, loss_fn, acc_fn, client_data, test_ds,
                    policy, h_stack, cell: CellConfig, cfg: SimConfig,
                    seeds: Sequence[int], opt: Optimizer | None = None,
                    device=None) -> MatrixResult:
    """One policy over scenario lanes: ``h_stack [S, K, T]`` holds one
    channel realization a lane, ``seeds`` each lane's participation stream.
    The data (one store) and its minibatch stream (``cfg.seed``) are shared
    by every lane.  Each lane is one run of the dense engine on ``device``
    (``None`` means the card); leading axis ``[S]``."""
    device = resolve_device(device)
    h = _lanes_check(h_stack, seeds, cfg)
    store = _as_store(client_data, device)
    runner = _dense_runner(loss_fn, acc_fn, store, test_ds, policy, cell,
                           cfg, opt, device=device)
    emit_run_manifest("run_seed_matrix", cfg,
                      extra={"lanes": len(seeds),
                             "num_clients": store.num_clients})
    with get_telemetry().span("seed_matrix.execute"):
        lanes = [runner.with_e_round(init_params, h[s], seed=int(seed))
                 for s, seed in enumerate(seeds)]
    return _matrix_result(lanes, (len(seeds),))


def run_scenario_matrix(init_params, loss_fn, acc_fn, client_data, test_ds,
                        spec, h_stack, rhos: Sequence[float],
                        cfg: SimConfig, seeds: Sequence[int],
                        opt: Optimizer | None = None,
                        device=None) -> MatrixResult:
    """ρ × lane sweep of the paper's online scheme: lane ``(r, s)`` runs
    ``online_policy(spec, rho=rhos[r])`` (ρ as a float32 tensor, as JAX
    traces it) on ``h_stack[s]`` with participation seed ``seeds[s]``;
    leading axes ``[R, S]``.  Sweep K by calling once per client count."""
    check_ported(cfg)
    device = resolve_device(device)
    h = _lanes_check(h_stack, seeds, cfg)
    store = _as_store(client_data, device)
    emit_run_manifest("run_scenario_matrix", cfg,
                      extra={"rhos": len(rhos), "lanes": len(seeds),
                             "num_clients": store.num_clients})
    lanes = []
    with get_telemetry().span("scenario_matrix.execute"):
        for rho in rhos:
            rho_t = torch.tensor(float(rho), dtype=torch.float32,
                                 device=device)
            runner = _dense_runner(loss_fn, acc_fn, store, test_ds,
                                   online_policy(spec, rho=rho_t),
                                   spec.cell, cfg, opt, device=device)
            lanes += [runner.with_e_round(init_params, h[s], seed=int(seed))
                      for s, seed in enumerate(seeds)]
    return _matrix_result(lanes, (len(rhos), len(seeds)))
