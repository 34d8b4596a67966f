"""Eager FL simulation engine (counterpart of ``repro.fl.engine``).

The paper's per-round protocol (§II, Fig. 1) — policy, autonomous Bernoulli
participation, Δ_k forced transmission, bandwidth reservation, energy ledger
(eq. 5), local SGD, masked aggregation (eq. 3), broadcast — is one round
transition over an explicit carry ``(FLState, energy[, FaultState])``
(:func:`init_carry`), applied round after round over *absolute* round ids
by :func:`build_chunk_sim`.  Its tensors all stay on the device; the only
readback is the stacked per-round trace (:class:`RoundTrace`).  PyTorch is
eager, so the JAX package's ``lax.scan`` over a chunk is a Python loop, and
the single-run engine, the stream runner and the resumable runner
(:mod:`repro_torch.fl.resume`) all run the same transition: chunking
changes no bit.

* **PRNG** — participation draws ``uniform(fold_in(PRNGKey(seed), t), (K,))``
  and minibatches come from ``fold_in(data_key, t)`` (``data_stream=
  "round"``) or client by client from ``fold_in(fold_in(data_key, t), k)``
  (``"client"``), bit for bit the JAX streams (:mod:`repro_torch.random`),
  so both packages realize the same masks and train on the same examples.
  A chunk makes its round keys once, ``[C, 2]`` tables on the device
  (:func:`~repro_torch.random.fold_in_range`), and each round indexes
  them: no round copies a number to the card or waits for it, so the host
  enqueues rounds ahead of the card until the run's readback.
* **data paths** — ``"device"``: a :class:`DeviceDataStore` on the device,
  each round gathered from it; ``"prestack"``: every round's batches drawn
  up front by the per-client host iterators (:func:`stack_round_batches`);
  ``"stream"``: the store's blocks on the host, round chunks gathered there
  and copied ahead of use (:class:`~repro_torch.data.device.
  StreamingSampler`, ``stream_chunk`` rounds a chunk).  ``"auto"`` picks
  ``"device"`` or ``"stream"`` by the store's footprint
  (:func:`resolve_data_path`).
* **policies** — a ``state_free`` policy is solved once for all rounds (the
  JAX engine's hoisted ``vmap``); any other policy runs each round.
* **evals** — at ``t % eval_every == 0 or t == rounds - 1`` with
  ``eval_mode="inscan"``; ``"replay"`` evaluates nothing in the loop (the
  resumable runner evaluates its segment checkpoints afterwards).
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
* **metrics taps** — with ``cfg.metrics`` enabling any tap
  (:mod:`repro_torch.obs.taps`), the :class:`~repro_torch.obs.taps.
  MetricsState` rides last in the carry and each round updates it from the
  decision, the decision energy before the fault pipeline, the delivered
  set, the staleness ledger before the broadcast, the corrupted deltas and
  the aggregation weights; ``SimResult.metrics`` holds it as numpy arrays.
  Taps only read: a tapped run is the untapped run bit for bit.
* **client-axis placement** — JAX's ``shard_clients``: with several cards
  visible :func:`make_runner` places the dense engine's client axis over
  d of them (:func:`_client_mesh`, :mod:`repro_torch.fl.placement`) on
  the device and prestack paths.  The client and anchor rows, local SGD,
  eq. 2 and the broadcast then run a block of K/d rows a card, eq. 3 is
  one K1 launch a card (its partial rows added on the first card), and
  the decision, ledgers, taps and eval stay on the first card.  The
  stream, sparse, matrix, resumable and legacy runs are never placed, as
  in JAX.
* **spans** — a run of the dense or stream runner is an
  ``engine.execute`` span (through its readback), and each round four
  spans under it: ``round.data`` (the batches: the index draw and, placed,
  its slices and each block's gather), ``round.decision`` (the policy when
  not hoisted, the decision, the fault pipeline, the energy ledger, on the
  first card), ``round.local_sgd`` (local SGD, the participants-mode keep,
  eq. 2, the corruption) and ``round.server`` (eq. 3 with its partial sums
  when placed, the taps, the broadcast, the strided eval).  While a
  profiler records they are timed on the run's cards too
  (:mod:`repro_torch.obs.telemetry`).

Every ``SimConfig`` setting is ported.  ``participation`` ``"sparse"``
(and ``"auto"`` where its preconditions hold) dispatches to
:mod:`repro_torch.fl.sparse` as JAX's ``make_runner`` does.

The matrix sweeps (:func:`run_seed_matrix`, :func:`run_scenario_matrix`)
run their lanes one after another through the dense runner, the lanes of
JAX's ``vmap`` of the same program; a resolved ``"stream"`` path runs on
the device store there, as in JAX.
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
from ..data.device import (DeviceDataStore, StreamingSampler,
                           choose_data_path, data_stream_key,
                           from_client_datasets, gather_round,
                           round_key_indices)
from ..data.pipeline import BatchIterator, client_batches
from ..data.synthetic import Dataset
from ..obs.taps import (init_metrics, metrics_active, metrics_numpy,
                        metrics_round_update, stack_metrics)
from ..obs.telemetry import emit_run_manifest, get_telemetry
from ..optim import Optimizer, sgd
from .faults import apply_faults, corrupt_deltas, init_fault_state
from .placement import ClientPlacement, PlacedStore
from .state import (FLState, RowBlocks, broadcast_to_participants,
                    guarded_aggregate, init_fl_state, masked_aggregate,
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
    metrics: Any = None       # a repro_torch.obs.taps.MetricsSpec


def check_modes(cfg: SimConfig) -> None:
    """Raise ``ValueError`` on an unknown ``local_mode`` or ``eval_mode``
    before anything is built."""
    if cfg.local_mode not in ("continuous", "participants"):
        raise ValueError(f"unknown local_mode {cfg.local_mode!r} "
                         "(expected continuous|participants)")
    if cfg.eval_mode not in ("inscan", "replay"):
        raise ValueError(f"unknown eval_mode {cfg.eval_mode!r} "
                         "(expected inscan|replay)")


def resolve_data_path(client_data, cfg: SimConfig,
                      override: str | None = None,
                      budget_bytes: int | None = None, device=None) -> str:
    """``cfg.data_path`` (or ``override``) as a path name.

    ``"auto"`` asks :func:`repro_torch.data.device.choose_data_path`: the
    padded store's footprint (``client_data`` is a list of shards or a
    built store) against ``budget_bytes``, by default the memory of
    ``device`` (``None`` means the card); explicit names pass through.  The
    per-client stream needs the device path, as in JAX."""
    path = override or cfg.data_path
    if path == "auto":
        path = choose_data_path(client_data, budget_bytes, device)
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


def _shards(client_data, path: str):
    """The shard list the host paths read; a built store has none."""
    if isinstance(client_data, DeviceDataStore):
        raise ValueError(
            f"the {path!r} data path reads the client shards on the host; a "
            "DeviceDataStore has none — pass the list of shards, or "
            "data_path='device'")
    return client_data


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
    # with cfg.metrics enabling taps, a repro_torch.obs.taps.MetricsState of
    # numpy arrays (feed metrics_summary); None otherwise
    metrics: Any = None


class RoundTrace(NamedTuple):
    """Per-round outputs of a chunk, stacked over its C rounds.

    ``delivered``/``corrupt`` are ``mask`` and zeros when faults are off;
    ``acc``/``loss`` are 0 where ``did_eval`` (a host bool array) is
    False."""

    mask: torch.Tensor       # [C, K] realized participation (the decision)
    e_round: torch.Tensor    # [C, K] Joules spent (retries included)
    acc: torch.Tensor        # [C]
    loss: torch.Tensor       # [C]
    did_eval: np.ndarray     # [C] bool
    delivered: torch.Tensor  # [C, K] updates that landed at the server
    corrupt: torch.Tensor    # [C, K] bool, delivered but poisoned


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


def apply_round_decision(probs: torch.Tensor, w: torch.Tensor,
                         round_key: torch.Tensor, h_t: torch.Tensor,
                         state: FLState, cfg: SimConfig, cell: CellConfig,
                         num_clients: int):
    """Protocol Steps 3-4 + energy ledger given the round's (probs, w).

    Returns ``(mask, forced, w, e_round)``; the participation draw is
    ``uniform(round_key, (K,))``, ``round_key = fold_in(base_key, t)``.
    ``state`` is read only for its ledger (``round``, ``last_tx``), and
    only with ``max_staleness`` set.  Without it, ``round_key`` may also be
    ``[T, 2]``, every round's key, with ``probs``, ``w`` and ``h_t`` ``[T,
    K]``: every round's decision at once, each row the one-round result.
    """
    K = num_clients
    probs = probs.to(torch.float32)
    w = w.to(torch.float32)
    if cfg.max_staleness is not None:
        since = state.round - state.last_tx
    if cfg.aging_boost and cfg.max_staleness is not None:
        c = torch.clamp(since.to(torch.float32) / cfg.max_staleness, 0.0, 1.0)
        probs = 1.0 - (1.0 - probs) * (1.0 - c * c)
    u = jr.uniform(round_key, (K,), device=probs.device)
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


def round_decision(policy_fn: Callable, t: int, h_t: torch.Tensor,
                   state: FLState, base_key: torch.Tensor, cfg: SimConfig,
                   cell: CellConfig, num_clients: int):
    """Protocol Steps 2-4 for one round: policy then
    :func:`apply_round_decision` (the legacy host loop's per-round path)."""
    probs, w = policy_fn(t, h_t, state)
    return apply_round_decision(probs, w, jr.fold_in(base_key, t), h_t, state,
                                cfg, cell, num_clients)


def _client_mesh(num_clients: int, device=None) -> ClientPlacement | None:
    """JAX's rule: the client axis over the largest divisor d of K no
    larger than the visible cards, as a :class:`~repro_torch.fl.placement.
    ClientPlacement` over d cards, ``device``'s first; ``None`` when d is 1
    (one card, a CPU device, or a K with no such divisor above 1)."""
    device = resolve_device(device)
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n <= 1:
        return None
    d = max(i for i in range(1, min(n, num_clients) + 1)
            if num_clients % i == 0)
    if d <= 1:
        return None
    return ClientPlacement.over_cards(device, d, num_clients)


def make_local_train(loss_fn: Callable, opt: Optimizer):
    """Local SGD of R clients at once (all K, or a participant bucket):
    ``(flat [R, W], xb [R, L, B, ...], yb [R, L, B], layout) -> flat``.
    ``loss_fn`` takes params stacked over clients and returns the ``[R]``
    per-client mean losses; the gradient of their sum with respect to the
    stacked row is each client's own gradient (JAX's
    ``vmap(grad(loss_fn))``).

    Two routes, counted per call in the telemetry: where the loss declares
    a fused trainer (``loss_fn.fused_sgd``, the MLP's), the optimizer is
    plain SGD (``opt.lr`` set), there is a step to take, the rows are
    CUDA float32 and the trainer takes their layout, the whole call is one
    kernel launch (``local_sgd.kernel``), on contiguous inputs and int32
    labels, and raises on what the kernel cannot take (a batch past 32);
    everything else — the CNN, momentum, Adam, CPU rows, ``local_iters``
    0 — runs the autograd loop (``local_sgd.autograd``)."""
    fused = getattr(loss_fn, "fused_sgd", None)

    def autograd_train(flat, xb, yb, layout):
        get_telemetry().inc("local_sgd.autograd")
        state = opt.init(flat)
        for i in range(xb.shape[1]):
            with torch.enable_grad():
                p = flat.detach().requires_grad_(True)
                loss = loss_fn(layout.unflatten(p), xb[:, i], yb[:, i]).sum()
                (g,) = torch.autograd.grad(loss, p)
            upd, state = opt.update(g, state, flat)
            flat = flat + upd
        return flat

    if fused is None or opt.lr is None:
        return autograd_train

    def local_train(flat, xb, yb, layout):
        if (xb.shape[1] == 0 or not flat.is_cuda
                or flat.dtype != torch.float32 or not fused.takes(layout)):
            return autograd_train(flat, xb, yb, layout)
        get_telemetry().inc("local_sgd.kernel")
        return fused.run(flat.contiguous(), xb.contiguous(),
                         yb.to(torch.int32).contiguous(), opt.lr, layout)

    return local_train


def empty_client_batches(client_data: Sequence[Dataset], cfg: SimConfig):
    """``[K, 0, B, ...]`` placeholder pair for protocol-only runs
    (``local_iters=0``): local training is a no-op, clients never move."""
    sample = tuple(client_data[0].x.shape[1:])
    b = min(cfg.batch_size, min(len(c.y) for c in client_data))
    return (torch.zeros((len(client_data), 0, b) + sample),
            torch.zeros((len(client_data), 0, b), dtype=torch.int32))


def stack_round_batches(client_data: Sequence[Dataset], cfg: SimConfig,
                        device=None):
    """Every round's batches, drawn up front by the per-client host
    iterators (``BatchIterator(seed=cfg.seed + 17k)``, round-major, local
    step minor): ``([T, K, L, B, ...], [T, K, L, B])`` on ``device``
    (``None`` means the card), bit for bit JAX's prestack batches.  The
    footprint grows with T: T·K·L·B·784 float32 is 125 MB at (T 50, K 16,
    L 5, B 10)."""
    device = resolve_device(device)
    if cfg.local_iters == 0:
        xb, yb = empty_client_batches(client_data, cfg)
        return (xb.expand((cfg.rounds,) + xb.shape).to(device),
                yb.expand((cfg.rounds,) + yb.shape).to(device))
    iters = [BatchIterator(ds, cfg.batch_size, seed=cfg.seed + 17 * k)
             for k, ds in enumerate(client_data)]
    xs, ys = [], []
    for _ in range(cfg.rounds):
        step = [client_batches(iters) for _ in range(cfg.local_iters)]
        xs.append(torch.stack([x for x, _ in step], dim=1))  # [K, L, B, ..]
        ys.append(torch.stack([y for _, y in step], dim=1))
    return torch.stack(xs).to(device), torch.stack(ys).to(device)


def init_carry(params, num_clients: int, cfg: SimConfig, device=None,
               placement: ClientPlacement | None = None):
    """The round transition's carry: ``(FLState, energy [K])``, plus the
    per-client :class:`~repro_torch.fl.faults.FaultState` with faults on,
    plus the :class:`~repro_torch.obs.taps.MetricsState`, last, when
    ``cfg.metrics`` enables a tap; on ``device`` (``None`` means the
    card), the client and anchor rows over ``placement``'s devices when
    one is given."""
    device = resolve_device(device)
    carry = (init_fl_state(params, num_clients, device=device,
                           devices=None if placement is None
                           else placement.devices),
             torch.zeros(num_clients, dtype=torch.float32, device=device))
    if cfg.faults is not None:
        carry = carry + (init_fault_state(num_clients, device),)
    ms = init_metrics(cfg.metrics, num_clients, cfg.guards, device=device)
    if ms is not None:
        carry = carry + (ms,)
    return carry


def _make_round_step(local_train: Callable, loss_fn: Callable,
                     acc_fn: Callable, cfg: SimConfig, cell: CellConfig,
                     num_clients: int, policy_fn):
    """The round transition every execution mode shares: protocol Steps
    1-5, the fault pipeline, the energy ledger, the aggregators and the
    strided eval and the metrics taps.  ``round_step(carry, t, round_key,
    h_t, xb, yb, pw, base_key, test_x, test_y, fp, ap) -> (carry, (mask,
    e_round, acc, loss, did_eval, delivered, corrupt))`` for the absolute
    round ``t``, whose key ``fold_in(base_key, t)`` is ``round_key``;
    ``pw`` is the hoisted ``(probs, w)`` of the round, or ``None`` to ask
    the policy.  With the client rows placed (:class:`~repro_torch.fl.
    state.RowBlocks`, ``xb`` and ``yb`` too) the row-wise work runs a block
    at a time on its device, the ``[K]`` vectors cut to its rows."""
    K = num_clients
    faults = cfg.faults
    guards = cfg.guards if cfg.guards is not None and cfg.guards.active \
        else None
    tapped = metrics_active(cfg.metrics, guards)
    check_modes(cfg)
    tel = get_telemetry()

    def train_rows(client0, anchor, xb, yb, layout, delivered, corrupt, fp):
        """Local SGD, the participants-mode keep, eq. 2 and the corruption
        of the rows ``client0`` (anchors ``anchor``): ``(client,
        deltas)``."""
        client = local_train(client0, xb, yb, layout)
        if cfg.local_mode == "participants":
            # only clients whose update lands move; the rest keep
            # client == anchor, so their pseudo-gradient stays zero
            client = torch.where(delivered.bool()[:, None], client, client0)
        deltas = client - anchor       # eq. 2 (pseudo_gradients)
        if faults is not None:
            deltas = corrupt_deltas(deltas, corrupt, fp, faults)
        return client, deltas

    def round_step(carry, t, round_key, h_t, xb, yb, pw, base_key, test_x,
                   test_y, fp=None, ap=None):
        state, energy = carry[0], carry[1]
        devices = _run_devices(carry)
        with tel.span("round.decision", devices[:1]):
            probs, w = pw if pw is not None else policy_fn(t, h_t, state)
            mask, forced, w, e_round = apply_round_decision(
                probs, w, round_key, h_t, state, cfg, cell, K)
            e_base = e_round   # the decision energy, before the faults
            delivered, corrupt = mask, None
            if faults is not None:   # what lands, on the salted streams
                out, fstate = apply_faults(t, base_key, mask, e_round,
                                           carry[2], fp, faults)
                delivered, corrupt, e_round = out.delivered, out.corrupt, \
                    out.e_round
            energy = energy + e_round
        layout = state.layout
        rows = state.client_params
        with tel.span("round.local_sgd", devices):
            if isinstance(rows, RowBlocks):
                bad = (rows.slices(corrupt) if corrupt is not None
                       else [None] * len(rows))
                legs = [train_rows(c, a, x, y, layout, dv, cr,
                                   _params_on(fp, c.device))
                        for c, a, x, y, dv, cr in zip(
                            rows, state.anchor_params, xb, yb,
                            rows.slices(delivered), bad)]
                client = RowBlocks(c for c, _ in legs)
                deltas = RowBlocks(d for _, d in legs)
            else:
                client, deltas = train_rows(rows, state.anchor_params, xb,
                                            yb, layout, delivered, corrupt,
                                            fp)
        state = state._replace(client_params=client)
        with tel.span("round.server", devices):
            if ap is not None or guards is not None or tapped:
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
            if tapped:
                mstate = metrics_round_update(
                    carry[-1], cfg.metrics, mask=mask, forced=forced,
                    e_base=e_base, e_round=e_round, staleness=staleness,
                    delivered=delivered, deltas=deltas, probs=probs,
                    num_clients=K, guards=guards, agg_params=ap)
            state = broadcast_to_participants(state, new_global, delivered)
            did = cfg.eval_mode == "inscan" and (t % cfg.eval_every == 0
                                                 or t == cfg.rounds - 1)
            acc = loss = None
            if did:
                g = layout.unflatten(state.global_params)
                acc = acc_fn(g, test_x, test_y).to(torch.float32)
                loss = loss_fn(g, test_x, test_y).to(torch.float32)
        carry = (state, energy) + ((fstate,) if faults is not None else ()) \
            + ((mstate,) if tapped else ())
        return carry, (mask, e_round, acc, loss, did, delivered, corrupt)

    return round_step


def _run_devices(carry) -> tuple:
    """The devices a run's carry lies on: each row block's, or the one
    device of an unplaced run; the first holds the decision."""
    rows = carry[0].client_params
    if isinstance(rows, RowBlocks):
        return tuple(b.device for b in rows)
    return (carry[1].device,)


def _params_on(params, device):
    """A ``NamedTuple`` of tensors (fault parameters) on ``device``."""
    if params is None:
        return None
    return type(params)(*(v.to(device) for v in params))


def _stack_trace(rows: list, device) -> RoundTrace:
    """One chunk's per-round outputs as a :class:`RoundTrace`."""
    mask, e_round, acc, loss, did, delivered, corrupt = zip(*rows)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    masks = torch.stack(mask)
    return RoundTrace(
        mask=masks, e_round=torch.stack(e_round),
        acc=torch.stack([zero if a is None else a for a in acc]),
        loss=torch.stack([zero if v is None else v for v in loss]),
        did_eval=np.asarray(did, dtype=bool),
        delivered=(masks if delivered[0] is mask[0]
                   else torch.stack(delivered)),
        corrupt=(torch.zeros_like(masks, dtype=torch.bool)
                 if corrupt[0] is None else torch.stack(corrupt)))


def concat_traces(traces: Sequence[RoundTrace]) -> RoundTrace:
    """Chunks' traces joined along the round axis."""
    return RoundTrace(*[
        np.concatenate(xs) if isinstance(xs[0], np.ndarray)
        else torch.cat(xs) for xs in zip(*traces)])


def build_chunk_sim(loss_fn: Callable, acc_fn: Callable, opt: Optimizer,
                    cfg: SimConfig, cell: CellConfig, num_clients: int,
                    policy_fn, data_mode: str = "prestack"):
    """The round transition over one chunk of rounds with an explicit carry
    (:func:`init_carry`), JAX's ``build_chunk_sim``.

    ``data_mode="prestack"``: ``chunk(carry, ts, h, xb, yb, pw, base_key,
    test_x, test_y, fault_params=None, agg_params=None)`` with chunk-major
    batches ``[C, K, L, B, ...]``; ``data_mode="device"``: ``chunk(carry,
    ts, h, pw, store, data_key, base_key, test_x, test_y,
    fault_params=None, agg_params=None)`` gathers each round from the
    store.  ``ts`` is the range of absolute round ids (so the ``fold_in``
    streams and the eval stride are a single run's), ``h`` their ``[C,
    K]`` gains and ``pw`` their hoisted ``(probs, w)`` ``[C, K]`` each, or
    ``None`` for a policy asked round by round.  Returns ``(carry,
    RoundTrace)``; ``chunk.hoist`` says whether the policy is hoisted.  A
    placed run (:func:`init_carry` with a placement) takes its batches as
    :class:`~repro_torch.fl.state.RowBlocks` of ``[C, K/d, ...]`` blocks,
    or a :class:`~repro_torch.fl.placement.PlacedStore`.
    """
    policy_fn = as_policy_fn(policy_fn)
    round_step = _make_round_step(make_local_train(loss_fn, opt), loss_fn,
                                  acc_fn, cfg, cell, num_clients, policy_fn)
    if data_mode not in ("prestack", "device"):
        raise ValueError(f"unknown data_mode {data_mode!r}")
    tel = get_telemetry()

    def run(carry, ts, h, batches, pw, base_key, test_x, test_y,
            fault_params, agg_params):
        device = carry[1].device
        fp = ap = None
        if cfg.faults is not None:
            fp = (cfg.faults.params(device) if fault_params is None
                  else fault_params)
        if cfg.aggregator is not None:
            ap = (cfg.aggregator.params(device) if agg_params is None
                  else agg_params)
        rows = []
        devices = _run_devices(carry)
        round_keys = jr.fold_in_range(base_key, ts)
        for i, t in enumerate(ts):
            with tel.span("round.data", devices):
                xb, yb = batches(i)
            carry, row = round_step(
                carry, t, round_keys[i], h[i], xb, yb,
                None if pw is None else (pw[0][i], pw[1][i]), base_key,
                test_x, test_y, fp, ap)
            rows.append(row)
        return carry, _stack_trace(rows, device)

    if data_mode == "prestack":
        def chunk(carry, ts, h, xb, yb, pw, base_key, test_x, test_y,
                  fault_params=None, agg_params=None):
            def batches(i):
                if isinstance(xb, RowBlocks):
                    return (RowBlocks(b[i] for b in xb),
                            RowBlocks(b[i] for b in yb))
                return xb[i], yb[i]

            return run(carry, ts, h, batches, pw, base_key, test_x, test_y,
                       fault_params, agg_params)
    else:
        def chunk(carry, ts, h, pw, store, data_key, base_key, test_x,
                  test_y, fault_params=None, agg_params=None):
            data_keys = jr.fold_in_range(data_key, ts)

            def batches(i):
                if isinstance(store, PlacedStore):
                    return store.sample(data_keys[i], cfg.local_iters,
                                        cfg.batch_size, cfg.data_stream)
                return gather_round(store, round_key_indices(
                    data_keys[i], store.lengths, cfg.local_iters,
                    cfg.batch_size, cfg.data_stream))

            return run(carry, ts, h, batches, pw, base_key, test_x, test_y,
                       fault_params, agg_params)

    chunk.hoist = getattr(policy_fn, "state_free", False)
    return chunk


def hoisted_policy(policy_fn, h_rounds: torch.Tensor):
    """Every round's ``(probs, w)`` ``[T, K]`` of a state-free policy at
    once (the (P1') solves batched), or ``None`` for any other policy."""
    if not getattr(policy_fn, "state_free", False):
        return None
    T = h_rounds.shape[0]
    return policy_fn(torch.arange(T, device=h_rounds.device), h_rounds, None)


def _to_result(carry, trace: RoundTrace, cfg: SimConfig) -> SimResult:
    """The end-of-run readback: a :class:`SimResult` from the final carry
    and the whole run's trace."""
    idx = np.where(trace.did_eval)[0]
    e_round = trace.e_round.cpu().numpy()
    faulty = cfg.faults is not None
    tapped = metrics_active(cfg.metrics, cfg.guards)
    return SimResult(
        test_acc=trace.acc.cpu().numpy()[idx],
        test_loss=trace.loss.cpu().numpy()[idx],
        eval_rounds=idx,
        energy_per_client=carry[1].cpu().numpy(),
        energy_timeline=np.cumsum(e_round.sum(axis=1)),
        participation=trace.mask.cpu().numpy(),
        state=carry[0],
        delivered=(trace.delivered.to(torch.float32).cpu().numpy()
                   if faulty else None),
        corrupted=(trace.corrupt.to(torch.float32).cpu().numpy()
                   if faulty else None),
        metrics=metrics_numpy(carry[-1]) if tapped else None)


def make_runner(loss_fn: Callable, acc_fn: Callable,
                client_data: Sequence[Dataset] | DeviceDataStore,
                test_ds: Dataset, policy, cell: CellConfig, cfg: SimConfig,
                opt: Optimizer | None = None, device=None,
                data_path: str | None = None,
                data_budget_bytes: int | None = None,
                shard_clients: bool | None = None) -> Callable:
    """Build the data source once and return ``runner(params, h_all,
    seed=None) -> SimResult``.

    ``h_all`` is ``[K, rounds]``; ``device=None`` means the card;
    ``client_data`` is a list of shards or a :class:`DeviceDataStore`
    already on ``device`` (the device path only).  ``data_path`` overrides
    ``cfg.data_path``; ``"auto"`` resolves by footprint against
    ``data_budget_bytes`` (default: the device's memory).  Where
    ``cfg.participation`` resolves to ``"sparse"``
    (:func:`repro_torch.fl.sparse.resolve_participation`) the runner is
    :func:`repro_torch.fl.sparse.make_sparse_runner`'s; on the stream path
    it is the stream runner; else the dense engine's.  The dense and
    stream runners emit the ``"make_runner"`` manifest, the sparse one
    ``"make_sparse_runner"``.  ``shard_clients`` (default ``None``, auto,
    the same as ``True``) places the dense engine's client axis over the
    visible cards by JAX's rule (:func:`_client_mesh`) on the device and
    prestack paths; with one card it changes nothing; ``False`` never
    places.  The stream and sparse runners ignore it, as JAX's do.
    """
    from .sparse import make_sparse_runner, resolve_participation

    policy_fn = as_policy_fn(policy)
    path = resolve_data_path(client_data, cfg, data_path, data_budget_bytes,
                             device)
    K = _num_clients(client_data)
    if resolve_participation(cfg, policy_fn, path, K) == "sparse":
        # opt passed as given: the sparse runner keys its phase-B cache on
        # the default optimizer's (kind, lr)
        return make_sparse_runner(loss_fn, acc_fn, client_data, test_ds,
                                  policy_fn, cell, cfg, opt, device=device)
    emit_run_manifest("make_runner", cfg,
                      extra={"path": path, "num_clients": K})
    if path == "stream":
        return _make_stream_runner(loss_fn, acc_fn, _shards(client_data,
                                                            path),
                                   test_ds, policy_fn, cell, cfg, opt,
                                   device=device)
    placement = (_client_mesh(K, device) if shard_clients in (None, True)
                 else None)
    return _dense_runner(loss_fn, acc_fn, client_data, test_ds, policy_fn,
                         cell, cfg, opt, device=device, data_path=path,
                         placement=placement)


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
    pw = hoisted_policy(fn, h_all.T)
    if pw is None:
        return fn
    return _schedule_policy(types.SimpleNamespace(p=pw[0].T, w=pw[1].T))


def _test_slice(test_ds: Dataset, cfg: SimConfig, device):
    return (test_ds.x[: cfg.eval_batch].to(device),
            test_ds.y[: cfg.eval_batch].to(device))


def _gains(h_all, device) -> torch.Tensor:
    """``h_all [K, T]`` as round-major ``[T, K]`` float32 on ``device``."""
    return torch.as_tensor(h_all, dtype=torch.float32).to(device).T


def _dense_runner(loss_fn: Callable, acc_fn: Callable, client_data,
                  test_ds: Dataset, policy, cell: CellConfig, cfg: SimConfig,
                  opt: Optimizer | None = None, device=None,
                  data_path: str = "device",
                  placement: ClientPlacement | None = None) -> Callable:
    """The dense engine's ``runner(params, h_all, seed=None,
    fault_params=None, agg_params=None) -> SimResult`` on the device store
    (``data_path="device"``) or the prestack batches (``"prestack"``, built
    here once).  The two keywords replace ``cfg.faults.params()`` and
    ``cfg.aggregator.params()`` for one run: what the matrix sweeps
    sweep.  Each run is an ``engine.execute`` span, through the readback.
    With ``placement`` the data is split along K at build time, packed on
    the host (a store already built is split from where it lies), so the
    first card never holds all of it; the client rows of every run stay on
    their devices (``SimResult.state.gathered()`` joins them)."""
    policy_fn = as_policy_fn(policy)
    resolve_data_path(client_data, cfg, data_path)
    device = resolve_device(device)
    chunk = build_chunk_sim(loss_fn, acc_fn, opt or sgd(cfg.lr), cfg, cell,
                            _num_clients(client_data), policy_fn,
                            data_mode=data_path)
    if data_path == "prestack":
        shards = _shards(client_data, data_path)
        K = len(shards)
        if placement is None:
            xb_all, yb_all = stack_round_batches(shards, cfg, device)
        else:
            xb_all, yb_all = (placement.split(v, dim=1) for v in
                              stack_round_batches(shards, cfg, "cpu"))
    else:
        if placement is None:
            store = _as_store(client_data, device)
        else:
            store = placement.place_store(
                client_data if isinstance(client_data, DeviceDataStore)
                else from_client_datasets(client_data, device="cpu"))
        K = store.num_clients
        data_key = data_stream_key(cfg.seed, device=device)
    test_x, test_y = _test_slice(test_ds, cfg, device)
    T = cfg.rounds
    tel = get_telemetry()
    devices = (device,) if placement is None else placement.devices

    @torch.no_grad()
    def run(params, h_all, seed: int | None = None, fault_params=None,
            agg_params=None) -> tuple[SimResult, np.ndarray]:
        key = jr.PRNGKey(cfg.seed if seed is None else seed, device=device)
        h_rounds = _gains(h_all, device)
        with tel.span("engine.execute", devices):
            pw = hoisted_policy(policy_fn, h_rounds)
            carry = init_carry(params, K, cfg, device, placement)
            if data_path == "prestack":
                carry, tr = chunk(carry, range(T), h_rounds, xb_all, yb_all,
                                  pw, key, test_x, test_y, fault_params,
                                  agg_params)
            else:
                carry, tr = chunk(carry, range(T), h_rounds, pw, store,
                                  data_key, key, test_x, test_y,
                                  fault_params, agg_params)
            return _to_result(carry, tr, cfg), tr.e_round.cpu().numpy()

    def runner(params, h_all, seed: int | None = None, fault_params=None,
               agg_params=None) -> SimResult:
        return run(params, h_all, seed, fault_params, agg_params)[0]

    # the run with its per-round energy [T, K] beside it (the matrices')
    runner.with_e_round = run
    return runner


def _make_stream_runner(loss_fn: Callable, acc_fn: Callable,
                        client_data: Sequence[Dataset], test_ds: Dataset,
                        policy_fn, cell: CellConfig, cfg: SimConfig,
                        opt: Optimizer | None = None,
                        device=None) -> Callable:
    """Host streaming: the horizon in ``cfg.stream_chunk``-round chunks;
    chunk ``i+1``'s batches are gathered on the host (the device store's
    index stream, so the same bits) and copied while chunk ``i`` computes,
    so the device holds about two chunks of data whatever T and the
    dataset size.  ``runner(params, h_all, seed=None, fault_params=None,
    agg_params=None) -> SimResult``; ``runner.sampler`` is the
    :class:`StreamingSampler`."""
    device = resolve_device(device)
    K = len(client_data)
    T = cfg.rounds
    sampler = StreamingSampler(client_data, data_stream_key(cfg.seed),
                               cfg.local_iters, cfg.batch_size,
                               device=device)
    chunk = build_chunk_sim(loss_fn, acc_fn, opt or sgd(cfg.lr), cfg, cell,
                            K, policy_fn, data_mode="prestack")
    test_x, test_y = _test_slice(test_ds, cfg, device)
    C = max(1, int(cfg.stream_chunk))
    bounds = [(t0, min(t0 + C, T)) for t0 in range(0, T, C)]
    tel = get_telemetry()

    @torch.no_grad()
    def runner(params, h_all, seed: int | None = None, fault_params=None,
               agg_params=None) -> SimResult:
        key = jr.PRNGKey(cfg.seed if seed is None else seed, device=device)
        h_rounds = _gains(h_all, device)
        with tel.span("engine.execute", (device,)):
            pw = hoisted_policy(policy_fn, h_rounds)
            carry = init_carry(params, K, cfg, device)
            buf = sampler.chunk(*bounds[0])
            traces = []
            for i, (t0, t1) in enumerate(bounds):
                carry, tr = chunk(carry, range(t0, t1), h_rounds[t0:t1],
                                  *buf, None if pw is None
                                  else (pw[0][t0:t1], pw[1][t0:t1]),
                                  key, test_x, test_y, fault_params,
                                  agg_params)
                traces.append(tr)
                if i + 1 < len(bounds):   # the copy overlaps the chunk
                    buf = sampler.chunk(*bounds[i + 1])
            return _to_result(carry, concat_traces(traces), cfg)

    runner.sampler = sampler
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
    # each lane's MetricsState, stacked on the lane axes, when cfg.metrics
    # enables taps; None otherwise
    metrics: Any = None


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
        participation=stack([r.participation for r, _ in lanes]),
        metrics=stack_metrics([r.metrics for r, _ in lanes], shape))


def _lanes_check(h_stack, seeds, cfg: SimConfig) -> torch.Tensor:
    h = torch.as_tensor(h_stack, dtype=torch.float32)
    if h.dim() != 3 or h.shape[0] != len(seeds):
        raise ValueError(f"h_stack must be [S, K, T] with one lane per "
                         f"seed: {tuple(h.shape)} for {len(seeds)} seeds")
    if h.shape[2] != cfg.rounds:
        raise ValueError(f"h_stack has {h.shape[2]} rounds, "
                         f"cfg.rounds={cfg.rounds}")
    return h


def matrix_data(client_data, cfg: SimConfig, device):
    """A matrix sweep's data and path: the shards on the prestack path,
    else the store on ``device``; a resolved ``"stream"`` path runs on the
    device store, as in JAX (the lanes share one store)."""
    path = resolve_data_path(client_data, cfg, device=device)
    if path == "prestack":
        return _shards(client_data, path), path
    return _as_store(client_data, device), "device"


def run_seed_matrix(init_params, loss_fn, acc_fn, client_data, test_ds,
                    policy, h_stack, cell: CellConfig, cfg: SimConfig,
                    seeds: Sequence[int], opt: Optimizer | None = None,
                    device=None) -> MatrixResult:
    """One policy over scenario lanes: ``h_stack [S, K, T]`` holds one
    channel realization a lane, ``seeds`` each lane's participation stream.
    The data (one store, or the prestack batches) and its minibatch stream
    (``cfg.seed``) are shared by every lane.  Each lane is one run of the
    dense engine on ``device`` (``None`` means the card); leading axis
    ``[S]``."""
    device = resolve_device(device)
    h = _lanes_check(h_stack, seeds, cfg)
    data, path = matrix_data(client_data, cfg, device)
    runner = _dense_runner(loss_fn, acc_fn, data, test_ds, policy, cell,
                           cfg, opt, device=device, data_path=path)
    emit_run_manifest("run_seed_matrix", cfg,
                      extra={"lanes": len(seeds),
                             "num_clients": _num_clients(data)})
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
    check_modes(cfg)
    device = resolve_device(device)
    h = _lanes_check(h_stack, seeds, cfg)
    data, path = matrix_data(client_data, cfg, device)
    emit_run_manifest("run_scenario_matrix", cfg,
                      extra={"rhos": len(rhos), "lanes": len(seeds),
                             "num_clients": _num_clients(data)})
    lanes = []
    for rho in rhos:
        rho_t = torch.tensor(float(rho), dtype=torch.float32, device=device)
        runner = _dense_runner(loss_fn, acc_fn, data, test_ds,
                               online_policy(spec, rho=rho_t), spec.cell,
                               cfg, opt, device=device, data_path=path)
        lanes += [runner.with_e_round(init_params, h[s], seed=int(seed))
                  for s, seed in enumerate(seeds)]
    return _matrix_result(lanes, (len(rhos), len(seeds)))
