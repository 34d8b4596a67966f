"""Async aggregation front door: the ingest layer (counterpart of
``repro.serve.server``).

The paper's clients "probabilistically transmit the local model to the
server at arbitrary times" — this module is that server.  Concurrent
client threads call :meth:`AggregationServer.submit` with ``(client_id,
delta, local_version)`` at any moment; updates land in a bounded pending
set with **backpressure** (submissions beyond ``queue_capacity`` are
rejected, never silently dropped) and **per-client dedup** (one in-flight
update per client).  A background :class:`~repro_torch.serve.batcher.
MicroBatcher` coalesces pending updates into pow2-bucketed micro-batches
and runs the sparse engine's participant-subset aggregation: one K1
launch a flush.

The global model is one ``[W]`` float32 row on the device with its
:class:`~repro_torch.fl.state.ParamLayout`.  :meth:`pull` returns
per-layer views of the current row and :meth:`pull_row` the row itself; a
flush writes a fresh row (K1 allocates its output), so what a client
pulled never changes under it.  :meth:`submit` takes a ``[W]`` delta row
or a param tree, which it flattens.

The server also plays the paper's control plane: after every applied
micro-batch it re-solves the policy — by default the paper's (P1') online
solve (:func:`repro_torch.core.selection.online_policy`) — against the
live ``(version, last_tx)`` ledger, and :meth:`transmit_probs` serves the
per-client transmit probabilities ``p_{k,t}`` back to clients.  On the
card that solve is ~10⁵–10⁶ small launches, run in a background thread
that holds the interpreter lock against the submitters; the
``serve.policy_refresh`` span times it.

Every admitted micro-batch is appended to the
:class:`~repro_torch.serve.replay.DecisionLog`; see
:mod:`repro_torch.serve.replay` for the replay-parity contract.
Threading: one condition variable guards the pending set and ledgers;
device work runs outside the lock; a flush lock serializes micro-batches
so the version history is a total order.  All threads use the device's
default CUDA stream, so the submitters' deltas are ready, in stream order,
before the flush that reads them; a flush waits for its aggregation to
finish on the device before it resolves tickets or reads admission
latency.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.channel import CellConfig, rate_nats
from ..fl.faults import GuardConfig
from ..fl.state import AggregatorConfig, ParamLayout
from ..obs.telemetry import emit_run_manifest, get_telemetry
from .batcher import MicroBatcher, build_apply_fn, pick_bucket
from .replay import BatchRecord, DecisionLog

_ADMISSION_KINDS = ("fifo", "age")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Front-door configuration (frozen ⇒ hashable, manifest-stampable).

    ``max_batch`` is the largest micro-batch (pow2 — the bucket ceiling);
    ``min_bucket`` the smallest padded lane count (small flushes pad up to
    it, like ``participant_bucket`` in the sparse engine).
    ``flush_interval_s`` bounds admission latency: the batcher flushes
    early when the oldest pending update has waited that long.
    ``admission`` orders intake when pending > max_batch: ``"fifo"``
    (arrival order) or ``"age"`` (stalest local_version first).
    ``local_iters``/``batch_size``/``lr``/``seed`` pin the client-side
    training contract recorded in the decision log.
    ``policy_refresh_async`` re-solves ``p_{k,t}`` in a background thread
    (False: synchronously inside each flush, deterministic);
    ``policy_refresh_min_interval_s`` is the floor between background
    re-solves.
    """

    num_clients: int
    queue_capacity: int = 256
    max_batch: int = 64
    min_bucket: int = 8
    flush_interval_s: float = 0.002
    admission: str = "fifo"
    local_iters: int = 1
    batch_size: int = 10
    lr: float = 0.01
    seed: int = 0
    guards: Optional[GuardConfig] = None
    aggregator: Optional[AggregatorConfig] = None
    policy_refresh_async: bool = True
    policy_refresh_min_interval_s: float = 0.0

    def __post_init__(self):
        if self.num_clients < 1:
            raise ValueError("num_clients must be >= 1")
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        if self.max_batch < 1 or (self.max_batch & (self.max_batch - 1)):
            raise ValueError(f"max_batch must be a power of two, "
                             f"got {self.max_batch}")
        if not 1 <= self.min_bucket <= self.max_batch:
            raise ValueError("need 1 <= min_bucket <= max_batch")
        if self.admission not in _ADMISSION_KINDS:
            raise ValueError(f"unknown admission {self.admission!r} "
                             f"(expected one of {_ADMISSION_KINDS})")


class Ticket:
    """Submission receipt.  ``admitted`` is decided synchronously under the
    ingest lock; for admitted tickets :meth:`wait` blocks until the update
    aggregates and returns the first server version containing it."""

    __slots__ = ("client_id", "seq", "admitted", "reason", "arrival_s",
                 "_event", "_version")

    def __init__(self, client_id: int, seq: int, admitted: bool,
                 reason: str | None = None):
        self.client_id = client_id
        self.seq = seq
        self.admitted = admitted
        self.reason = reason
        self.arrival_s = time.perf_counter()
        self._event = threading.Event() if admitted else None
        self._version: int | None = None

    def done(self) -> bool:
        return bool(self._event and self._event.is_set())

    def wait(self, timeout: float | None = None) -> int | None:
        """Admitted version, or ``None`` on timeout / rejected ticket."""
        if self._event is None:
            return None
        if not self._event.wait(timeout):
            return None
        return self._version

    def _resolve(self, version: int) -> None:
        self._version = version
        self._event.set()


class _Pending(NamedTuple):
    ticket: Ticket
    delta: torch.Tensor
    local_version: int
    energy_j: float


class _LedgerView(NamedTuple):
    """What ledger policies read (as ``repro_torch.fl.sparse.
    _DecisionView``)."""

    round: torch.Tensor
    last_tx: torch.Tensor


def _wait_for_device(t: torch.Tensor) -> None:
    """Block until the work queued on ``t``'s device stream is done."""
    if t.device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        ev.synchronize()


class AggregationServer:
    """The micro-batching asynchronous FL aggregation server.

    ``params`` is the initial global model (a list of ``{name: tensor}``
    layers), held as one ``[W]`` row on ``device`` (``None`` means the
    card).  ``policy_fn`` is an engine-native
    :data:`~repro_torch.core.selection.PolicyFn` (state-free or ledger);
    ``gains`` feeds it per-refresh channel gains — a tensor ``[T_g, K]``
    cycled by version, or a callable ``t -> [K]``.  ``cell`` enables the
    eq.-5 upload-cost estimate served to clients.  With ``start=False`` no
    batcher thread runs — call :meth:`flush` manually.
    """

    def __init__(self, params: Any, cfg: ServeConfig,
                 policy_fn: Callable | None = None, gains=None,
                 cell: CellConfig | None = None, start: bool = True,
                 device=None):
        self.cfg = cfg
        self._tel = get_telemetry()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._flush_lock = threading.Lock()
        self._closed = False
        self.device = resolve_device(device)
        K = cfg.num_clients

        self.layout = ParamLayout.of(params)
        self._global = self.layout.flatten(params, self.device)
        self._version = 0
        self._last_tx = np.zeros((K,), np.int32)
        self._tx_count = np.zeros((K,), np.int64)
        self._energy = np.zeros((K,), np.float32)
        self._pending: dict[int, _Pending] = {}   # insertion-ordered
        self._seq_auto = np.zeros((K,), np.int64)

        self.log = DecisionLog(num_clients=K, seed=cfg.seed,
                               local_iters=cfg.local_iters,
                               batch_size=cfg.batch_size, lr=cfg.lr,
                               guards=cfg.guards, aggregator=cfg.aggregator)
        self._apply = build_apply_fn(cfg.guards, cfg.aggregator, K,
                                     self.device)

        self._policy_fn = policy_fn
        self._gains = gains
        self._cell = cell
        if policy_fn is not None and gains is None:
            raise ValueError("a policy_fn needs `gains` (tensor [T, K] or "
                             "callable t -> [K]) to evaluate p_{k,t}")
        self._probs = np.ones((K,), np.float32)
        self._w = np.full((K,), 1.0 / K, np.float32)
        self._cost = np.zeros((K,), np.float32)
        self._refresh_policy()

        self._admit_latency_s: list[float] = []
        self._occupancy: list[tuple[int, int]] = []   # (n, bucket)

        self._policy_dirty = threading.Event()
        self._policy_stop = False
        self._policy_thread: threading.Thread | None = None
        if policy_fn is not None and cfg.policy_refresh_async and start:
            self._policy_thread = threading.Thread(
                target=self._policy_loop, daemon=True,
                name="repro-serve-policy")
            self._policy_thread.start()

        emit_run_manifest("serve_session", cfg,
                          extra={"num_clients": K,
                                 "policy": getattr(policy_fn, "__name__",
                                                   str(policy_fn))})
        self._batcher: MicroBatcher | None = None
        if start:
            self._batcher = MicroBatcher(self)
            self._batcher.start()

    # -- client-facing API --------------------------------------------------

    def pull(self) -> tuple[int, list]:
        """Current ``(version, global model)`` — per-layer views of the
        current row, what a client trains from."""
        version, row = self.pull_row()
        return version, self.layout.unflatten(row)

    def pull_row(self) -> tuple[int, torch.Tensor]:
        """Current ``(version, [W] row)``."""
        with self._lock:
            return self._version, self._global

    def transmit_probs(self) -> np.ndarray:
        """The paper's ``p_{k,t}`` for the current version (copy)."""
        with self._lock:
            return self._probs.copy()

    def upload_cost(self, client_id: int) -> float:
        """Estimated eq.-5 upload energy (J) at the current allocation
        (0.0 when no ``cell`` was configured)."""
        with self._lock:
            return float(self._cost[client_id])

    def submit(self, client_id: int, delta: Any, local_version: int,
               seq: int | None = None, energy_j: float = 0.0) -> Ticket:
        """Offer one update: a ``[W]`` row or a param tree.  Never blocks
        on device work; admission is decided immediately
        (backpressure/dedup/validation) and returned on the
        :class:`Ticket`.  A row of another width raises ``ValueError``."""
        if isinstance(delta, torch.Tensor):
            delta = delta.to(self.device, torch.float32)
        else:
            delta = self.layout.flatten(delta, self.device)
        if delta.shape != (self.layout.width,):
            raise ValueError(f"delta of shape {tuple(delta.shape)}; the "
                             f"server takes [{self.layout.width}] rows")
        self._tel.inc("serve.submitted")
        with self._cv:
            k = int(client_id)
            in_range = 0 <= k < self.cfg.num_clients
            if seq is None:
                seq = int(self._seq_auto[k]) if in_range else -1
                if in_range:
                    self._seq_auto[k] += 1
            t = self._version
            if self._closed:
                reason = "closed"
            elif not in_range:
                reason = "bad_client"
            elif not 0 <= int(local_version) <= t:
                reason = "bad_version"
            elif k in self._pending:
                reason = "duplicate"
            elif len(self._pending) >= self.cfg.queue_capacity:
                reason = "backpressure"
            else:
                ticket = Ticket(k, int(seq), True)
                self._pending[k] = _Pending(ticket, delta,
                                            int(local_version),
                                            float(energy_j))
                self._tel.inc("serve.admitted")
                self._cv.notify_all()
                return ticket
            self._tel.inc(f"serve.rejected_{reason}")
            return Ticket(k, int(seq), False, reason=reason)

    # -- micro-batch plumbing (the batcher drives this) ---------------------

    def _take_locked(self) -> list[_Pending] | None:
        """Pop up to ``max_batch`` pending updates (caller holds the lock)."""
        if not self._pending:
            return None
        items = list(self._pending.values())
        if self.cfg.admission == "age":
            items.sort(key=lambda p: -(self._version - p.local_version))
        take = items[: self.cfg.max_batch]
        for p in take:
            del self._pending[p.ticket.client_id]
        return take

    def flush(self) -> int:
        """Apply one micro-batch (no-op on an empty queue).  Returns the
        number of updates aggregated.  Serialized: concurrent callers queue
        behind the flush lock, so versions advance one batch at a time."""
        with self._flush_lock:
            with self._cv:
                batch = self._take_locked()
                if batch is None:
                    return 0
                t = self._version
                g = self._global
            n = len(batch)
            bucket = pick_bucket(n, self.cfg.min_bucket, self.cfg.max_batch)
            ids = np.fromiter((p.ticket.client_id for p in batch), np.int64,
                              n)
            versions = np.fromiter((p.local_version for p in batch),
                                   np.int64, n)
            stale = t - versions
            probs = self._probs[ids]
            energy = np.fromiter((p.energy_j for p in batch), np.float32, n)
            deltas = [p.delta for p in batch]
            with self._tel.span("serve.flush"):
                g_new = self._apply(g, deltas, bucket, stale, probs)
                _wait_for_device(g_new)
            now = time.perf_counter()
            rec = BatchRecord(
                t=t, bucket=bucket, ids=tuple(int(i) for i in ids),
                versions=tuple(int(v) for v in versions),
                seqs=tuple(p.ticket.seq for p in batch),
                stale=tuple(int(s) for s in stale),
                probs=tuple(float(p) for p in probs),
                energy=tuple(float(e) for e in energy))
            with self._lock:
                self._global = g_new
                self._version = t + 1
                self._last_tx[ids] = t
                np.add.at(self._tx_count, ids, 1)
                np.add.at(self._energy, ids, energy)
                self.log.append(rec)
                self._occupancy.append((n, bucket))
                for p in batch:
                    self._admit_latency_s.append(now - p.ticket.arrival_s)
            if self._policy_thread is not None:
                self._policy_dirty.set()     # coalesced background re-solve
            else:
                self._refresh_policy()
            self._tel.inc("serve.batches")
            self._tel.inc("serve.uploads_aggregated", n)
            for p in batch:
                p.ticket._resolve(t + 1)
            return n

    def _policy_loop(self) -> None:
        """Background control plane: one re-solve per dirty signal, repeat
        flushes while a solve is in flight coalesce into a single refresh
        against the latest ledger, and at most one solve per
        ``policy_refresh_min_interval_s``."""
        interval = self.cfg.policy_refresh_min_interval_s
        last = -float("inf")
        while True:
            self._policy_dirty.wait()
            if self._policy_stop:
                return
            wait_s = interval - (time.perf_counter() - last)
            if wait_s > 0 and not self._policy_stop:
                time.sleep(wait_s)
            if self._policy_stop:
                return
            self._policy_dirty.clear()
            self._refresh_policy()
            last = time.perf_counter()

    def _gains_at(self, t: int) -> torch.Tensor:
        h = (self._gains(t) if callable(self._gains)
             else self._gains[t % len(self._gains)])
        return torch.as_tensor(h, dtype=torch.float32).to(self.device)

    def _refresh_policy(self) -> None:
        if self._policy_fn is None:
            return
        with self._lock:
            t = self._version
            ltx = torch.as_tensor(self._last_tx).to(self.device)
        h_t = self._gains_at(t)
        view = _LedgerView(round=torch.tensor(t, dtype=torch.int32,
                                              device=self.device),
                           last_tx=ltx)
        with self._tel.span("serve.policy_refresh"):
            p, w = self._policy_fn(t, h_t, view)
            p = p.to(torch.float32).cpu().numpy()
            w = w.to(torch.float32).cpu().numpy()
        if self._cell is not None:
            c = self._cell
            rate = rate_nats(torch.as_tensor(w), h_t.cpu(), c.tx_power_w,
                             c.bandwidth_hz, c.noise_w_per_hz).numpy()
            cost = (c.tx_power_w * c.model_size_nats
                    / np.maximum(rate, 1e-30)).astype(np.float32)
        else:
            cost = self._cost
        with self._lock:
            self._probs, self._w, self._cost = p, w, cost

    # -- lifecycle / introspection ------------------------------------------

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def in_flight(self, client_id: int) -> bool:
        """Cheap pre-check: does this client already have a pending update?
        Advisory only (the authoritative dedup happens in :meth:`submit`) —
        it lets a load generator skip the local-train compute for a
        submission that would be rejected as a duplicate anyway."""
        with self._lock:
            return int(client_id) in self._pending

    def global_params(self) -> list:
        """Per-layer views of the current global row."""
        return self.pull()[1]

    def global_row(self) -> torch.Tensor:
        """The current global ``[W]`` row."""
        return self.pull_row()[1]

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def ledger_snapshot(self) -> dict:
        with self._lock:
            return {"version": self._version,
                    "last_tx": self._last_tx.copy(),
                    "tx_count": self._tx_count.copy(),
                    "energy": self._energy.copy()}

    def reset_stats(self) -> None:
        """Zero the latency/occupancy measurement windows (benchmarks call
        this after a warmup burst).  Ledgers and the decision log are
        untouched — the replay-parity contract always covers the whole
        session."""
        with self._lock:
            self._admit_latency_s.clear()
            self._occupancy.clear()

    def stats(self) -> dict:
        """Latency / occupancy summary for the session so far."""
        with self._lock:
            lat = np.asarray(self._admit_latency_s, np.float64)
            occ = list(self._occupancy)
        out = {"batches": len(occ),
               "uploads": int(sum(n for n, _ in occ))}
        if len(lat):
            out["admit_ms"] = {
                "p50": float(np.percentile(lat, 50) * 1e3),
                "p95": float(np.percentile(lat, 95) * 1e3),
                "p99": float(np.percentile(lat, 99) * 1e3),
                "max": float(lat.max() * 1e3)}
        if occ:
            fills = [n / b for n, b in occ]
            out["occupancy"] = {"mean": float(np.mean(fills)),
                                "min": float(np.min(fills)),
                                "mean_batch": float(np.mean(
                                    [n for n, _ in occ]))}
        return out

    def close(self, drain: bool = True) -> None:
        """Stop admitting, stop the batcher, optionally flush the queue dry
        (every admitted ticket resolves — the no-drop invariant).  Raises
        the exception that stopped the batcher, if one did."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        error = None
        if self._batcher is not None:
            self._batcher.stop()
            error = self._batcher.error
            self._batcher = None
        if self._policy_thread is not None:
            self._policy_stop = True
            self._policy_dirty.set()
            self._policy_thread.join(timeout=30)
            self._policy_thread = None
        if error is not None:
            raise error
        if drain:
            while self.flush():
                pass

    def __enter__(self) -> "AggregationServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
