"""Decision log + replay harness: the online path's parity discipline
(counterpart of ``repro.serve.replay``).

Every micro-batch the server admits is appended to a :class:`DecisionLog`
— which clients, at which server version (= the anchor each client
trained from), with which submission sequence number (= the client's
minibatch stream key), staleness, policy probability and energy.  The log
is the JAX package's JSON (:data:`LOG_SCHEMA`): a log either package wrote
loads in the other.  That record is enough to *re-run the whole served
session offline* through the sparse engine's participant-shaped training
program (:func:`repro_torch.fl.sparse.build_sparse_train_program`):

* the server's version history *is* phase B's global-model history
  ``hist [T+1, W]`` (version ``v`` = the model after micro-batch ``v-1``),
* each logged micro-batch is one "round" whose anchor slots are the
  recorded ``local_version`` entries,
* each lane's minibatches re-gather from the per-client stream
  ``fold_in(fold_in(data_key, seq), client_id)``
  (:func:`repro_torch.data.device.client_round_indices`) — the keys the
  live client used, so replayed local SGD consumes identical batches.

The parity contract (:func:`verify_replay`): integer ledgers — ``last_tx``,
per-client transmit counts — reproduce **bit for bit**; the energy ledger
re-accumulates in identical record order (bit-equal float adds); the
served global model matches the replayed one to ``rtol=1e-4, atol=1e-5``.
The live client trains a width-1 lane and the replay a bucket, so the
model is held to that tolerance, never to equality.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..data.device import DeviceDataStore, client_round_indices, \
    data_stream_key
from ..fl.faults import GuardConfig
from ..fl.state import AggregatorConfig, ParamLayout
from ..optim import Optimizer, sgd

#: decision-log JSON schema tag (the JAX package's).
LOG_SCHEMA = "repro-serve-log/v1"


@dataclasses.dataclass(frozen=True)
class BatchRecord:
    """One admitted micro-batch: everything replay needs, nothing else.

    All tuples have length ``n`` (the real, unpadded admission count);
    ``bucket`` is the pow2 lane count the server padded to (replay repads
    identically so the aggregation masks match).
    """

    t: int                    # server version the batch applied to
    bucket: int               # padded lane count used on the live path
    ids: tuple                # client ids, admission order
    versions: tuple           # local_version per lane (= anchor slot)
    seqs: tuple               # per-client submission sequence numbers
    stale: tuple              # t - local_version per lane (int)
    probs: tuple              # policy p_{k,t} snapshot at admission (float)
    energy: tuple             # reported upload energy per lane (float, J)

    @property
    def n(self) -> int:
        return len(self.ids)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "BatchRecord":
        return cls(t=int(d["t"]), bucket=int(d["bucket"]),
                   ids=tuple(int(i) for i in d["ids"]),
                   versions=tuple(int(v) for v in d["versions"]),
                   seqs=tuple(int(s) for s in d["seqs"]),
                   stale=tuple(int(s) for s in d["stale"]),
                   probs=tuple(float(p) for p in d["probs"]),
                   energy=tuple(float(e) for e in d["energy"]))


def _opt_dict(obj) -> dict | None:
    return None if obj is None else dataclasses.asdict(obj)


class DecisionLog:
    """Append-only record of a serve session, JSON round-trippable.

    The header pins everything that shapes the replayed program — the
    population size, the data-stream seed, the local-SGD hyper-parameters
    and the guard/aggregator configuration — so a log file alone (plus the
    initial params and the data store) determines the replay.
    """

    def __init__(self, num_clients: int, seed: int, local_iters: int,
                 batch_size: int, lr: float,
                 guards: GuardConfig | None = None,
                 aggregator: AggregatorConfig | None = None):
        self.header = {
            "schema": LOG_SCHEMA,
            "num_clients": int(num_clients),
            "seed": int(seed),
            "local_iters": int(local_iters),
            "batch_size": int(batch_size),
            "lr": float(lr),
            "guards": _opt_dict(guards),
            "aggregator": _opt_dict(aggregator),
        }
        self.records: list[BatchRecord] = []

    def append(self, rec: BatchRecord) -> None:
        self.records.append(rec)

    def __len__(self) -> int:
        return len(self.records)

    @property
    def guards(self) -> GuardConfig | None:
        g = self.header["guards"]
        return None if g is None else GuardConfig(**g)

    @property
    def aggregator(self) -> AggregatorConfig | None:
        a = self.header["aggregator"]
        return None if a is None else AggregatorConfig(**a)

    def to_dict(self) -> dict:
        return {"header": dict(self.header),
                "records": [r.to_dict() for r in self.records]}

    @classmethod
    def from_dict(cls, d: dict) -> "DecisionLog":
        h = d["header"]
        if h.get("schema") != LOG_SCHEMA:
            raise ValueError(f"unknown decision-log schema {h.get('schema')!r}"
                             f" (expected {LOG_SCHEMA})")
        log = cls.__new__(cls)
        log.header = dict(h)
        log.records = [BatchRecord.from_dict(r) for r in d["records"]]
        return log

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    @classmethod
    def load(cls, path: str) -> "DecisionLog":
        with open(path) as f:
            return cls.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# replay: decision log -> the sparse engine's phase-B program
# ---------------------------------------------------------------------------


def gather_logged_rounds(store: DeviceDataStore, data_key: torch.Tensor,
                         seq_all: torch.Tensor, id_all: torch.Tensor,
                         local_iters: int, batch_size: int):
    """Batches for every logged lane: ``([T, P, L, B, ...], [T, P, L,
    B])``, one broadcast draw over ``[T, P]``.

    The per-lane key is ``fold_in(fold_in(data_key, seq), client_id)`` —
    the live client's own stream (its submission counter plays the round
    index), unlike :func:`repro_torch.data.device.gather_participant_rounds`
    whose rounds share one ``t``.  Padding lanes (``id == K``) hash the raw
    id ``K`` and gather client ``K-1``'s rows; the aggregate masks them.
    """
    K = store.num_clients
    kc = torch.clamp(id_all.long(), 0, K - 1)
    bidx = client_round_indices(data_key, seq_all, id_all, store.lengths[kc],
                                local_iters, batch_size).long()
    rows = kc[..., None, None]
    return store.x[rows, bidx], store.y[rows, bidx]


class ReplayResult(NamedTuple):
    global_params: Any        # replayed final model: a [W] row
    last_tx: np.ndarray       # [K] int32 — version of each client's last admit
    tx_count: np.ndarray      # [K] int64 — admitted uploads per client
    energy: np.ndarray        # [K] f32 — Joules, record-order accumulation
    n_batches: int
    n_uploads: int


def replay_ledgers(log: DecisionLog) -> ReplayResult:
    """Host-side integer/energy ledger reconstruction (no device work).

    Accumulation visits records in log order and lanes in admission order —
    the exact order the live server applied them — so the float energy
    ledger is bit-equal, not merely close.
    """
    K = log.header["num_clients"]
    last_tx = np.zeros((K,), np.int32)
    tx_count = np.zeros((K,), np.int64)
    energy = np.zeros((K,), np.float32)
    n_up = 0
    for rec in log.records:
        ids = np.asarray(rec.ids, np.int64)
        last_tx[ids] = rec.t
        np.add.at(tx_count, ids, 1)
        np.add.at(energy, ids, np.asarray(rec.energy, np.float32))
        n_up += rec.n
    return ReplayResult(global_params=None, last_tx=last_tx,
                        tx_count=tx_count, energy=energy,
                        n_batches=len(log.records), n_uploads=n_up)


def replay_session(log: DecisionLog, store: DeviceDataStore, params: Any,
                   loss_fn: Callable, acc_fn: Callable,
                   opt: Optimizer | None = None,
                   test_x=None, test_y=None) -> ReplayResult:
    """Re-run a served session offline through the sparse engine, on the
    store's device.

    Builds the participant-shaped training program
    (:func:`repro_torch.fl.sparse.build_sparse_train_program`) with one
    round per logged micro-batch over a bucket of the largest logged
    bucket: ``slot_all`` = the recorded local versions, batches
    re-gathered from each lane's own ``(seq, client_id)`` stream.
    ``params`` is the initial model as a param tree.  Returns the replayed
    final ``[W]`` row plus the host-reconstructed ledgers.
    """
    from ..fl.engine import SimConfig
    from ..fl.sparse import build_sparse_train_program

    dev = store.x.device
    if len(log.records) == 0:
        row = ParamLayout.of(params).flatten(params, dev)
        return replay_ledgers(log)._replace(global_params=row)
    h = log.header
    K = h["num_clients"]
    T = len(log.records)
    P = max(r.bucket for r in log.records)
    L, B = h["local_iters"], h["batch_size"]

    ids = np.full((T, P), K, np.int32)          # sentinel-K padding
    seqs = np.zeros((T, P), np.int32)
    slots = np.zeros((T, P), np.int32)
    stale = np.zeros((T, P), np.int32)
    probs = np.zeros((T, P), np.float32)
    valid = np.zeros((T, P), bool)
    for i, rec in enumerate(log.records):
        n = rec.n
        ids[i, :n] = rec.ids
        seqs[i, :n] = rec.seqs
        slots[i, :n] = rec.versions
        stale[i, :n] = rec.stale
        probs[i, :n] = rec.probs
        valid[i, :n] = True

    def on_dev(a):
        return torch.from_numpy(a).to(dev)

    data_key = data_stream_key(h["seed"], device=dev)
    xb, yb = gather_logged_rounds(store, data_key, on_dev(seqs),
                                  on_dev(ids), L, B)
    if test_x is None:      # evals are incidental here — any valid batch
        test_x, test_y = store.x[0, :1], store.y[0, :1]
    cfg = SimConfig(rounds=T, local_iters=L, batch_size=B, lr=h["lr"],
                    eval_every=max(T, 1), local_mode="participants",
                    data_stream="client", guards=log.guards,
                    aggregator=log.aggregator)
    program = build_sparse_train_program(loss_fn, acc_fn,
                                         opt or sgd(h["lr"]), cfg)
    v = on_dev(valid)
    out = program(params, xb, yb, v, on_dev(slots), K, test_x, test_y,
                  delivered_all=v, stale_all=on_dev(stale),
                  probs_all=on_dev(probs))
    return replay_ledgers(log)._replace(global_params=out[0])


def verify_replay(server, store: DeviceDataStore, params: Any,
                  loss_fn: Callable, acc_fn: Callable,
                  opt: Optimizer | None = None,
                  rtol: float = 1e-4, atol: float = 1e-5) -> dict:
    """Assert the replay-parity contract against a (closed) server.

    Integer ledgers must match bit for bit, the energy ledger bit-equal
    (identical accumulation order), the model to ``(rtol, atol)``.
    Returns a report dict (max abs model error, batch/upload counts);
    raises ``AssertionError`` with the first violated invariant otherwise.
    """
    res = replay_session(server.log, store, params, loss_fn, acc_fn, opt=opt)
    snap = server.ledger_snapshot()
    np.testing.assert_array_equal(res.last_tx, snap["last_tx"],
                                  err_msg="replay last_tx mismatch")
    np.testing.assert_array_equal(res.tx_count, snap["tx_count"],
                                  err_msg="replay tx_count mismatch")
    np.testing.assert_array_equal(res.energy, snap["energy"],
                                  err_msg="replay energy ledger mismatch")
    served = server.global_row().cpu().numpy()
    replayed = res.global_params.cpu().numpy()
    np.testing.assert_allclose(replayed, served, rtol=rtol, atol=atol,
                               err_msg="replayed global model diverged")
    max_err = float(np.max(np.abs(replayed - served))) if served.size else 0.
    return {"n_batches": res.n_batches, "n_uploads": res.n_uploads,
            "model_max_abs_err": max_err, "ok": True}
