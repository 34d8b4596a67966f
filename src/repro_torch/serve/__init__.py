"""Async aggregation front door (counterpart of ``repro.serve``).

A long-running micro-batching FL server next to the dense/legacy/sparse
simulation paths: concurrent clients submit ``(client_id, delta,
local_version)`` at arbitrary times; a background batcher coalesces them
into pow2 buckets and runs the sparse engine's participant-subset
aggregation (one K1 launch a flush); every admitted micro-batch lands in a
decision log that replays through
:func:`repro_torch.fl.sparse.build_sparse_train_program`.  The global
model is one ``[W]`` row; deltas are ``[W]`` rows (or param trees, which
the server flattens).

* :mod:`repro_torch.serve.server` — ingest: bounded queue, backpressure,
  per-client dedup, the ``p_{k,t}`` policy refresh.
* :mod:`repro_torch.serve.batcher` — pow2 micro-batching + the apply.
* :mod:`repro_torch.serve.replay` — decision log + offline replay parity.
* :mod:`repro_torch.serve.loadgen` — emulated client population +
  measurements.
"""
from .batcher import MicroBatcher, build_apply_fn, pick_bucket
from .loadgen import LoadGenConfig, make_client_step, run_loadgen, toy_world
from .replay import (BatchRecord, DecisionLog, ReplayResult,
                     gather_logged_rounds, replay_ledgers, replay_session,
                     verify_replay)
from .server import AggregationServer, ServeConfig, Ticket

__all__ = [
    "AggregationServer", "ServeConfig", "Ticket", "MicroBatcher",
    "build_apply_fn", "pick_bucket", "BatchRecord", "DecisionLog",
    "ReplayResult", "gather_logged_rounds", "replay_ledgers",
    "replay_session", "verify_replay", "LoadGenConfig", "make_client_step",
    "run_loadgen", "toy_world",
]
