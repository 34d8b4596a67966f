"""The port's serve front door (repro_torch.serve) on the CPU: the unit
tests of tests/test_serve.py — bucketing, config validation, admission
(validation, dedup, close, backpressure at capacity, age ordering), the
decision log's JSON round trip, policy serving, racing submitters, close,
the load generator's precondition — plus what the flat-row server adds:
``pull()`` views that no flush changes, in each of K1's three modes, and
trees or rows on ``submit``.  Policy serving is held against JAX's server
at the same ledger: ``p`` and the upload cost within rtol 1e-5."""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CellConfig as JCell
from repro.core.channel import channel_gains as j_channel_gains
from repro.core.channel import sample_positions as j_sample_positions
from repro.core.selection import ProblemSpec as JSpec
from repro.core.selection import online_policy as j_online_policy
from repro.serve import AggregationServer as JServer
from repro.serve import ServeConfig as JServeConfig
from repro.serve import toy_world as j_toy_world
from repro_torch.core import CellConfig, ProblemSpec
from repro_torch.core.selection import online_policy
from repro_torch.fl import AggregatorConfig, GuardConfig
from repro_torch.serve import (AggregationServer, DecisionLog, LoadGenConfig,
                               ServeConfig, pick_bucket, run_loadgen,
                               toy_world)


def _world(K=16, seed=0):
    return toy_world(K, dim=8, classes=4, n_per=6, seed=seed, device="cpu")


def _server(params, K, start=False, **kw):
    cfg = ServeConfig(num_clients=K, local_iters=1, batch_size=3,
                      lr=0.05, seed=0, **kw)
    return AggregationServer(params, cfg, start=start, device="cpu"), cfg


def _zero(server):
    return torch.zeros(server.layout.width)


# --- unit: bucketing ---------------------------------------------------------


def test_pick_bucket_pow2_and_clamps():
    assert pick_bucket(1, 1, 64) == 1
    assert pick_bucket(3, 1, 64) == 4
    assert pick_bucket(5, 8, 64) == 8        # min_bucket floor
    assert pick_bucket(33, 8, 64) == 64
    assert pick_bucket(200, 8, 64) == 64     # max_batch ceiling
    assert pick_bucket(0, 1, 64) == 1


def test_serve_config_validation():
    with pytest.raises(ValueError, match="power of two"):
        ServeConfig(num_clients=4, max_batch=12)
    with pytest.raises(ValueError, match="min_bucket"):
        ServeConfig(num_clients=4, max_batch=8, min_bucket=16)
    with pytest.raises(ValueError, match="admission"):
        ServeConfig(num_clients=4, admission="lifo")
    with pytest.raises(ValueError, match="num_clients"):
        ServeConfig(num_clients=0)
    with pytest.raises(ValueError, match="queue_capacity"):
        ServeConfig(num_clients=4, queue_capacity=0)


# --- admission semantics -----------------------------------------------------


def test_submit_validation_dedup_and_close():
    params, store, loss_fn, acc_fn = _world(K=4)
    server, _ = _server(params, 4)
    d = _zero(server)
    assert server.submit(99, d, 0).reason == "bad_client"
    assert server.submit(-1, d, 0).reason == "bad_client"
    assert server.submit(0, d, 5).reason == "bad_version"   # future anchor
    t1 = server.submit(0, d, 0)
    assert t1.admitted and server.in_flight(0)
    assert server.submit(0, d, 0).reason == "duplicate"
    assert server.flush() == 1
    assert t1.wait(timeout=5) == 1 and server.version == 1
    server.close()
    assert server.submit(1, d, 0).reason == "closed"


def test_backpressure_engages_exactly_at_capacity():
    params, store, loss_fn, acc_fn = _world(K=8)
    server, _ = _server(params, 8, queue_capacity=3)
    d = _zero(server)
    for k in range(3):
        assert server.submit(k, d, 0).admitted
    tk = server.submit(3, d, 0)
    assert not tk.admitted and tk.reason == "backpressure"
    server.flush()                       # drains the pending set
    assert server.submit(3, d, 0).admitted
    server.close()


def test_age_admission_takes_stalest_first():
    params, store, loss_fn, acc_fn = _world(K=8)
    server, _ = _server(params, 8, admission="age", max_batch=2,
                        min_bucket=1)
    d = _zero(server)
    for _ in range(3):      # advance the version so distinct ages exist
        server.submit(0, d, server.version)
        server.flush()
    t = server.version
    server.submit(1, d, t)        # freshest
    server.submit(2, d, t - 2)    # stalest
    server.submit(3, d, t - 1)
    server.flush()
    rec = server.log.records[-1]
    assert list(rec.ids) == [2, 3]          # stalest two admitted first
    assert rec.stale[0] == 2 and rec.stale[1] == 1
    server.close()


def test_submit_takes_trees_and_rows_of_the_model_width():
    params, store, loss_fn, acc_fn = _world(K=4)
    server, _ = _server(params, 4, min_bucket=1)
    ones = [{k: torch.ones_like(v) for k, v in layer.items()}
            for layer in params]
    assert server.submit(0, ones, 0).admitted
    server.flush()
    row = server.global_row()
    np.testing.assert_allclose(row[:server.layout.size].numpy(), 0.25)
    with pytest.raises(ValueError, match="rows"):
        server.submit(1, torch.zeros(server.layout.width + 1), 0)
    server.close()


@pytest.mark.parametrize("mode", ["subset", "guarded", "scheme"])
def test_pulled_views_never_change_under_a_flush(mode):
    """A flush writes a fresh row in each of K1's modes: what a client
    pulled stays what it was, and the server's row moves."""
    kw = {"subset": {},
          "guarded": {"guards": GuardConfig(quarantine=True, clip_norm=5.0)},
          "scheme": {"aggregator": AggregatorConfig(kind="fedasync")}}[mode]
    params, store, loss_fn, acc_fn = _world(K=4)
    server, _ = _server(params, 4, min_bucket=2, **kw)
    v0, views = server.pull()
    row0 = server.global_row()
    before = [t.clone() for layer in views for t in layer.values()]
    assert all(t.untyped_storage().data_ptr()
               == row0.untyped_storage().data_ptr()
               for layer in views for t in layer.values())
    server.submit(0, torch.full((server.layout.width,), 0.5), v0)
    assert server.flush() == 1
    after = [t for layer in views for t in layer.values()]
    for a, b in zip(before, after):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert server.global_row() is not row0
    assert float(server.global_row().abs().sum()) > 0.0
    server.close()


# --- the decision log --------------------------------------------------------


def test_decision_log_roundtrips_through_json(tmp_path):
    params, store, loss_fn, acc_fn = _world(K=8)
    server, _ = _server(params, 8, max_batch=4, min_bucket=2,
                        guards=GuardConfig(clip_norm=2.0),
                        aggregator=AggregatorConfig(kind="csmaafl"))
    d = _zero(server)
    for k in range(6):
        server.submit(k, d, server.version, energy_j=0.5 * k)
        if k % 2:
            server.flush()
    server.close()
    p = str(tmp_path / "session.json")
    server.log.save(p)
    loaded = DecisionLog.load(p)
    assert loaded.header == server.log.header
    assert loaded.records == server.log.records
    assert loaded.guards == GuardConfig(clip_norm=2.0)
    assert loaded.aggregator == AggregatorConfig(kind="csmaafl")
    with pytest.raises(ValueError, match="schema"):
        DecisionLog.from_dict({"header": {"schema": "nope"}, "records": []})


# --- the control plane: p_{k,t} serving, against JAX's server ----------------


def test_policy_refresh_serves_jax_probs_and_costs():
    K = 16
    jparams, _, _, _ = j_toy_world(K, dim=8, classes=4, n_per=6)
    params, store, loss_fn, acc_fn = _world(K=K)
    jcell = JCell(num_clients=K)
    gains = j_channel_gains(jax.random.PRNGKey(1),
                            j_sample_positions(jax.random.PRNGKey(0), jcell),
                            8)
    jserver = JServer(jparams, JServeConfig(num_clients=K, min_bucket=1),
                      policy_fn=j_online_policy(
                          JSpec(cell=jcell, rho=0.05, num_rounds=8)),
                      gains=gains, cell=jcell, start=False)
    cell = CellConfig(num_clients=K)
    cfg = ServeConfig(num_clients=K, min_bucket=1)
    pol = online_policy(ProblemSpec(cell=cell, rho=0.05, num_rounds=8))
    server = AggregationServer(params, cfg, policy_fn=pol,
                               gains=torch.from_numpy(np.array(gains)),
                               cell=cell, start=False, device="cpu")

    def held():
        p = server.transmit_probs()
        assert p.shape == (K,) and np.all(p > 0) and np.all(p <= 1)
        np.testing.assert_allclose(p, jserver.transmit_probs(), rtol=1e-5)
        cost = [server.upload_cost(k) for k in range(K)]
        assert min(cost) > 0.0
        np.testing.assert_allclose(
            cost, [jserver.upload_cost(k) for k in range(K)], rtol=1e-5)
        return p

    p = held()
    jserver.submit(3, jax.tree_util.tree_map(jnp.zeros_like, jparams), 0)
    jserver.flush()
    server.submit(3, _zero(server), 0)
    server.flush()
    rec = server.log.records[0]
    assert rec.probs[0] == pytest.approx(float(p[3]))  # snapshot at admission
    jrec = jserver.log.records[0]     # the (P1') solve agrees to rounding
    assert dataclasses.replace(rec, probs=()).to_dict() == \
        dataclasses.replace(jrec, probs=()).to_dict()
    np.testing.assert_allclose(rec.probs, jrec.probs, rtol=1e-5)
    held()                                   # version 1, the new ledger
    server.close()
    jserver.close()
    with pytest.raises(ValueError, match="gains"):
        AggregationServer(params, cfg, policy_fn=pol, start=False,
                          device="cpu")


# --- concurrency: the no-drop / no-double-count stress test ------------------


def test_racing_submitters_never_drop_or_double_count():
    """Threads race the live batcher with a tiny queue: every admitted
    ticket resolves, the ledgers account for exactly the admitted multiset
    and the bound engaged (backpressure or dedup rejections observed)."""
    K = 32
    params, store, loss_fn, acc_fn = _world(K=K)
    cfg = ServeConfig(num_clients=K, queue_capacity=8, max_batch=8,
                      min_bucket=2, flush_interval_s=0.001)
    server = AggregationServer(params, cfg, start=True, device="cpu")
    d = _zero(server)
    n_threads, per_thread = 8, 40
    admitted: list = []
    rejected: list = []
    alock = threading.Lock()

    def submitter(w):
        rng = np.random.default_rng(w)
        for _ in range(per_thread):
            k = int(rng.integers(K))
            tk = server.submit(k, d, server.version)
            with alock:
                (admitted if tk.admitted else rejected).append(tk)

    threads = [threading.Thread(target=submitter, args=(w,))
               for w in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    server.close(drain=True)           # the no-drop invariant
    assert server._batcher is None

    versions = [tk.wait(timeout=10) for tk in admitted]
    assert all(v is not None for v in versions)            # nothing dropped
    snap = server.ledger_snapshot()
    assert int(snap["tx_count"].sum()) == len(admitted)    # nothing doubled
    logged = [(rec.t, i, s) for rec in server.log.records
              for i, s in zip(rec.ids, rec.seqs)]
    assert len(logged) == len(set(logged)) == len(admitted)
    per_client = np.bincount([tk.client_id for tk in admitted], minlength=K)
    np.testing.assert_array_equal(snap["tx_count"], per_client)
    assert len(rejected) > 0
    assert {tk.reason for tk in rejected} <= {"backpressure", "duplicate"}
    for tk, v in zip(admitted, versions):
        assert 1 <= v <= server.version


def test_batcher_close_is_idempotent_and_context_managed():
    params, store, loss_fn, acc_fn = _world(K=4)
    cfg = ServeConfig(num_clients=4, min_bucket=1)
    with AggregationServer(params, cfg, start=True, device="cpu") as server:
        tk = server.submit(0, _zero(server), 0)
        assert tk.wait(timeout=10) is not None
    server.close()                     # second close is a no-op
    assert server.version >= 1


def test_loadgen_requires_running_batcher():
    params, store, loss_fn, acc_fn = _world(K=4)
    server, _ = _server(params, 4, start=False)
    with pytest.raises(ValueError, match="batcher"):
        run_loadgen(server, store, loss_fn, LoadGenConfig(uploads=1))
    server.close()
