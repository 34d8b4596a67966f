"""Served sessions through JAX's server and the port's, and the port's
replay (repro_torch.serve.replay).

The two manual sessions of tests/test_serve.py (plain; guards with the
csmaafl aggregator) are driven with the same uploads — the same clients,
sequence numbers, anchors and energies — through both servers: the
decision-log records are equal bit for bit, so are the integer and energy
ledgers, and the served models agree within rtol 1e-4, atol 1e-5.  The
port's ``verify_replay`` passes on each (the model to that tolerance, not
to equality: the live client trains a width-1 lane, the replay a bucket).
A log either package wrote loads in the other, and the port's replay of
JAX's log lands on JAX's served model.  Also: ``make_client_step``'s delta
against JAX's, and the threaded load-generator session of
tests/test_serve.py (port only), replaying.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import jax
import numpy as np
import pytest

from repro.fl.faults import GuardConfig as JGuard
from repro.fl.state import AggregatorConfig as JAgg
from repro.serve import AggregationServer as JServer
from repro.serve import DecisionLog as JLog
from repro.serve import ServeConfig as JServeConfig
from repro.serve import make_client_step as j_make_client_step
from repro.serve import toy_world as j_toy_world
from repro_torch import random as jr
from repro_torch.core import CellConfig, ProblemSpec
from repro_torch.core.channel import channel_gains, sample_positions
from repro_torch.core.selection import online_policy
from repro_torch.fl import AggregatorConfig, GuardConfig
from repro_torch.fl.state import ParamLayout
from repro_torch.serve import (AggregationServer, DecisionLog, LoadGenConfig,
                               ServeConfig, make_client_step, replay_session,
                               run_loadgen, toy_world, verify_replay)

RTOL, ATOL = 1e-4, 1e-5        # tests/golden/harness.py, replay.py:278

SESSIONS = {
    "plain": dict(K=16, uploads=40, kw=dict(max_batch=8, min_bucket=2)),
    "guarded-csmaafl": dict(K=12, uploads=24, kw=dict(
        max_batch=4, min_bucket=2,
        guards=(5.0, 0.5),      # quarantine on, clip, staleness power
        aggregator=("csmaafl", "poly"))),
}


def _cfg_kw(kw, jax_side: bool):
    out = dict(kw)
    if "guards" in kw:
        clip, power = kw["guards"]
        out["guards"] = (JGuard if jax_side else GuardConfig)(
            quarantine=True, clip_norm=clip, staleness_power=power)
    if "aggregator" in kw:
        kind, sfn = kw["aggregator"]
        out["aggregator"] = (JAgg if jax_side else AggregatorConfig)(
            kind=kind, staleness_fn=sfn)
    return out


def _drive(server, step, pull, K, uploads, seed=1):
    """tests/test_serve.py's ``_drive``: submit ``uploads`` client deltas,
    flushing whenever dedup blocks."""
    rng = np.random.default_rng(seed)
    seqs = np.zeros((K,), np.int64)
    done = 0
    while done < uploads:
        k = int(rng.integers(K))
        version, g = pull()
        seq = int(seqs[k])
        tk = server.submit(k, step(g, k, seq), version, seq=seq,
                           energy_j=float(k + 1) * 0.25)
        if tk.admitted:
            seqs[k] += 1
            done += 1
        else:
            assert tk.reason in ("duplicate", "backpressure")
            server.flush()
    server.close()


@pytest.fixture(scope="module", params=sorted(SESSIONS))
def sessions(request):
    """The same session through JAX's server and the port's."""
    spec = SESSIONS[request.param]
    K = spec["K"]
    common = dict(num_clients=K, local_iters=1, batch_size=3, lr=0.05,
                  seed=0)
    jparams, jstore, jloss, jacc = j_toy_world(K, dim=8, classes=4, n_per=6)
    jserver = JServer(jparams, JServeConfig(**common,
                                            **_cfg_kw(spec["kw"], True)),
                      start=False)
    jstep = j_make_client_step(jstore, jloss, 1, 3, 0, lr=0.05)
    _drive(jserver, jstep, jserver.pull, K, spec["uploads"])

    params, store, loss_fn, acc_fn = toy_world(K, dim=8, classes=4, n_per=6,
                                               device="cpu")
    server = AggregationServer(params, ServeConfig(
        **common, **_cfg_kw(spec["kw"], False)), start=False, device="cpu")
    step = make_client_step(store, loss_fn, 1, 3, 0, lr=0.05,
                            layout=server.layout)
    _drive(server, step, server.pull_row, K, spec["uploads"])
    return dict(jserver=jserver, server=server, params=params, store=store,
                loss_fn=loss_fn, acc_fn=acc_fn, uploads=spec["uploads"])


def _jax_row(tree, layout):
    flat = np.zeros(layout.width, np.float32)
    leaves = jax.tree_util.tree_leaves(tree)
    for (_, _, shape, off), leaf in zip(layout.entries, leaves):
        flat[off:off + int(np.prod(shape))] = np.asarray(leaf).reshape(-1)
    return flat


def test_toy_world_is_jax_bit_for_bit():
    jparams, jstore, _, _ = j_toy_world(24, seed=3)
    params, store, _, _ = toy_world(24, seed=3, device="cpu")
    np.testing.assert_array_equal(store.x.numpy(), np.asarray(jstore.x))
    np.testing.assert_array_equal(store.y.numpy(), np.asarray(jstore.y))
    np.testing.assert_array_equal(store.lengths.numpy(),
                                  np.asarray(jstore.lengths))
    assert [sorted(layer) for layer in params] == [["b", "w"]]
    assert params[0]["w"].shape == tuple(jparams["w"].shape)


def test_client_step_matches_jax():
    K = 16
    jparams, jstore, jloss, _ = j_toy_world(K, dim=8, classes=4, n_per=6)
    params, store, loss_fn, _ = toy_world(K, dim=8, classes=4, n_per=6,
                                          device="cpu")
    layout = ParamLayout.of(params)
    # a non-zero anchor: one step away from the zero model
    jstep = j_make_client_step(jstore, jloss, 2, 3, 0, lr=0.05)
    step = make_client_step(store, loss_fn, 2, 3, 0, lr=0.05, layout=layout)
    jg = jax.tree_util.tree_map(lambda a, d: a + d, jparams,
                                jstep(jparams, 5, 0))
    g = step(layout.flatten(params), 5, 0)
    for k, seq in ((0, 0), (7, 3), (15, 11)):
        want = _jax_row(jstep(jg, k, seq), layout)
        got = step(g, k, seq).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # a tree is flattened by the step itself
    np.testing.assert_array_equal(step(params, 3, 2).numpy(),
                                  step(layout.flatten(params), 3, 2).numpy())


def test_session_logs_and_ledgers_equal_jax(sessions):
    jserver, server = sessions["jserver"], sessions["server"]
    assert server.version == jserver.version == len(server.log) > 0
    assert server.log.header == jserver.log.header
    assert [r.to_dict() for r in server.log.records] == \
        [r.to_dict() for r in jserver.log.records]
    snap, jsnap = server.ledger_snapshot(), jserver.ledger_snapshot()
    for key in ("last_tx", "tx_count", "energy"):
        np.testing.assert_array_equal(snap[key], jsnap[key], err_msg=key)
    np.testing.assert_allclose(
        server.global_row().numpy(),
        _jax_row(jserver.global_params(), server.layout),
        rtol=RTOL, atol=ATOL)


def test_session_replays(sessions):
    s = sessions
    rep = verify_replay(s["server"], s["store"], s["params"], s["loss_fn"],
                        s["acc_fn"])
    assert rep["ok"] and rep["n_uploads"] == s["uploads"]
    assert rep["n_batches"] == s["server"].version
    assert rep["model_max_abs_err"] <= ATOL


def test_logs_cross_between_the_packages(sessions, tmp_path):
    """JAX's log loads in the port and replays onto JAX's served model; the
    port's log loads in JAX."""
    s = sessions
    jpath, path = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    s["jserver"].log.save(jpath)
    s["server"].log.save(path)
    loaded = DecisionLog.load(jpath)
    assert loaded.header == s["server"].log.header
    assert loaded.records == s["server"].log.records
    res = replay_session(loaded, s["store"], s["params"], s["loss_fn"],
                         s["acc_fn"])
    np.testing.assert_allclose(
        res.global_params.numpy(),
        _jax_row(s["jserver"].global_params(), s["server"].layout),
        rtol=RTOL, atol=ATOL)
    jloaded = JLog.load(path)
    assert jloaded.header == s["jserver"].log.header
    assert jloaded.records == s["jserver"].log.records


def test_loadgen_session_measures_and_replays():
    K = 24
    params, store, loss_fn, acc_fn = toy_world(K, dim=8, classes=4, n_per=6,
                                               device="cpu")
    cell = CellConfig(num_clients=K)
    pos = sample_positions(jr.PRNGKey(2), cell)
    gains = channel_gains(jr.PRNGKey(3), pos, 16)
    pol = online_policy(ProblemSpec(cell=cell, rho=0.05, num_rounds=16))
    cfg = ServeConfig(num_clients=K, queue_capacity=64, max_batch=8,
                      min_bucket=2, flush_interval_s=0.002)
    server = AggregationServer(params, cfg, policy_fn=pol, gains=gains,
                               cell=cell, start=True, device="cpu")
    lg = LoadGenConfig(uploads=60, workers=4, seed=0, respect_probs=False,
                       timeout_s=60.0)
    report = run_loadgen(server, store, loss_fn, lg)
    server.close(drain=True)
    assert report["uploads_admitted"] >= lg.uploads
    assert report["uploads_unresolved"] == 0
    assert report["uploads_per_second"] > 0
    assert report["batches"] == server.version > 0
    assert "p95" in report["admit_ms"] and "mean" in report["occupancy"]
    rep = verify_replay(server, store, params, loss_fn, acc_fn)
    assert rep["ok"] and rep["n_uploads"] == report["uploads_admitted"]
