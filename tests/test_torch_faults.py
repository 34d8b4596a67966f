"""The port's fault pipeline (repro_torch.fl.faults) against the JAX
package's (repro.fl.faults) on the CPU: every process on the same keys, the
corruption modes on the flat rows, the parameter helpers, faulty runs of
both engines, and the degradation sweep.

Every boolean and integer outcome is held bit for bit: availability,
crashes, landings, attempts, deliveries, corruptions, participation and
``last_tx``.  Energy is held at rtol 1e-6 where the retry cost is an exact
power (backoff 2), else at rtol 1e-4; accuracy, loss and the model at the
golden rtol 1e-4, atol 1e-5 (tests/golden/harness.py), NaN in the same
places (``equal_nan`` and an explicit position check).  The world is
tests/test_faults.py's tiny one: K 5, T 8, a 64-24-10 MLP.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fl.faults as jf
from repro.core import CellConfig as JCell
from repro.core.channel import channel_gains as j_channel_gains
from repro.core.channel import sample_positions as j_sample_positions
from repro.core.selection import RandomScheme as JRandom
from repro.data import make_mnist_like as j_make_mnist_like
from repro.data import shard_noniid as j_shard_noniid
from repro.data.synthetic import Dataset as JDataset
from repro.fl import GuardConfig as JGuard
from repro.fl import SimConfig as JSimConfig
from repro.fl import make_sparse_runner as j_make_sparse_runner
from repro.fl import run_fault_matrix as j_run_fault_matrix
from repro.fl import run_simulation as j_run_simulation
from repro.models.small import init_mlp as j_init_mlp
from repro.models.small import mlp_accuracy as j_mlp_accuracy
from repro.models.small import mlp_loss as j_mlp_loss
import repro_torch.fl.faults as tf
from repro_torch import random as jr
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import CellConfig
from repro_torch.core.selection import RandomScheme
from repro_torch.data import Dataset
from repro_torch.fl import (GuardConfig, SimConfig, make_runner,
                            run_fault_matrix)
from repro_torch.fl import sparse
from repro_torch.fl.state import ParamLayout
from repro_torch.models.small import mlp_accuracy, mlp_loss

K, T, DIM = 5, 8, 64
RTOL, ATOL = 1e-4, 1e-5        # tests/golden/harness.py
E_RTOL = 1e-6                  # energy: tests/test_faults.py
# tests/test_faults.py's FAULTS with the diurnal modulation on
FAULTS = dict(p_fail=0.2, p_recover=0.5, diurnal_amp=0.5, p_crash=0.1,
              p_loss=0.2, max_retries=1, backoff=2.0, p_corrupt=0.25)
GUARDS = dict(quarantine=True, clip_norm=10.0, staleness_power=0.5)
SPARSE_KW = dict(local_mode="participants", data_path="device",
                 data_stream="client")


def both(**kw):
    """JAX's and the port's FaultConfig from the same fields."""
    return jf.FaultConfig(**kw), tf.FaultConfig(**kw)


def key_pair(seed):
    return jax.random.PRNGKey(seed), jr.PRNGKey(seed)


def to_torch(ds):
    return Dataset(torch.from_numpy(np.array(ds.x)),
                   torch.from_numpy(np.array(ds.y)), ds.num_classes)


# ---------------------------------------------------------------------------
# the processes, on the same keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_markov_availability_is_bit_exact(seed):
    """A 64-client chain over 48 rounds (two diurnal periods) with the
    modulation at 0.9: every step's availability equals JAX's."""
    jc, tc = both(p_fail=0.3, p_recover=0.4, diurnal_amp=0.9)
    jfp, tfp = jc.params(), tc.params("cpu")
    jkey, tkey = key_pair(seed)
    ja = jnp.ones((64,), bool)
    ta = torch.ones(64, dtype=torch.bool)
    flips = 0
    for t in range(48):
        ja, _ = jf.markov_availability(jnp.int32(t), jf.fault_key(jkey, t, 0),
                                       ja, jfp, jc)
        ta, _ = tf.markov_availability(t, tf.fault_key(tkey, t, 0), ta, tfp,
                                       tc)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        flips += int((~ta).sum())
    assert flips > 0                     # the chain really moved


@pytest.mark.parametrize("seed", range(3))
def test_crash_and_corruption_draws_are_bit_exact(seed):
    jc, tc = both(p_crash=0.3, p_corrupt=0.4)
    jkey, tkey = key_pair(seed)
    mask = (np.arange(40) % 3 != 0).astype(np.float32)
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    for t in range(5):
        jc_, _ = jf.crash_process(t, jf.fault_key(jkey, t, 1), jm,
                                  jc.params())
        tc_, _ = tf.crash_process(t, tf.fault_key(tkey, t, 1), tm,
                                  tc.params("cpu"))
        np.testing.assert_array_equal(tc_.numpy(), np.asarray(jc_))
        jr_, _ = jf.corruption_process(t, jf.fault_key(jkey, t, 3), jm,
                                       jc.params())
        tr_, _ = tf.corruption_process(t, tf.fault_key(tkey, t, 3), tm,
                                       tc.params("cpu"))
        np.testing.assert_array_equal(tr_.numpy(), np.asarray(jr_))


@pytest.mark.parametrize("retries,backoff,e_rtol", [
    (0, 1.0, 0.0), (1, 2.0, 0.0), (3, 2.0, 0.0), (3, 1.7, 1e-4)])
def test_uplink_process_matches_jax(retries, backoff, e_rtol):
    """First success, attempt counts and landings bit for bit; the retry
    cost exactly for backoff 1 and 2, else within rtol 1e-4 (float32
    ``pow``)."""
    jc, tc = both(p_loss=0.45, max_retries=retries, backoff=backoff)
    for seed in range(3):
        jkey, tkey = key_pair(seed)
        mask = np.ones(64, np.float32)
        want = jf.uplink_process(0, jf.fault_key(jkey, 2, 2),
                                 jnp.asarray(mask), jc.params(), jc)
        got = tf.uplink_process(0, tf.fault_key(tkey, 2, 2),
                                torch.from_numpy(mask), tc.params("cpu"), tc)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=e_rtol)
    assert np.asarray(want[1]).max() == retries + 1 or retries == 0


@pytest.mark.parametrize("seed", range(3))
def test_apply_faults_matches_jax_round_after_round(seed):
    """The composed pipeline over 24 rounds from a fresh chain: delivered,
    corrupt, attempts and avail bit for bit, energy at rtol 1e-6."""
    jc, tc = both(**FAULTS)
    jfp, tfp = jc.params(), tc.params("cpu")
    jkey, tkey = key_pair(seed)
    n = 32
    rng = np.random.default_rng(seed)
    js, ts = jf.init_fault_state(n), tf.init_fault_state(n, "cpu")
    seen = np.zeros(5)
    for t in range(24):
        mask = (rng.random(n) < 0.6).astype(np.float32)
        e = rng.uniform(0.1, 2.0, n).astype(np.float32) * mask
        jo, js = jf.apply_faults(jnp.int32(t), jkey, jnp.asarray(mask),
                                 jnp.asarray(e), js, jfp, jc)
        to, ts = tf.apply_faults(t, tkey, torch.from_numpy(mask),
                                 torch.from_numpy(e), ts, tfp, tc)
        for name in ("delivered", "corrupt", "attempts", "avail"):
            np.testing.assert_array_equal(getattr(to, name).numpy(),
                                          np.asarray(getattr(jo, name)),
                                          err_msg=f"round {t} {name}")
        np.testing.assert_allclose(to.e_round.numpy(), np.asarray(jo.e_round),
                                   rtol=E_RTOL)
        seen += [mask.sum() - to.delivered.sum().item(),
                 to.corrupt.sum().item(), (to.attempts > 1).sum().item(),
                 (~to.avail).sum().item(), to.delivered.sum().item()]
    assert (seen > 0).all(), seen         # every process fired


def test_fault_key_and_salt_match_jax():
    assert tf._FAULT_SALT == jf._FAULT_SALT == 0x5AFE
    for t, i in ((0, 0), (3, 2), (17, 3)):
        np.testing.assert_array_equal(
            tf.fault_key(jr.PRNGKey(9), t, i).numpy(),
            np.asarray(jf.fault_key(jax.random.PRNGKey(9), t, i)))


# ---------------------------------------------------------------------------
# corruption of the flat rows, parameters, trace fitting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["nan", "inf", "scale"])
def test_corrupt_deltas_on_flat_rows(mode):
    """JAX poisons a delta pytree, the port the flat ``[R, W]`` rows: the
    model's columns agree (NaN where JAX has NaN); the layout's pad columns
    take NaN/Inf in those modes and stay 0 under ``"scale"``."""
    params = j_init_mlp(jax.random.PRNGKey(0), dims=(7, 5, 3))
    rng = np.random.default_rng(1)
    jd = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=(4,) + p.shape), jnp.float32),
        params)
    layout = ParamLayout.of(params_from_jax(params, device="cpu"))
    assert layout.width - layout.size == 2     # 58 params, 2 pad columns
    flat = torch.zeros(4, layout.width)
    for i, name, shape, off in layout.entries:
        flat[:, off:off + int(np.prod(shape))] = torch.from_numpy(
            np.array(jd[i][name])).reshape(4, -1)
    flag = np.array([True, False, True, False])
    jc, tc = both(p_corrupt=1.0, corrupt_mode=mode, corrupt_scale=7.5)
    want = jf.corrupt_deltas(jd, jnp.asarray(flag), jc.params(), jc)
    got = tf.corrupt_deltas(flat, torch.from_numpy(flag), tc.params("cpu"),
                            tc)
    views = layout.unflatten(got)
    for i, name, _, _ in layout.entries:
        np.testing.assert_array_equal(views[i][name].numpy(),
                                      np.asarray(want[i][name]))
    pad = got[:, layout.size:].numpy()
    fill = {"nan": np.nan, "inf": np.inf, "scale": 0.0}[mode]
    np.testing.assert_array_equal(pad[flag], np.full_like(pad[flag], fill))
    np.testing.assert_array_equal(pad[~flag], 0.0)


def test_unknown_corrupt_mode_raises():
    for mod in (jf, tf):
        cfg = mod.FaultConfig(corrupt_mode="bitflip")
        with pytest.raises(ValueError, match="corrupt_mode"):
            fp = cfg.params() if mod is jf else cfg.params("cpu")
            mod.corrupt_deltas(jnp.ones((2, 3)) if mod is jf
                               else torch.ones(2, 3),
                               (jnp if mod is jf else torch).ones(2) > 0,
                               fp, cfg)


@pytest.mark.parametrize("rate", [0.0, 0.37, 1.0, 5.0])
def test_scale_params_matches_jax(rate):
    jc, tc = both(p_fail=0.4, p_recover=0.6, p_crash=0.3, p_loss=0.9,
                  backoff=3.0, p_corrupt=0.2, corrupt_scale=50.0)
    want = jf.scale_params(jc.params(), rate)
    got = tf.scale_params(tc.params("cpu"), rate)
    for name in jf.FaultParams._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.float32 and g.dim() == 0
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_params_live_on_the_given_device():
    fp = tf.FaultConfig(p_fail=0.1).params("cpu")
    assert all(v.device.type == "cpu" and v.dtype == torch.float32
               for v in fp)
    assert tf.FaultParams._fields == jf.FaultParams._fields


def test_from_trace_matches_jax():
    rng = np.random.default_rng(3)
    avail = rng.random((30, 12)) < 0.7
    attempts = rng.integers(0, 3, (30, 12)).astype(np.float32)
    delivered = (attempts > 0) & (rng.random((30, 12)) < 0.8)
    want = jf.FaultParams.from_trace(avail, attempts, delivered)
    got = tf.FaultParams.from_trace(avail, attempts, delivered,
                                    device="cpu")
    for name in jf.FaultParams._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    jcfg = jf.FaultConfig.from_trace(avail, attempts, delivered,
                                     max_retries=2, p_corrupt=0.01)
    tcfg = tf.FaultConfig.from_trace(avail, attempts, delivered,
                                     max_retries=2, p_corrupt=0.01)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    # the degenerate traces keep the clean defaults
    for a in (np.ones((6, 3), bool), np.zeros((6, 3), bool)):
        w = jf.FaultParams.from_trace(a)
        g = tf.FaultParams.from_trace(a, device="cpu")
        assert float(g.p_fail) == float(w.p_fail)
        assert float(g.p_recover) == float(w.p_recover)


@pytest.mark.parametrize("kw,match", [
    (dict(avail=np.ones(10, bool)), r"\[T, K\]"),
    (dict(avail=np.ones((4, 2), bool), attempts=np.ones((4, 2))),
     "together"),
    (dict(avail=np.ones((4, 2), bool), attempts=np.ones((4, 2)),
          delivered=np.ones((4, 3), bool)), "shapes differ"),
])
def test_from_trace_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        tf.FaultParams.from_trace(**kw, device="cpu")


# ---------------------------------------------------------------------------
# the engines under faults
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    """tests/test_faults.py's ``tiny_world`` on both sides."""
    tr, te = j_make_mnist_like(jax.random.PRNGKey(0), n_train=1000,
                               n_test=300)
    clients = j_shard_noniid(jax.random.PRNGKey(1), tr, K, d=2)
    clients = [JDataset(c.x[:, :DIM], c.y, c.num_classes) for c in clients]
    te = JDataset(te.x[:, :DIM], te.y, te.num_classes)
    cell = JCell(num_clients=K)
    h = j_channel_gains(jax.random.PRNGKey(3),
                        j_sample_positions(jax.random.PRNGKey(2), cell), T).T
    params = j_init_mlp(jax.random.PRNGKey(4), dims=(DIM, 24, 10))
    return dict(clients=clients, test=te, h=h, params=params,
                t_clients=[to_torch(c) for c in clients], t_test=to_torch(te),
                t_h=torch.from_numpy(np.array(h)),
                t_params=params_from_jax(
                    jax.tree_util.tree_map(np.asarray, params), device="cpu"))


def configs(mode, guarded, **extra):
    kw = {**dict(rounds=T, local_iters=2, batch_size=8, eval_every=4,
                 eval_batch=200, data_path="device"), **extra}
    faults = dict(FAULTS, corrupt_mode=mode) if mode else None
    return (JSimConfig(faults=faults and jf.FaultConfig(**faults),
                       guards=JGuard(**GUARDS) if guarded else None, **kw),
            SimConfig(faults=faults and tf.FaultConfig(**faults),
                      guards=GuardConfig(**GUARDS) if guarded else None,
                      **kw))


def model(res):
    """The global model as numpy leaves, the port's pad columns dropped."""
    st = res.state
    g = st.global_params
    if isinstance(g, torch.Tensor):
        return jax.tree_util.tree_leaves(params_to_numpy(
            st.layout.unflatten(g)))
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(g)]


def assert_same_faulty_run(got, want, energy_rtol=E_RTOL):
    for name in ("participation", "delivered", "corrupted", "eval_rounds"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.delivered.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(got.state.last_tx),
                                  np.asarray(want.state.last_tx))
    for name in ("energy_per_client", "energy_timeline"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=energy_rtol, err_msg=name)
    pairs = [(got.test_acc, want.test_acc), (got.test_loss, want.test_loss)]
    pairs += list(zip(model(got), model(want)))
    for a, b in pairs:
        np.testing.assert_array_equal(np.isnan(a), np.isnan(np.asarray(b)))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   equal_nan=True)


CASES = {   # name: (corrupt mode, guarded, local mode)
    "unguarded-nan-continuous": ("nan", False, "continuous"),
    "unguarded-nan-participants": ("nan", False, "participants"),
    "guarded-nan-continuous": ("nan", True, "continuous"),
    "guarded-inf-participants": ("inf", True, "participants"),
    "guarded-scale-continuous": ("scale", True, "continuous"),
    "guarded-scale-participants": ("scale", True, "participants"),
}


@pytest.fixture(scope="module")
def dense_runs(world):
    """Each case through JAX's run_simulation and the port's dense engine,
    RandomScheme(0.5) as in tests/test_faults.py; plus the clean run."""
    out = {}
    for case, (mode, guarded, local) in {**CASES, "clean": (
            None, False, "continuous")}.items():
        jcfg, tcfg = configs(mode, guarded, local_mode=local)
        want = j_run_simulation(world["params"], j_mlp_loss, j_mlp_accuracy,
                                world["clients"], world["test"],
                                JRandom(0.5, K), world["h"], JCell(
                                    num_clients=K), jcfg)
        got = make_runner(mlp_loss, mlp_accuracy, world["t_clients"],
                          world["t_test"], RandomScheme(0.5, K),
                          CellConfig(num_clients=K), tcfg, device="cpu")(
            world["t_params"], world["t_h"])
        out[case] = got, want
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_dense_faulty_run_matches_jax(dense_runs, case):
    got, want = dense_runs[case]
    assert_same_faulty_run(got, want)
    assert got.corrupted.sum() >= 1                    # poison was sent
    assert (got.delivered <= got.participation).all()
    assert got.delivered.sum() < got.participation.sum()   # faults bit
    finite = all(np.isfinite(a).all() for a in model(got))
    mode, guarded, _ = CASES[case]
    assert finite == (guarded or mode == "scale")


def test_fault_streams_never_perturb_participation(dense_runs):
    clean, jclean = dense_runs["clean"]
    assert clean.delivered is None and clean.corrupted is None
    assert jclean.delivered is None
    for case in CASES:
        got, _ = dense_runs[case]
        np.testing.assert_array_equal(got.participation, clean.participation)


def test_lost_uploads_keep_their_staleness(dense_runs):
    """The ledger advances on deliveries: ``last_tx`` is each client's last
    delivered round, not its last decision."""
    got, _ = dense_runs["guarded-nan-continuous"]
    d = got.delivered > 0
    want = np.where(d.any(0), T - 1 - np.argmax(d[::-1], axis=0), 0)
    np.testing.assert_array_equal(got.state.last_tx.numpy(), want)
    p = got.participation > 0
    decided = np.where(p.any(0), T - 1 - np.argmax(p[::-1], axis=0), 0)
    assert (want != decided).any()


@pytest.mark.parametrize("mode,guarded", [("nan", False), ("nan", True),
                                          ("inf", True)])
def test_sparse_faulty_run_matches_dense_and_jax(world, mode, guarded):
    """Port sparse = port dense = JAX sparse under faults (participants
    mode, the per-client stream, bucket 8)."""
    jcfg, tcfg = configs(mode, guarded, participant_bucket=8, **SPARSE_KW)
    want = j_make_sparse_runner(j_mlp_loss, j_mlp_accuracy, world["clients"],
                                world["test"], JRandom(0.5, K),
                                JCell(num_clients=K), jcfg)(world["params"],
                                                            world["h"])
    runs = {}
    for engine in ("sparse", "dense"):
        runs[engine] = make_runner(
            mlp_loss, mlp_accuracy, world["t_clients"], world["t_test"],
            RandomScheme(0.5, K), CellConfig(num_clients=K),
            dataclasses.replace(tcfg, participation=engine),
            device="cpu")(world["t_params"], world["t_h"])
    sp, dense = runs["sparse"], runs["dense"]
    assert sp.state.client_params is None and dense.state.client_params \
        is not None
    assert_same_faulty_run(sp, want)
    assert_same_faulty_run(sp, dense)
    assert sp.corrupted.sum() >= 1


def test_faults_take_the_round_loop_of_phase_a():
    """Faults carry the availability chain: ``hoist_rounds=True`` raises as
    in JAX, and the default takes the round loop."""
    cfg = SimConfig(rounds=4, faults=tf.FaultConfig(p_fail=0.1),
                    **SPARSE_KW)
    pol = RandomScheme(0.5, K).policy_fn
    with pytest.raises(ValueError, match="hoist_rounds"):
        sparse.build_participation_program(pol, cfg, CellConfig(
            num_clients=K), K, 8, hoist_rounds=True)
    jcfg = JSimConfig(rounds=4, faults=jf.FaultConfig(p_fail=0.1),
                      **SPARSE_KW)
    import repro.fl.sparse as jsparse
    with pytest.raises(ValueError, match="hoist_rounds"):
        jsparse.build_participation_program(
            JRandom(0.5, K).policy_fn, jcfg, JCell(num_clients=K), K, 8,
            hoist_rounds=True)


def test_faults_config_is_ported():
    """``SimConfig(faults=...)`` builds on both engines (the case that
    expected ``NotImplementedError`` in tests/test_torch_engine.py)."""
    cfg = SimConfig(rounds=2, faults=tf.FaultConfig(p_loss=0.5))
    policy = RandomScheme(0.5, K)
    clients = [Dataset(torch.zeros(4, 3), torch.zeros(4, dtype=torch.int32),
                       10)] * K
    for kw in ({}, dict(participation="sparse", **SPARSE_KW)):
        make_runner(mlp_loss, mlp_accuracy, clients, clients[0], policy,
                    CellConfig(num_clients=K),
                    dataclasses.replace(cfg, **kw), device="cpu")


def test_fault_matrix_matches_jax(world):
    """run_fault_matrix at rates [0, 1] against JAX's vmapped sweep
    (tests/test_faults.py's setting, the default guard)."""
    jc, tc = both(p_loss=0.3, max_retries=1, p_corrupt=0.3,
                  corrupt_mode="nan")
    base = dict(rounds=T, local_iters=1, batch_size=8, eval_every=4,
                eval_batch=200, data_path="device")
    want = j_run_fault_matrix(world["params"], j_mlp_loss, j_mlp_accuracy,
                              world["clients"], world["test"],
                              JRandom(0.6, K), world["h"],
                              JCell(num_clients=K),
                              JSimConfig(**base, faults=jc), [0.0, 1.0])
    got = run_fault_matrix(world["t_params"], mlp_loss, mlp_accuracy,
                           world["t_clients"], world["t_test"],
                           RandomScheme(0.6, K), world["t_h"],
                           CellConfig(num_clients=K),
                           SimConfig(**base, faults=tc), [0.0, 1.0],
                           device="cpu")
    np.testing.assert_array_equal(got.rates, want.rates)
    np.testing.assert_array_equal(got.eval_rounds, want.eval_rounds)
    assert got.metrics is None
    for name in ("unguarded", "guarded"):
        np.testing.assert_array_equal(got.delivered[name],
                                      want.delivered[name])
        np.testing.assert_array_equal(got.finite_final[name],
                                      want.finite_final[name])
        np.testing.assert_allclose(got.energy[name], want.energy[name],
                                   rtol=E_RTOL)
        for field in ("acc", "loss"):
            a, b = getattr(got, field)[name], getattr(want, field)[name]
            assert a.shape == b.shape
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       equal_nan=True)
    assert got.finite_final["guarded"].all()
    assert got.finite_final["unguarded"][0]
    d = got.delivered["guarded"].sum(axis=(1, 2))
    assert d[1] <= d[0]


def test_fault_matrix_needs_faults(world):
    with pytest.raises(ValueError, match="faults"):
        run_fault_matrix(world["t_params"], mlp_loss, mlp_accuracy,
                         world["t_clients"], world["t_test"],
                         RandomScheme(0.6, K), world["t_h"],
                         CellConfig(num_clients=K), SimConfig(rounds=T),
                         [0.0], device="cpu")
