"""The port's simulation (repro_torch.fl.run_simulation on the CPU) against
the JAX package's (repro.fl.run_simulation, device data path), from the same
JAX-built datasets, channel gains and initial params.

Participation masks must match bit for bit (threefry draws are exact);
energy, accuracy and loss to the golden tolerance rtol=1e-4, atol=1e-5
(tests/golden/harness.py).  The cases cover the paper's comparison panel:
the online and offline proposed schemes, random, greedy, age-based, csma
and age-aware selection, the scheme aggregators and the guards.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import CellConfig as JCell
from repro.core import ProblemSpec as JSpec
from repro.core.channel import channel_gains as j_channel_gains
from repro.core.channel import sample_positions as j_sample_positions
import repro.core.selection as jsel
from repro.core.selection import ProposedOnline as JProposed
from repro.core.selection import RandomScheme as JRandom
from repro.data import make_mnist_like as j_make_mnist_like
from repro.data import shard_noniid as j_shard_noniid
from repro.fl import AggregatorConfig as JAgg
from repro.fl import GuardConfig as JGuard
from repro.fl import SimConfig as JSimConfig
from repro.fl import grant_forced_bandwidth as j_grant
from repro.fl import make_runner as j_make_runner
from repro.fl import run_simulation as j_run_simulation
from repro.models.small import init_mlp as j_init_mlp
from repro.models.small import mlp_accuracy as j_mlp_accuracy
from repro.models.small import mlp_loss as j_mlp_loss
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import CellConfig, ProblemSpec
import repro_torch.core.selection as tsel
from repro_torch.core.selection import ProposedOnline, RandomScheme
from repro_torch.data import Dataset
from repro_torch.fl import (AggregatorConfig, GuardConfig, SimConfig,
                            grant_forced_bandwidth, make_runner,
                            run_simulation)
from repro_torch.models.small import mlp_accuracy, mlp_loss
from repro_torch.obs import MetricsSpec

K, T = 10, 6
RTOL, ATOL = 1e-4, 1e-5


def to_torch(ds):
    return Dataset(torch.from_numpy(np.array(ds.x)),
                   torch.from_numpy(np.array(ds.y)), ds.num_classes)


@pytest.fixture(scope="module")
def world():
    """JAX-built world, handed to both sides as numpy."""
    tr, te = j_make_mnist_like(jax.random.PRNGKey(0), n_train=800, n_test=200)
    clients = j_shard_noniid(jax.random.PRNGKey(1), tr, K, d=5)
    cell = JCell(num_clients=K)
    h = j_channel_gains(jax.random.PRNGKey(3),
                        j_sample_positions(jax.random.PRNGKey(2), cell), T).T
    params = j_init_mlp(jax.random.PRNGKey(4))
    return dict(clients=clients, test=te, h=h, params=params,
                t_clients=[to_torch(c) for c in clients], t_test=to_torch(te),
                t_h=torch.from_numpy(np.array(h)),
                t_params=params_from_jax(
                    jax.tree_util.tree_map(np.asarray, params), device="cpu"))


def policies(name, world=None):
    """The JAX policy and the port's, by name."""
    if name == "proposed":
        return (JProposed(JSpec(cell=JCell(num_clients=K), rho=0.05, lam=0.01,
                                num_rounds=T)),
                ProposedOnline(ProblemSpec(cell=CellConfig(num_clients=K),
                                           rho=0.05, lam=0.01,
                                           num_rounds=T)))
    if name == "offline":
        return (jsel.ProposedOffline(JSpec(cell=JCell(num_clients=K),
                                           num_rounds=T), world["h"]),
                tsel.ProposedOffline(ProblemSpec(cell=CellConfig(
                    num_clients=K), num_rounds=T), world["t_h"],
                    device="cpu"))
    if name == "csma":
        return jsel.csma_policy(3, K), tsel.csma_policy(3, K)
    if name == "age-aware":
        return jsel.age_aware_policy(2, K), tsel.age_aware_policy(2, K)
    if name == "greedy":
        return jsel.GreedyScheme(3, K), tsel.GreedyScheme(3, K)
    if name == "age":
        return jsel.AgeBasedScheme(3, K), tsel.AgeBasedScheme(3, K)
    return JRandom(p_bar=0.1, num_clients=K), RandomScheme(p_bar=0.1,
                                                           num_clients=K)


def configs(extra):
    """JAX's and the port's SimConfig: ``guards`` and ``aggregator`` are
    given as keyword dicts and built in each package."""
    extra = dict(extra)
    g, a = extra.pop("guards", None), extra.pop("aggregator", None)
    kw = dict(rounds=T, local_iters=5, batch_size=10, eval_every=2,
              data_path="device", **extra)
    return (JSimConfig(guards=g and JGuard(**g), aggregator=a and JAgg(**a),
                       **kw),
            SimConfig(guards=g and GuardConfig(**g),
                      aggregator=a and AggregatorConfig(**a), **kw))


CASES = {
    "proposed-continuous": ("proposed", {}),
    "random-participants": ("random", dict(local_mode="participants")),
    "random-participants-client-stream": (
        "random", dict(local_mode="participants", data_stream="client")),
    "proposed-staleness3": ("proposed", dict(max_staleness=3)),
    "random-participants-staleness3-aging": (
        "random", dict(local_mode="participants", max_staleness=3,
                       aging_boost=True)),
    "csma-csmaafl": ("csma", dict(aggregator=dict(kind="csmaafl"))),
    "age-aware-age": ("age-aware", dict(aggregator=dict(kind="age"))),
    "greedy-fedasync-poly-clip": (
        "greedy", dict(aggregator=dict(kind="fedasync", staleness_fn="poly"),
                       guards=dict(clip_norm=0.05))),
    "age-staleness-guards": (
        "age", dict(guards=dict(staleness_power=0.5, staleness_cap=3))),
    "offline": ("offline", {}),
    "random-csmaafl-aging": (
        "random", dict(max_staleness=2, aging_boost=True,
                       aggregator=dict(kind="csmaafl"))),
}


def run_both(world, policy, extra):
    jpol, tpol = policies(policy, world)
    jcfg, tcfg = configs(extra)
    want = j_run_simulation(world["params"], j_mlp_loss, j_mlp_accuracy,
                            world["clients"], world["test"], jpol, world["h"],
                            JCell(num_clients=K), jcfg)
    got = run_simulation(world["t_params"], mlp_loss, mlp_accuracy,
                         world["t_clients"], world["t_test"], tpol,
                         world["t_h"], CellConfig(num_clients=K), tcfg,
                         device="cpu")
    return got, want


@pytest.mark.parametrize("case", list(CASES))
def test_simulation_matches_jax(world, case):
    got, want = run_both(world, *CASES[case])
    np.testing.assert_array_equal(got.participation, want.participation)
    np.testing.assert_array_equal(got.eval_rounds, want.eval_rounds)
    for name in ("energy_per_client", "energy_timeline", "test_acc",
                 "test_loss"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    state = got.state
    np.testing.assert_array_equal(state.last_tx.numpy(),
                                  np.asarray(want.state.last_tx))
    assert int(state.round) == int(want.state.round) == T
    for a, b in zip(jax.tree_util.tree_leaves(want.state.global_params),
                    jax.tree_util.tree_leaves(params_to_numpy(
                        state.layout.unflatten(state.global_params)))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=RTOL, atol=ATOL)
    if "staleness3" in case:
        assert (np.diff(np.r_[-1, np.nonzero(got.participation[:, 0])[0], T])
                <= 3).all()


def test_runner_is_reusable_and_seeded(world):
    jpol, tpol = policies("random")
    cfg = SimConfig(rounds=T, local_iters=1, eval_every=3)
    run = make_runner(mlp_loss, mlp_accuracy, world["t_clients"],
                      world["t_test"], tpol, CellConfig(num_clients=K), cfg,
                      device="cpu")
    a, b = run(world["t_params"], world["t_h"]), run(world["t_params"],
                                                     world["t_h"])
    np.testing.assert_array_equal(a.participation, b.participation)
    np.testing.assert_array_equal(a.test_loss, b.test_loss)
    c = run(world["t_params"], world["t_h"], seed=1)
    assert not np.array_equal(a.participation, c.participation)


@pytest.mark.parametrize("case", range(4))
def test_grant_forced_bandwidth_matches_jax(case):
    rng = np.random.default_rng(case)
    w = rng.dirichlet(np.ones(K)).astype(np.float32)
    if case == 1:           # greedy-style zero slices for unselected clients
        w[:6] = 0.0
        w /= w.sum()
    forced = rng.uniform(size=K) < [0.0, 0.3, 0.6, 1.0][case]
    got = grant_forced_bandwidth(torch.from_numpy(w), torch.from_numpy(forced),
                                 K).numpy()
    want = np.asarray(j_grant(jax.numpy.asarray(w), jax.numpy.asarray(forced),
                              K))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got.sum() <= 1.0 + 1e-6
    assert (got[forced] > 0).all()


def test_paper_kind_matches_plain_average(world):
    """JAX's test of the same name: ``AggregatorConfig("paper")`` through
    K1's weighted mode equals ``aggregator=None`` (its plain mode)."""
    runs = {}
    for agg in (None, AggregatorConfig(kind="paper")):
        cfg = SimConfig(rounds=T, local_iters=2, eval_every=2,
                        aggregator=agg)
        runs[agg] = run_simulation(world["t_params"], mlp_loss, mlp_accuracy,
                                   world["t_clients"], world["t_test"],
                                   policies("random")[1], world["t_h"],
                                   CellConfig(num_clients=K), cfg,
                                   device="cpu")
    a, b = runs.values()
    np.testing.assert_array_equal(a.participation, b.participation)
    np.testing.assert_allclose(a.state.global_params.numpy(),
                               b.state.global_params.numpy(), atol=1e-5)
    np.testing.assert_allclose(a.test_loss, b.test_loss, atol=1e-5)


@pytest.mark.parametrize("field,value", [
    ("guards", GuardConfig()), ("guards", GuardConfig(quarantine=False)),
    ("aggregator", AggregatorConfig(kind="age")),
])
def test_guards_and_aggregator_are_ported(world, field, value):
    cfg = dataclasses.replace(SimConfig(rounds=2), **{field: value})
    make_runner(mlp_loss, mlp_accuracy, world["t_clients"], world["t_test"],
                policies("random")[1], CellConfig(num_clients=K), cfg,
                device="cpu")


@pytest.mark.parametrize("field,value", [
    # faults are ported (tests/test_torch_faults.py), the data paths,
    # eval_mode, checkpoint_every and stream_chunk too
    # (tests/test_torch_datapath.py, tests/test_torch_resume.py), and now
    # metrics (tests/test_torch_obs.py); the metrics case keeps the id it
    # had when it expected NotImplementedError
    pytest.param("metrics", MetricsSpec(), id="metrics-value1"),
])
def test_unported_settings_raise(world, field, value):
    """No setting is left unported: the last one that raised now runs and
    fills ``SimResult.metrics``."""
    cfg = dataclasses.replace(SimConfig(rounds=2), **{field: value})
    res = make_runner(mlp_loss, mlp_accuracy, world["t_clients"],
                      world["t_test"], policies("random")[1],
                      CellConfig(num_clients=K), cfg, device="cpu")(
        world["t_params"], world["t_h"][:, :2])
    np.testing.assert_array_equal(res.metrics.tx_count,
                                  res.participation.sum(axis=0))
    assert int(res.metrics.rounds) == 2


@pytest.mark.parametrize("extra,error", [
    # JAX: the sparse path implements the participants local mode only
    (dict(participation="sparse", data_stream="client"), "participants"),
    # JAX: the per-client stream is defined on the device data path only
    (dict(data_path="prestack", data_stream="client"), "device data path"),
    # JAX: the dense engine takes the sparse-only settings and ignores them
    (dict(participant_bucket=8), None),
    (dict(overflow="error"), None),
])
def test_sparse_settings_behave_as_in_jax(world, extra, error):
    """What JAX's ``make_runner`` does with the settings the sparse slice
    ported: these four cases replace ones that expected
    ``NotImplementedError``."""
    cfg = SimConfig(rounds=2, local_iters=1, **extra)
    jcfg = JSimConfig(rounds=2, local_iters=1, **extra)
    jpol, tpol = policies("random")
    args = (world["t_clients"], world["t_test"], tpol,
            CellConfig(num_clients=K), cfg)
    jargs = (world["clients"], world["test"], jpol, JCell(num_clients=K),
             jcfg)
    if error is not None:
        for build, a, kw in ((make_runner, args, dict(device="cpu")),
                             (j_make_runner, jargs, {})):
            with pytest.raises(ValueError, match=error):
                build(mlp_loss if build is make_runner else j_mlp_loss,
                      mlp_accuracy if build is make_runner
                      else j_mlp_accuracy, *a, **kw)
        return
    got = make_runner(mlp_loss, mlp_accuracy, *args, device="cpu")(
        world["t_params"], world["t_h"][:, :2])
    want = j_make_runner(j_mlp_loss, j_mlp_accuracy, *jargs)(
        world["params"], world["h"][:, :2])
    assert got.state.client_params is not None       # the dense engine ran
    np.testing.assert_array_equal(got.participation, want.participation)
    np.testing.assert_allclose(got.test_loss, want.test_loss, rtol=RTOL,
                               atol=ATOL)


def test_unknown_local_mode_raises(world):
    with pytest.raises(ValueError, match="local_mode"):
        make_runner(mlp_loss, mlp_accuracy, world["t_clients"],
                    world["t_test"], policies("random")[1],
                    CellConfig(num_clients=K),
                    SimConfig(local_mode="sometimes"), device="cpu")
