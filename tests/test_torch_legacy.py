"""The port's legacy host round loop (repro_torch.fl.simulator.
run_simulation_legacy) on the CPU, held against the JAX package's
``run_simulation_legacy`` and against the port's dense engine, from the same
JAX-built data, channel gains and initial params.

Masks, deliveries, corruptions, ``last_tx`` and eval rounds are held bit for
bit; energy, accuracy, loss and the model at the golden rtol 1e-4, atol
1e-5 (tests/golden/harness.py).  Cases: the device, prestack and stream
data paths, Δ_k forcing with the aging boost, protocol-only rounds, the
participants mode on the per-client stream, the fault cocktail of
tests/test_faults.py with guards, a scheme aggregator, and all of them at
once with every metrics tap on (the taps against JAX's legacy loop at
tests/test_obs.py's rtol 1e-5, atol 1e-6).  The world is
tests/test_engine_parity.py's ``tiny_world`` (K 5, 64 features, a 64-24-10
MLP).
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import jax
import numpy as np
import pytest
import torch

import repro.core.selection as jsel
import repro.fl.faults as jf
from repro.fl import AggregatorConfig as JAgg
from repro.fl import GuardConfig as JGuard
from repro.fl import SimConfig as JSimConfig
from repro.fl import run_simulation_legacy as j_run_simulation_legacy
from repro.models.small import mlp_accuracy as j_mlp_accuracy
from repro.models.small import mlp_loss as j_mlp_loss
from repro.obs import MetricsSpec as JSpec
import repro_torch.core.selection as tsel
import repro_torch.fl.faults as tf
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import CellConfig
from repro_torch.data import Dataset
from repro_torch.fl import (AggregatorConfig, GuardConfig, SimConfig,
                            init_fl_state, make_round_fn, run_simulation,
                            run_simulation_legacy)
from repro_torch.models.small import mlp_accuracy, mlp_loss
from repro_torch.obs import MetricsSpec, init_metrics
from repro_torch.optim import sgd

from test_engine_parity import tiny_world

K, T = 5, 10
RTOL, ATOL = 1e-4, 1e-5        # tests/golden/harness.py
M_RTOL, M_ATOL = 1e-5, 1e-6    # tests/test_obs.py: assert_metrics_agree
# tests/test_faults.py's FAULTS with the diurnal modulation on
FAULTS = dict(p_fail=0.2, p_recover=0.5, diurnal_amp=0.5, p_crash=0.1,
              p_loss=0.2, max_retries=1, backoff=2.0, p_corrupt=0.25,
              corrupt_mode="nan")
GUARDS = dict(quarantine=True, clip_norm=10.0, staleness_power=0.5)
BASE = dict(rounds=T, local_iters=2, batch_size=8, eval_every=3,
            eval_batch=200)

CASES = {   # name: (policy, SimConfig keywords)
    "device": ("random", dict(data_path="device")),
    "prestack": ("random", dict(data_path="prestack")),
    "stream": ("random", dict(data_path="stream")),
    "staleness-aging": ("random-0.05", dict(
        data_path="device", local_iters=1, max_staleness=2,
        aging_boost=True)),
    "protocol-only-prestack": ("random", dict(data_path="prestack",
                                              local_iters=0)),
    "participants-client-stream": ("csma", dict(
        data_path="device", local_mode="participants",
        data_stream="client")),
    "faults-guards": ("random-0.5", dict(data_path="device", faults=FAULTS,
                                         guards=GUARDS)),
    "scheme-csmaafl": ("csma", dict(
        data_path="device", max_staleness=3,
        aggregator=dict(kind="csmaafl", staleness_fn="hinge"))),
    "all-tapped": ("age-aware", dict(
        data_path="stream", local_mode="participants", faults=FAULTS,
        guards=GUARDS, aggregator=dict(kind="age"), metrics=True)),
}


def to_torch(ds):
    return Dataset(torch.from_numpy(np.array(ds.x)),
                   torch.from_numpy(np.array(ds.y)), ds.num_classes)


@pytest.fixture(scope="module")
def world():
    clients, te, cell, h, params = tiny_world(K=K, rounds=T)
    return dict(clients=clients, test=te, cell=cell, h=h, params=params,
                t_clients=[to_torch(c) for c in clients], t_test=to_torch(te),
                t_h=torch.from_numpy(np.array(h)),
                t_params=params_from_jax(
                    jax.tree_util.tree_map(np.asarray, params), device="cpu"))


def policies(name):
    """The JAX policy and the port's, by name."""
    if name == "csma":
        return jsel.csma_policy(3, K), tsel.csma_policy(3, K)
    if name == "age-aware":
        return jsel.age_aware_policy(2, K), tsel.age_aware_policy(2, K)
    p = {"random": 0.4, "random-0.05": 0.05, "random-0.5": 0.5}[name]
    return jsel.RandomScheme(p, K), tsel.RandomScheme(p, K)


def configs(extra):
    """JAX's and the port's SimConfig; faults, guards, aggregator and
    metrics built in each package."""
    kw = {**BASE, **extra}
    f, g, a, m = (kw.pop(k, None) for k in ("faults", "guards",
                                            "aggregator", "metrics"))
    return (JSimConfig(faults=f and jf.FaultConfig(**f),
                       guards=g and JGuard(**g), aggregator=a and JAgg(**a),
                       metrics=JSpec() if m else None, **kw),
            SimConfig(faults=f and tf.FaultConfig(**f),
                      guards=g and GuardConfig(**g),
                      aggregator=a and AggregatorConfig(**a),
                      metrics=MetricsSpec() if m else None, **kw))


@pytest.fixture(scope="module")
def runs(world):
    """Each case's port legacy run, computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            pol, extra = CASES[name]
            cache[name] = run_simulation_legacy(
                world["t_params"], mlp_loss, mlp_accuracy,
                world["t_clients"], world["t_test"], policies(pol)[1],
                world["t_h"], CellConfig(num_clients=K), configs(extra)[1],
                device="cpu")
        return cache[name]

    return get


def model(res):
    """The global model as numpy leaves, the port's pad columns dropped."""
    st = res.state
    g = st.global_params
    if isinstance(g, torch.Tensor):
        return jax.tree_util.tree_leaves(params_to_numpy(
            st.layout.unflatten(g)))
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(g)]


def assert_same_run(got, want):
    for name in ("participation", "eval_rounds", "delivered", "corrupted"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    np.testing.assert_array_equal(np.asarray(got.state.last_tx),
                                  np.asarray(want.state.last_tx))
    pairs = [(getattr(got, n), getattr(want, n), n) for n in (
        "energy_per_client", "energy_timeline", "test_acc", "test_loss")]
    pairs += [(a, b, "model") for a, b in zip(model(got), model(want))]
    for a, b, name in pairs:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        assert np.isfinite(a).all() and np.isfinite(b).all(), name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("name", list(CASES))
def test_legacy_matches_jax_legacy(world, runs, name):
    pol, extra = CASES[name]
    jcfg, _ = configs(extra)
    want = j_run_simulation_legacy(world["params"], j_mlp_loss,
                                   j_mlp_accuracy, world["clients"],
                                   world["test"], policies(pol)[0],
                                   world["h"], world["cell"], jcfg)
    got = runs(name)
    assert_same_run(got, want)
    if jcfg.faults is not None:
        assert got.corrupted.sum() >= 1 and got.delivered.dtype == np.float32
    assert (got.metrics is None) == (want.metrics is None)
    if got.metrics is not None:
        for f, a in got.metrics._asdict().items():
            b = getattr(want.metrics, f)
            assert (a is None) == (b is None), f
            if a is None:
                continue
            b = np.asarray(b)
            assert a.dtype == b.dtype, f
            if np.issubdtype(b.dtype, np.integer):
                np.testing.assert_array_equal(a, b, err_msg=f)
            else:
                np.testing.assert_allclose(a, b, rtol=M_RTOL, atol=M_ATOL,
                                           err_msg=f)


@pytest.mark.parametrize("name", list(CASES))
def test_legacy_matches_the_dense_engine(world, runs, name):
    """The host loop is the engine's witness: the same masks, deliveries
    and ledgers bit for bit, the floats to the golden tolerance (the
    engine solves a state-free policy once for every round and sums the
    energy ledger in torch, the loop in numpy)."""
    pol, extra = CASES[name]
    got = runs(name)
    dense = run_simulation(world["t_params"], mlp_loss, mlp_accuracy,
                           world["t_clients"], world["t_test"],
                           policies(pol)[1], world["t_h"],
                           CellConfig(num_clients=K), configs(extra)[1],
                           device="cpu")
    assert dense.state.client_params is not None
    assert_same_run(got, dense)
    if got.metrics is not None:
        for f, a in got.metrics._asdict().items():
            b = getattr(dense.metrics, f)
            if a is not None and np.issubdtype(a.dtype, np.integer):
                np.testing.assert_array_equal(a, b, err_msg=f)


def test_legacy_refuses_what_jax_refuses(world):
    """The per-client stream is defined on the device data path only."""
    jcfg, cfg = configs(dict(data_path="prestack", data_stream="client"))
    with pytest.raises(ValueError, match="device data path"):
        j_run_simulation_legacy(world["params"], j_mlp_loss, j_mlp_accuracy,
                                world["clients"], world["test"],
                                policies("random")[0], world["h"],
                                world["cell"], jcfg)
    with pytest.raises(ValueError, match="device data path"):
        run_simulation_legacy(world["t_params"], mlp_loss, mlp_accuracy,
                              world["t_clients"], world["t_test"],
                              policies("random")[1], world["t_h"],
                              CellConfig(num_clients=K), cfg, device="cpu")


def test_make_round_fn_returns_the_train_taps(world):
    """With a train tap on, the transition takes and returns the running
    MetricsState; untapped it returns the bare state."""
    spec = MetricsSpec()
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0])
    xb = torch.stack([c.x[:8] for c in world["t_clients"]])[:, None]
    yb = torch.stack([c.y[:8] for c in world["t_clients"]])[:, None]
    state = init_fl_state(world["t_params"], K, device="cpu")
    plain = make_round_fn(mlp_loss, sgd(0.01), 1, K, device="cpu")
    tapped = make_round_fn(mlp_loss, sgd(0.01), 1, K, metrics=spec,
                           device="cpu")
    a = plain(state, mask, xb, yb)
    b, ms = tapped(state, mask, xb, yb,
                   mstate=init_metrics(spec, K, parts="train",
                                       device="cpu"))
    assert torch.equal(a.global_params, b.global_params)
    assert int(ms.agg_rounds) == 1 and ms.tx_count is None
    # three delivered rows of weight 1/K each: the entropy of 1/3 thrice
    np.testing.assert_allclose(float(ms.weight_entropy), np.log(3.0),
                               rtol=1e-6)
    np.testing.assert_allclose(float(ms.weight_max), 1.0 / K, rtol=1e-6)
