"""The port's sparse two-phase engine (repro_torch.fl.sparse) on the CPU,
held three ways: port sparse, port dense (participants mode, per-client
stream) and the JAX package's sparse engine, from the same JAX-built data,
channel gains and initial params.

Integers are exact: masks, ``last_tx``, the participant index sets, anchor
slots, staleness and eval rounds.  Energy is held at rtol 1e-6 (JAX's own
sparse↔dense tolerance, tests/test_sparse_engine.py); accuracy, loss and
the model at the golden rtol 1e-4, atol 1e-5.  Also: hoisted against
round-by-round phase A, the bucket heuristics and the spill path, the
config errors, one phase-B build across a population sweep, and no K-sized
tensor anywhere in phase B.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import repro.core.selection as jsel
import repro.fl.sparse as jsparse
from repro.core import CellConfig as JCell
from repro.core.channel import channel_gains as j_channel_gains
from repro.core.channel import sample_positions as j_sample_positions
from repro.data import make_mnist_like as j_make_mnist_like
from repro.data import shard_noniid as j_shard_noniid
from repro.fl import AggregatorConfig as JAgg
from repro.fl import GuardConfig as JGuard
from repro.fl import SimConfig as JSimConfig
from repro.fl import make_runner as j_make_runner
from repro.models.small import init_mlp as j_init_mlp
from repro.models.small import mlp_accuracy as j_mlp_accuracy
from repro.models.small import mlp_loss as j_mlp_loss
import repro_torch.core.selection as tsel
from repro_torch import random as jr
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import CellConfig
from repro_torch.data import Dataset, DeviceDataStore
from repro_torch.fl import (AggregatorConfig, GuardConfig, SimConfig,
                            make_runner, make_sparse_runner,
                            resolve_participation)
from repro_torch.fl import sparse
from repro_torch.models.small import init_mlp, mlp_accuracy, mlp_loss
from repro_torch.optim import sgd

K, DIM = 8, 64
RTOL, ATOL = 1e-4, 1e-5        # tests/golden/harness.py
E_RTOL = 1e-6                  # energy: tests/test_sparse_engine.py
SPARSE_KW = dict(local_mode="participants", data_path="device",
                 data_stream="client")


def to_torch(ds):
    return Dataset(torch.from_numpy(np.array(ds.x)),
                   torch.from_numpy(np.array(ds.y)), ds.num_classes)


@pytest.fixture(scope="module")
def world():
    """tests/test_sparse_engine.py's ``mnist_world`` (K 8, inputs cut to 64
    features, a 64-24-10 MLP), 12 rounds of gains, on both sides."""
    tr, te = j_make_mnist_like(jax.random.PRNGKey(0), n_train=1200,
                               n_test=300)
    clients = j_shard_noniid(jax.random.PRNGKey(1), tr, K, d=5)
    clients = [type(c)(c.x[:, :DIM], c.y, c.num_classes) for c in clients]
    te = type(te)(te.x[:, :DIM], te.y, te.num_classes)
    cell = JCell(num_clients=K)
    h = j_channel_gains(jax.random.PRNGKey(3),
                        j_sample_positions(jax.random.PRNGKey(2), cell), 12).T
    params = j_init_mlp(jax.random.PRNGKey(4), dims=(DIM, 24, 10))
    return dict(clients=clients, test=te, h=h, params=params,
                t_clients=[to_torch(c) for c in clients], t_test=to_torch(te),
                t_h=torch.from_numpy(np.array(h)),
                t_params=params_from_jax(
                    jax.tree_util.tree_map(np.asarray, params), device="cpu"))


def policies(name):
    """The JAX policy and the port's, by name."""
    if name == "random-0.1":
        return jsel.RandomScheme(0.1, K), tsel.RandomScheme(0.1, K)
    if name == "age-aware":
        return jsel.age_aware_policy(2, K), tsel.age_aware_policy(2, K)
    if name == "csma":
        return jsel.csma_policy(3, K), tsel.csma_policy(3, K)
    return jsel.RandomScheme(0.4, K), tsel.RandomScheme(0.4, K)


def configs(extra):
    """JAX's and the port's SimConfig; ``guards`` and ``aggregator`` as
    keyword dicts built in each package."""
    extra = dict(extra)
    g, a = extra.pop("guards", None), extra.pop("aggregator", None)
    kw = {**dict(local_iters=2, batch_size=8, eval_every=3, eval_batch=200,
                 **SPARSE_KW), **extra}
    return (JSimConfig(guards=g and JGuard(**g), aggregator=a and JAgg(**a),
                       **kw),
            SimConfig(guards=g and GuardConfig(**g),
                      aggregator=a and AggregatorConfig(**a), **kw))


CASES = {   # name: (policy, config), each run dense and sparse
    "random-hoisted": ("random", dict(rounds=10, participant_bucket=8)),
    "random-staleness-scan": (
        "random-0.1", dict(rounds=12, local_iters=1, eval_every=4,
                           max_staleness=3, aging_boost=True,
                           participant_bucket=8)),
    "age-aware-ledger": ("age-aware", dict(rounds=10)),
    "random-guarded": (
        "random", dict(rounds=10, participant_bucket=8,
                       guards=dict(quarantine=True, clip_norm=0.05,
                                   staleness_power=0.5))),
    "csma-csmaafl-scheme": (
        "csma", dict(rounds=10, aggregator=dict(kind="csmaafl",
                                                staleness_fn="hinge"))),
}


def assert_same_run(got, want, model_got, model_want, energy_rtol):
    np.testing.assert_array_equal(got.participation, want.participation)
    np.testing.assert_array_equal(got.eval_rounds, want.eval_rounds)
    np.testing.assert_array_equal(np.asarray(got.state.last_tx),
                                  np.asarray(want.state.last_tx))
    for name in ("energy_per_client", "energy_timeline"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=energy_rtol, err_msg=name)
    for name in ("test_acc", "test_loss"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    for a, b in zip(jax.tree_util.tree_leaves(model_got),
                    jax.tree_util.tree_leaves(model_want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


def port_model(res):
    st = res.state
    return params_to_numpy(st.layout.unflatten(st.global_params))


@pytest.mark.parametrize("case", list(CASES))
def test_sparse_matches_dense_and_jax(world, case):
    policy, extra = CASES[case]
    jpol, tpol = policies(policy)
    jcfg, tcfg = configs(extra)
    T = tcfg.rounds
    h, th = world["h"][:, :T], world["t_h"][:, :T]
    want = j_make_runner(j_mlp_loss, j_mlp_accuracy, world["clients"],
                         world["test"], jpol, JCell(num_clients=K),
                         dataclasses.replace(jcfg, participation="sparse"))(
        world["params"], h)
    runs = {}
    for mode in ("sparse", "dense"):
        runs[mode] = make_runner(
            mlp_loss, mlp_accuracy, world["t_clients"], world["t_test"],
            tpol, CellConfig(num_clients=K),
            dataclasses.replace(tcfg, participation=mode),
            device="cpu")(world["t_params"], th)
    sp, dense = runs["sparse"], runs["dense"]
    assert sp.state.client_params is None          # the sparse engine's
    assert dense.state.client_params is not None
    assert_same_run(sp, want, port_model(sp), want.state.global_params,
                    E_RTOL)
    assert_same_run(sp, dense, port_model(sp), port_model(dense), E_RTOL)
    # training moved the model, so the agreement is not vacuous
    assert any(np.abs(a - np.asarray(b)).max() > 0 for a, b in zip(
        jax.tree_util.tree_leaves(port_model(sp)),
        jax.tree_util.tree_leaves(world["params"])))
    if "staleness" in case:
        gaps = np.diff(np.r_[-1, np.nonzero(sp.participation[:, 0])[0], T])
        assert (gaps <= 3).all()


def phase_a_pair(policy, jcfg, tcfg, h, bucket, hoist=None, seed=7):
    """Phase A of both packages on the same gains and key."""
    jpol, tpol = policy
    n = h.shape[0]
    jprog = jsparse.build_participation_program(
        jsel.as_policy_fn(jpol), jcfg, JCell(num_clients=n), n, bucket)
    want = jax.jit(jprog)(jnp.swapaxes(jnp.asarray(h), 0, 1),
                          jax.random.PRNGKey(seed))
    tprog = sparse.build_participation_program(
        tsel.as_policy_fn(tpol), tcfg, CellConfig(num_clients=n), n, bucket,
        hoist_rounds=hoist)
    got = tprog(torch.from_numpy(np.array(h)).T, jr.PRNGKey(seed))
    return got, want


def assert_same_phase_a(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=E_RTOL)
    for name in sparse.ParticipationTrace._fields:
        a, b = getattr(got[2], name), getattr(want[2], name)
        if a is None:
            assert b is None, name
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=E_RTOL, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_phase_a_matches_jax(world, case):
    """Index sets (ascending, padded with K), anchor slots, staleness,
    validity and n_tx bit for bit; energies and probabilities to rtol
    1e-6."""
    policy, extra = CASES[case]
    jcfg, tcfg = configs(extra)
    got, want = phase_a_pair(policies(policy), jcfg, tcfg,
                             world["h"][:, :tcfg.rounds],
                             tcfg.participant_bucket or 8)
    assert_same_phase_a(got, want)
    assert int(got[2].n_tx.sum()) > 0


def big_world(n, T, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(1e-14, 1e-12, (n, T)).astype(np.float32)


@pytest.mark.parametrize("policy", ["random", "csma"])
def test_hoisted_phase_a_matches_round_by_round(policy):
    """State-free policies with no staleness forcing take the full hoist:
    its integers equal the round-by-round path's, its energy to rtol 1e-6,
    and both equal JAX's (hoisted) phase A; the bucket overflows in some
    rounds, so truncation is held too."""
    n, T, bucket = 48, 30, 8
    pols = ((jsel.RandomScheme(0.15, n), tsel.RandomScheme(0.15, n))
            if policy == "random"
            else (jsel.csma_policy(6, n), tsel.csma_policy(6, n)))
    jcfg = JSimConfig(rounds=T, local_iters=1, batch_size=4)
    tcfg = SimConfig(rounds=T, local_iters=1, batch_size=4)
    h = big_world(n, T)
    hoisted, want = phase_a_pair(pols, jcfg, tcfg, h, bucket, hoist=True)
    serial, _ = phase_a_pair(pols, jcfg, tcfg, h, bucket, hoist=False)
    assert_same_phase_a(hoisted, want)
    assert_same_phase_a(serial, want)
    assert int(hoisted[2].n_tx.max()) > bucket      # truncation exercised


def test_hoist_refuses_sequential_state():
    cell = CellConfig(num_clients=K)
    cfg = SimConfig(rounds=5, max_staleness=3)
    with pytest.raises(ValueError, match="hoist_rounds"):
        sparse.build_participation_program(tsel.random_policy(0.5, K), cfg,
                                           cell, K, 8, hoist_rounds=True)
    with pytest.raises(ValueError, match="hoist_rounds"):   # a ledger policy
        sparse.build_participation_program(tsel.age_aware_policy(2, K),
                                           SimConfig(rounds=5), cell, K, 8,
                                           hoist_rounds=True)

    def stateful(t, h_t, state):
        return torch.zeros_like(h_t), torch.zeros_like(h_t)

    with pytest.raises(ValueError, match="state_free or ledger"):
        sparse.build_participation_program(stateful, SimConfig(rounds=5),
                                           cell, K, 8)


@pytest.mark.parametrize("name,n", [("random", 8), ("random", 1000),
                                    ("csma", 64), ("age-aware", 8)])
def test_auto_bucket_matches_jax(world, name, n):
    if name == "random":
        pols = (jsel.random_policy(0.4, n), tsel.random_policy(0.4, n))
    elif name == "csma":
        pols = (jsel.csma_policy(20, n), tsel.csma_policy(20, n))
    else:
        pols = (jsel.age_aware_policy(2, n), tsel.age_aware_policy(2, n))
    h = big_world(n, 6) if n != K else np.asarray(world["h"])[:, :6]
    want = jsparse._auto_bucket(pols[0], jnp.swapaxes(jnp.asarray(h), 0, 1),
                                JSimConfig(rounds=6), n)
    got = sparse._auto_bucket(pols[1], torch.from_numpy(np.array(h)).T,
                              SimConfig(rounds=6), n)
    assert got == want


def run_port(world, cfg, policy=None):
    return make_runner(mlp_loss, mlp_accuracy, world["t_clients"],
                       world["t_test"],
                       policy or tsel.RandomScheme(1.0, K),
                       CellConfig(num_clients=K), cfg, device="cpu")


def test_spill_regrows_the_bucket_and_warns_once(world, monkeypatch):
    """Every client transmits every round: a bucket of 3 spills to 8 (3 → 6
    → 12, capped at K), warns once per process, and equals a run given a
    bucket of 8 bit for bit."""
    monkeypatch.setattr(sparse, "_SPILL_WARNED", False)
    base = dict(rounds=4, local_iters=1, batch_size=8, eval_every=2,
                eval_batch=200, participation="sparse", **SPARSE_KW)
    small = run_port(world, SimConfig(**base, participant_bucket=3))
    exact = run_port(world, SimConfig(**base, participant_bucket=8))
    with pytest.warns(RuntimeWarning, match="regrowing the bucket to 8"):
        a = small(world["t_params"], world["t_h"][:, :4])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b = small(world["t_params"], world["t_h"][:, :4])
    c = exact(world["t_params"], world["t_h"][:, :4])
    for res in (a, b):
        np.testing.assert_array_equal(res.participation, c.participation)
        assert res.participation.sum() == 4 * K
        np.testing.assert_array_equal(res.state.global_params.numpy(),
                                      c.state.global_params.numpy())


def test_overflow_error_is_a_hard_error(world):
    cfg = SimConfig(rounds=6, local_iters=1, batch_size=8, eval_batch=200,
                    **SPARSE_KW, participation="sparse", participant_bucket=4,
                    overflow="error")
    with pytest.raises(RuntimeError, match="bucket overflow"):
        run_port(world, cfg)(world["t_params"], world["t_h"][:, :6])


@pytest.mark.parametrize("bad,match", [
    (dict(local_mode="continuous"), "participants"),
    (dict(data_stream="round"), "per-client stream"),
    (dict(overflow="sometimes"), "overflow policy"),
    (dict(eval_mode="replay"), "replay"),
])
def test_sparse_runner_config_errors(world, bad, match):
    """JAX's ``make_sparse_runner`` errors (repro/fl/sparse.py:524-539),
    whether the runner is asked for directly or through ``make_runner``."""
    cfg = SimConfig(rounds=4, **{**SPARSE_KW, "participation": "sparse",
                                 **bad})
    with pytest.raises(ValueError, match=match):
        make_sparse_runner(mlp_loss, mlp_accuracy, world["t_clients"],
                           world["t_test"], tsel.RandomScheme(0.4, K),
                           CellConfig(num_clients=K), cfg, device="cpu")
    with pytest.raises(ValueError, match=match):
        run_port(world, cfg)


@pytest.mark.parametrize("extra,match", [
    (dict(data_path="prestack", data_stream="client"), "device data path"),
    (dict(data_path="stream", data_stream="round", participation="sparse"),
     "device store"),
    (dict(participation="sometimes"), "unknown participation"),
    (dict(data_path="tape"), "unknown data_path"),
])
def test_make_runner_dispatch_errors(world, extra, match):
    with pytest.raises(ValueError, match=match):
        run_port(world, SimConfig(rounds=4, **{**SPARSE_KW, **extra}))


def test_resolve_participation_auto_rules():
    """JAX's test of the same name, on the port."""
    fn = tsel.random_policy(0.3, 4)
    ok = SimConfig(**SPARSE_KW, participation="auto")
    assert resolve_participation(ok, fn, "device", 4) == "sparse"
    for bad in (dict(local_mode="continuous"), dict(data_stream="round")):
        cfg = SimConfig(**{**SPARSE_KW, **bad, "participation": "auto"})
        assert resolve_participation(cfg, fn, "device", 4) == "dense"
    assert resolve_participation(ok, fn, "prestack", 4) == "dense"
    assert resolve_participation(ok, tsel.age_aware_policy(1, 4), "device",
                                 4) == "sparse"

    def stateful(t, h_t, state):
        return torch.zeros_like(h_t), torch.zeros_like(h_t)

    assert resolve_participation(ok, stateful, "device", 4) == "dense"
    dense = dataclasses.replace(ok, participation="dense")
    assert resolve_participation(dense, fn, "device", 4) == "dense"


def test_auto_participation_dispatches_to_sparse(world):
    cfg = SimConfig(rounds=4, local_iters=1, eval_every=2, eval_batch=200,
                    participant_bucket=8, participation="auto", **SPARSE_KW)
    res = run_port(world, cfg, tsel.RandomScheme(0.4, K))(
        world["t_params"], world["t_h"][:, :4])
    assert res.state.client_params is None and res.state.round == 4


def store_world(n, T, dim=12, n_per=6, classes=10):
    """A K-scalable store built in bulk (tests/test_sparse_engine.py's
    ``synth_world``, from numpy), its test set and gains."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((n, n_per, dim),
                                             dtype=np.float32))
    y = torch.from_numpy(np.tile(np.arange(n_per, dtype=np.int32) % classes,
                                 (n, 1)))
    store = DeviceDataStore(x, y, torch.full((n,), n_per, dtype=torch.int32))
    test = Dataset(x[:64, 0], y[:64, 0], classes)
    return store, test, big_world(n, T, seed=n)


def test_one_build_per_bucket_across_a_population_sweep():
    """K ∈ {64, 256, 1024} at a fixed expected transmitting count share the
    bucket 16: phase B is built once for the sweep, and a pre-built store
    on the runner's device is taken as it is."""
    T, E, bucket = 6, 4, 16
    cfg = SimConfig(rounds=T, local_iters=2, batch_size=4, eval_every=3,
                    eval_batch=63, participation="sparse",
                    participant_bucket=bucket, **SPARSE_KW)
    params = init_mlp(jr.PRNGKey(4), dims=(12, 8, 10), device="cpu")
    before = sparse.train_trace_count()
    for n in (64, 256, 1024):
        store, test, h = store_world(n, T)
        runner = make_sparse_runner(
            mlp_loss, mlp_accuracy, store, test, tsel.RandomScheme(E / n, n),
            CellConfig(num_clients=n), cfg, device="cpu")
        assert runner.store is store
        res = runner(params, torch.from_numpy(h))
        assert res.participation.shape == (T, n)
        assert np.isfinite(res.test_acc).all()
        assert res.participation.sum(axis=1).max() <= bucket
    assert sparse.train_trace_count() - before == 1


def test_a_store_on_another_device_is_refused():
    store, test, _ = store_world(16, 2)
    with pytest.raises(ValueError, match="lies on cpu"):
        make_sparse_runner(mlp_loss, mlp_accuracy, store, test,
                           tsel.RandomScheme(0.5, 16),
                           CellConfig(num_clients=16),
                           SimConfig(rounds=2, **SPARSE_KW))   # the card


class ShapeLog(TorchDispatchMode):
    """Every shape an op takes or makes."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("agg", [None, "age"])
def test_phase_b_has_no_population_sized_tensor(agg):
    """At a prime K (1031) no tensor of phase B has a K-sized axis, the
    weighted aggregators' included: the population enters as a number."""
    n, T, P, L, B, dim = 1031, 4, 16, 2, 4, 12
    cfg = SimConfig(rounds=T, local_iters=L, batch_size=B, eval_every=2,
                    aggregator=agg and AggregatorConfig(kind=agg),
                    guards=agg and GuardConfig(clip_norm=1.0), **SPARSE_KW)
    program = sparse.build_sparse_train_program(
        mlp_loss, mlp_accuracy, sgd(cfg.lr), cfg)
    gen = torch.Generator().manual_seed(0)
    params = init_mlp(jr.PRNGKey(0), dims=(dim, 8, 10), device="cpu")
    args = (params, torch.randn(T, P, L, B, dim, generator=gen),
            torch.randint(0, 10, (T, P, L, B), generator=gen,
                          dtype=torch.int32),
            torch.rand(T, P, generator=gen) < 0.5,
            torch.randint(0, T, (T, P), generator=gen, dtype=torch.int32),
            n, torch.randn(64, dim, generator=gen),
            torch.randint(0, 10, (64,), generator=gen, dtype=torch.int32))
    log = ShapeLog()
    with log:
        g, (acc, loss, did) = program(*args)
    assert log.shapes and did.tolist() == [True, False, True, True]
    assert not [s for s in log.shapes if n in s]
    assert max(int(np.prod(s)) for s in log.shapes) <= T * P * L * B * dim
    assert torch.isfinite(g).all()
