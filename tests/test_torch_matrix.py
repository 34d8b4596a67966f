"""The port's matrix sweeps against the JAX package's on the CPU: the seed
and scenario matrices (repro_torch.fl.engine), the scheme matrix on the
dense and the sparse path (repro_torch.fl.schemes), with JAX's result types
and leading axes.

JAX ``vmap``s every lane into one program, each blending the whole policy
panel with a one-hot row; the port runs each lane through the single-run
engine with its own policy.  Held here: the lanes equal JAX's (masks bit
for bit, energy at rtol 1e-6, its cumulative timeline at 1e-5 as in
tests/test_scheme_parity.py, accuracy and loss at the golden rtol 1e-4,
atol 1e-5), a lane equals a single run, a lane's own policy equals the
blended one, a sparse matrix builds phase B once, and the sweeps' input
checks.  The world is tests/test_scheme_parity.py's matrix world: K 5, T 8,
a 32-16-10 MLP, severities d = 2 and 4 padded to 256, two seed lanes.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.selection as jsel
from repro.core import CellConfig as JCell
from repro.core import ProblemSpec as JSpec
from repro.core.channel import channel_gains as j_channel_gains
from repro.core.channel import sample_positions as j_sample_positions
from repro.data import Dataset as JDataset
from repro.data import make_mnist_like as j_make_mnist_like
from repro.data import shard_noniid as j_shard_noniid
from repro.data.device import from_client_datasets as j_from_client_datasets
from repro.fl import AggregatorConfig as JAgg
from repro.fl import SimConfig as JSimConfig
from repro.fl import run_scenario_matrix as j_run_scenario_matrix
from repro.fl import run_seed_matrix as j_run_seed_matrix
from repro.fl.schemes import SchemeSpec as JSchemeSpec
from repro.fl.schemes import default_scheme_panel as j_default_scheme_panel
from repro.fl.schemes import run_scheme_matrix as j_run_scheme_matrix
from repro.models.small import init_mlp as j_init_mlp
from repro.models.small import mlp_accuracy as j_mlp_accuracy
from repro.models.small import mlp_loss as j_mlp_loss
import repro_torch.core.selection as tsel
from repro_torch.convert import params_from_jax
from repro_torch.core import CellConfig, ProblemSpec
from repro_torch.data import Dataset, from_client_datasets
from repro_torch.fl import (AggregatorConfig, MatrixResult,
                            SchemeMatrixResult, SchemeSpec, SimConfig,
                            default_scheme_panel, make_runner,
                            run_fault_matrix, run_scenario_matrix,
                            run_scheme_matrix, run_seed_matrix, stack_stores,
                            train_trace_count)
from repro_torch.fl.faults import FaultConfig
from repro_torch.models.small import mlp_accuracy, mlp_loss
from repro_torch.obs import MetricsSpec

K, T, DIM = 5, 8, 32
RTOL, ATOL = 1e-4, 1e-5        # tests/golden/harness.py
E_RTOL, TL_RTOL = 1e-6, 1e-5   # tests/test_scheme_parity.py
SEEDS = [0, 1]
BASE = dict(rounds=T, local_iters=2, batch_size=4, eval_every=2,
            local_mode="participants", data_path="device",
            data_stream="client")


def to_torch(ds):
    return Dataset(torch.from_numpy(np.array(ds.x)),
                   torch.from_numpy(np.array(ds.y)), ds.num_classes)


@pytest.fixture(scope="module")
def world():
    """tests/test_scheme_parity.py's ``_matrix_world`` on both sides."""
    tr, te = j_make_mnist_like(jax.random.PRNGKey(0), n_train=800,
                               n_test=200)
    te = JDataset(te.x[:, :DIM], te.y, te.num_classes)
    severities = []
    for d in (2, 4):
        cs = j_shard_noniid(jax.random.PRNGKey(1), tr, K, d=d)
        severities.append([JDataset(c.x[:, :DIM], c.y, c.num_classes)
                           for c in cs])
    cell = JCell(num_clients=K)
    pos = j_sample_positions(jax.random.PRNGKey(2), cell)
    h_stack = jnp.stack([j_channel_gains(jax.random.PRNGKey(30 + s), pos,
                                         T).T for s in range(2)])
    params = j_init_mlp(jax.random.PRNGKey(4), dims=(DIM, 16, 10))
    t_sev = [[to_torch(c) for c in cs] for cs in severities]
    return dict(
        severities=severities, test=te, h=h_stack, params=params,
        stores=[j_from_client_datasets(cs, pad_to=256) for cs in severities],
        t_severities=t_sev, t_test=to_torch(te),
        t_stores=[from_client_datasets(cs, device="cpu", pad_to=256)
                  for cs in t_sev],
        t_h=torch.from_numpy(np.array(h_stack)),
        t_params=params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu"))


def panels():
    """tests/test_scheme_parity.py's ``_panel`` in both packages."""
    def build(sel, spec_cls, agg_cls):
        return [
            spec_cls("paper", sel.random_policy(0.4, K),
                     agg_cls(kind="paper")),
            spec_cls("fedasync", sel.random_policy(0.4, K),
                     agg_cls(kind="fedasync", staleness_fn="poly")),
            spec_cls("csmaafl", sel.csma_policy(3, K),
                     agg_cls(kind="csmaafl")),
            spec_cls("age-aware", sel.age_aware_policy(2, K),
                     agg_cls(kind="age")),
        ]

    return (build(jsel, JSchemeSpec, JAgg),
            build(tsel, SchemeSpec, AggregatorConfig))


@pytest.fixture(scope="module")
def scheme_runs(world):
    """Both packages' scheme matrices on both paths, and the phase-B builds
    of the port's sparse one."""
    jpanel, tpanel = panels()
    out = {}
    for path in ("dense", "sparse"):
        want = j_run_scheme_matrix(world["params"], j_mlp_loss,
                                   j_mlp_accuracy, world["stores"],
                                   world["test"], jpanel, world["h"],
                                   JCell(num_clients=K), JSimConfig(**BASE),
                                   SEEDS, participation=path)
        before = train_trace_count()
        got = run_scheme_matrix(world["t_params"], mlp_loss, mlp_accuracy,
                                world["t_stores"], world["t_test"], tpanel,
                                world["t_h"], CellConfig(num_clients=K),
                                SimConfig(**BASE), SEEDS,
                                participation=path, device="cpu")
        out[path] = got, want, train_trace_count() - before
    return out


def assert_lanes_equal(got, want, fields=("acc", "loss")):
    np.testing.assert_array_equal(got.participation, want.participation)
    np.testing.assert_array_equal(got.eval_rounds, want.eval_rounds)
    np.testing.assert_allclose(got.energy, want.energy, rtol=E_RTOL)
    for name in fields:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("path", ["dense", "sparse"])
def test_scheme_matrix_matches_jax(scheme_runs, path):
    got, want, _ = scheme_runs[path]
    assert isinstance(got, SchemeMatrixResult)
    assert got.schemes == want.schemes
    assert got.acc.shape == (2, 4, 2, got.eval_rounds.size)
    assert got.participation.shape == (2, 4, 2, T, K)
    assert got.metrics is None and want.metrics is None
    assert_lanes_equal(got, want)
    np.testing.assert_allclose(got.energy_timeline, want.energy_timeline,
                               rtol=TL_RTOL)


def test_scheme_matrix_sparse_matches_dense(scheme_runs):
    dense, sparse = scheme_runs["dense"][0], scheme_runs["sparse"][0]
    assert_lanes_equal(sparse, dense)
    # the lanes are a real comparison: the schemes train differently
    assert not np.allclose(dense.loss[:, 1], dense.loss[:, 2])


def test_sparse_scheme_matrix_builds_phase_b_once(scheme_runs):
    assert scheme_runs["sparse"][2] == 1
    assert scheme_runs["dense"][2] == 0


def test_scheme_matrix_lanes_match_single_runs(world, scheme_runs):
    """Lane (v, l, s) is a single dense run with that severity, scheme and
    seed: the same numbers to the bit."""
    mat = scheme_runs["dense"][0]
    _, panel = panels()
    for v, l, s in [(0, 0, 0), (1, 2, 1), (0, 3, 1)]:
        cfg = SimConfig(**BASE, aggregator=panel[l].aggregator)
        single = make_runner(mlp_loss, mlp_accuracy, world["t_severities"][v],
                             world["t_test"], panel[l].policy,
                             CellConfig(num_clients=K), cfg, device="cpu")(
            world["t_params"], world["t_h"][s], seed=s)
        np.testing.assert_array_equal(mat.participation[v, l, s],
                                      single.participation)
        np.testing.assert_array_equal(mat.loss[v, l, s], single.test_loss)
        np.testing.assert_array_equal(mat.acc[v, l, s], single.test_acc)
        np.testing.assert_array_equal(mat.energy[v, l, s],
                                      single.energy_per_client)


def test_lane_policy_equals_the_blended_panel(world):
    """JAX's lane l runs ``policy_blend(panel, one_hot(l))``; the port runs
    policy l alone.  For a finite panel the blend is exact, so both give
    the same run (the blend is a ledger policy here, asked round by round;
    the lane's own state-free policy is solved for every round at once)."""
    _, panel = panels()
    fns = [s.policy_fn() for s in panel]
    cfg = SimConfig(**BASE)
    for l in range(len(fns)):
        sel = torch.eye(len(fns))[l]
        blend = tsel.policy_blend(fns, sel)
        assert not getattr(blend, "state_free", False)
        runs = [make_runner(mlp_loss, mlp_accuracy, world["t_severities"][0],
                            world["t_test"], pol, CellConfig(num_clients=K),
                            dataclasses.replace(
                                cfg, aggregator=panel[l].aggregator),
                            device="cpu")(world["t_params"], world["t_h"][0])
                for pol in (fns[l], blend)]
        np.testing.assert_array_equal(runs[0].participation,
                                      runs[1].participation)
        np.testing.assert_array_equal(runs[0].state.last_tx,
                                      runs[1].state.last_tx)
        for name in ("energy_per_client", "test_acc", "test_loss"):
            np.testing.assert_allclose(getattr(runs[0], name),
                                       getattr(runs[1], name), rtol=RTOL,
                                       atol=ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# the seed and scenario matrices
# ---------------------------------------------------------------------------

def test_seed_matrix_matches_jax(world):
    cfg = dict(rounds=T, local_iters=2, batch_size=4, eval_every=3,
               eval_batch=200)
    want = j_run_seed_matrix(world["params"], j_mlp_loss, j_mlp_accuracy,
                             world["severities"][0], world["test"],
                             jsel.RandomScheme(0.4, K), world["h"],
                             JCell(num_clients=K), JSimConfig(**cfg), SEEDS)
    got = run_seed_matrix(world["t_params"], mlp_loss, mlp_accuracy,
                          world["t_severities"][0], world["t_test"],
                          tsel.RandomScheme(0.4, K), world["t_h"],
                          CellConfig(num_clients=K), SimConfig(**cfg), SEEDS,
                          device="cpu")
    assert isinstance(got, MatrixResult) and got.metrics is None
    assert got.participation.shape == (2, T, K)
    assert_lanes_equal(got, want)
    np.testing.assert_allclose(got.e_round, np.asarray(want.e_round),
                               rtol=E_RTOL)
    # the lanes differ: their own gains and participation seeds
    assert not np.array_equal(got.participation[0], got.participation[1])


def test_scenario_matrix_matches_jax(world):
    """ρ ∈ {0.05, 0.2} × one lane of the paper's online scheme (two (P1')
    solves on each side)."""
    cfg = dict(rounds=T, local_iters=1, batch_size=4, eval_every=4,
               eval_batch=200)
    rhos = [0.05, 0.2]
    want = j_run_scenario_matrix(
        world["params"], j_mlp_loss, j_mlp_accuracy, world["severities"][0],
        world["test"], JSpec(cell=JCell(num_clients=K), rho=0.05,
                             num_rounds=T),
        world["h"][:1], rhos, JSimConfig(**cfg), SEEDS[:1])
    got = run_scenario_matrix(
        world["t_params"], mlp_loss, mlp_accuracy, world["t_severities"][0],
        world["t_test"], ProblemSpec(cell=CellConfig(num_clients=K),
                                     rho=0.05, num_rounds=T),
        world["t_h"][:1], rhos, SimConfig(**cfg), SEEDS[:1], device="cpu")
    assert got.participation.shape == (2, 1, T, K)
    assert_lanes_equal(got, want)
    np.testing.assert_allclose(got.e_round, np.asarray(want.e_round),
                               rtol=RTOL, atol=ATOL)
    # ρ moves the solve: the two rows spend different energy
    assert not np.allclose(got.energy[0], got.energy[1])


# ---------------------------------------------------------------------------
# helpers and input checks
# ---------------------------------------------------------------------------

def test_stack_stores_rejects_mismatched_shapes(world):
    cs = world["t_severities"][0]
    a = from_client_datasets(cs, device="cpu", pad_to=256)
    b = from_client_datasets(cs, device="cpu", pad_to=512)
    with pytest.raises(ValueError, match="pad_to"):
        stack_stores([a, b])
    stacked = stack_stores([a, a])
    assert stacked.x.shape == (2,) + tuple(a.x.shape)
    with pytest.raises(ValueError, match="pad_to"):
        from_client_datasets(cs, device="cpu", pad_to=8)


def test_default_scheme_panel_shape():
    spec = ProblemSpec(cell=CellConfig(num_clients=K), rho=0.05,
                       num_rounds=T)
    jspec = JSpec(cell=JCell(num_clients=K), rho=0.05, num_rounds=T)
    for rhos in ((), (0.5, 2.0)):
        panel = default_scheme_panel(spec, K, rhos=rhos)
        want = j_default_scheme_panel(jspec, K, rhos=rhos)
        assert [s.name for s in panel] == [s.name for s in want]
        assert [dataclasses.asdict(s.aggregator) for s in panel] == \
            [dataclasses.asdict(s.aggregator) for s in want]
        assert len(panel) >= 5 and len({s.name for s in panel}) == len(panel)
        assert {"paper", "fedasync", "csmaafl", "age"} <= {
            s.aggregator.kind for s in panel}


def _metrics_calls(world):
    cfg = SimConfig(**BASE, metrics=MetricsSpec())
    args = (world["t_params"], mlp_loss, mlp_accuracy)
    cell = CellConfig(num_clients=K)
    spec = ProblemSpec(cell=cell, rho=0.05, num_rounds=T)
    _, panel = panels()
    return {
        "seed": lambda: run_seed_matrix(
            *args, world["t_severities"][0], world["t_test"],
            tsel.RandomScheme(0.4, K), world["t_h"], cell, cfg, SEEDS,
            device="cpu"),
        "scenario": lambda: run_scenario_matrix(
            *args, world["t_severities"][0], world["t_test"], spec,
            world["t_h"], [0.05], cfg, SEEDS, device="cpu"),
        "scheme-dense": lambda: run_scheme_matrix(
            *args, world["t_stores"], world["t_test"], panel, world["t_h"],
            cell, cfg, SEEDS, device="cpu"),
        "scheme-sparse": lambda: run_scheme_matrix(
            *args, world["t_stores"], world["t_test"], panel, world["t_h"],
            cell, cfg, SEEDS, participation="sparse", device="cpu"),
        "fault": lambda: run_fault_matrix(
            *args, world["t_severities"][0], world["t_test"],
            tsel.RandomScheme(0.4, K), world["t_h"][0], cell,
            dataclasses.replace(cfg, faults=FaultConfig(p_loss=0.1)),
            [0.0], device="cpu"),
    }


@pytest.mark.parametrize("sweep", ["seed", "scenario", "scheme-dense",
                                    "scheme-sparse", "fault"])
def test_metrics_raise_in_every_matrix_sweep(world, sweep):
    """Every matrix sweep now runs the taps (these cases expected
    ``NotImplementedError`` before the taps were ported): each lane's
    MetricsState, stacked on the lane axes, counts the lane's decisions."""
    out = _metrics_calls(world)[sweep]()
    if sweep == "fault":
        for name, ms in out.metrics.items():
            np.testing.assert_array_equal(
                ms.tx_count, np.asarray(out.delivered[name]).sum(axis=1))
        return
    lanes = out.participation.shape[:-2]
    assert out.metrics.tx_count.shape == lanes + (K,)
    np.testing.assert_array_equal(out.metrics.tx_count,
                                  out.participation.sum(axis=-2))
    assert (out.metrics.rounds == T).all()


@pytest.mark.parametrize("kw,error,match", [
    (dict(schemes=[]), ValueError, "at least one"),
    (dict(participation="both"), ValueError, "participation"),
    (dict(seeds=[0]), ValueError, "lanes"),
    (dict(cfg=SimConfig(**{**BASE, "local_mode": "continuous"}),
          participation="sparse"), ValueError, "participants"),
    (dict(cfg=SimConfig(**{**BASE, "data_stream": "round"}),
          participation="sparse"), ValueError, "data_stream"),
])
def test_scheme_matrix_input_checks(world, kw, error, match):
    _, panel = panels()
    call = dict(schemes=panel, seeds=SEEDS, cfg=SimConfig(**BASE),
                participation="dense")
    call.update(kw)
    with pytest.raises(error, match=match):
        run_scheme_matrix(world["t_params"], mlp_loss, mlp_accuracy,
                          world["t_stores"], world["t_test"],
                          call["schemes"], world["t_h"],
                          CellConfig(num_clients=K), call["cfg"],
                          call["seeds"], participation=call["participation"],
                          device="cpu")


def test_sparse_scheme_matrix_refuses_a_model_reading_policy(world):
    _, panel = panels()

    def reads_the_model(t, h_t, state=None):
        return torch.full_like(h_t, 0.5), torch.full_like(h_t, 1.0 / K)

    bad = [SchemeSpec("model", reads_the_model, AggregatorConfig())]
    with pytest.raises(ValueError, match="state_free or ledger"):
        run_scheme_matrix(world["t_params"], mlp_loss, mlp_accuracy,
                          world["t_stores"], world["t_test"], panel + bad,
                          world["t_h"], CellConfig(num_clients=K),
                          SimConfig(**BASE), SEEDS, participation="sparse",
                          device="cpu")


def test_fl_exports_the_jax_names_of_what_is_ported():
    """``repro_torch.fl`` exports every name of ``repro.fl`` but the scan
    engine's own pieces (an eager loop has no whole-run scan program)."""
    import repro.fl as jfl
    import repro_torch.fl as tfl
    scan_only = {"build_scan_sim", "run_simulation_scan"}
    not_yet = set()
    missing = set(jfl.__all__) - set(tfl.__all__) - scan_only - not_yet
    assert not missing, sorted(missing)
    assert all(hasattr(tfl, name) for name in tfl.__all__)
