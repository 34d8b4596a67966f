"""The dense engine's client axis placed over several devices (JAX's
``shard_clients``), on the CPU over a repeated device list.

* ``_client_mesh``'s d is JAX's mesh size for K 3, 7, 8, 10, 12 on four
  devices (JAX's dumped by ``tests/_jax_placement_dump.py`` in a
  subprocess with 4 host devices); ``run_simulation`` never places, and
  ``make_runner``'s default does.
* The port placed over ``("cpu",) * d`` (d 2 and 4) against the port
  unplaced, on the device and prestack paths, continuous and participants
  modes, the per-client stream, ``RandomScheme``, ``ProposedOnline`` with
  Δ = 3, ``AgeAwareScheme`` with the age aggregator and quarantine,
  NaN-corrupting faults, every tap with guards, and Adam: masks,
  deliveries, ``last_tx``, eval rounds, energies and integer taps bit for
  bit; the global, client and anchor rows, accuracy, loss and float taps
  at rtol 1e-4, atol 1e-5 with NaN in the same places; the rows in d
  blocks for the whole run; eq. 3 one K1 call a block and round, subset
  or weighted mode, never the plain mode.
* The port placed against JAX's ``make_runner(shard_clients=None)`` at K 8
  (d 4) and K 10 (d 2) on the quickstart's world reduced, two cases.
* The placed store's blocks and each block's index rows equal the
  unplaced store's rows and draw bit for bit; the prestack batches too.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.fl.engine as E
from repro_torch import random as jr
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import CellConfig, ProblemSpec
from repro_torch.core.channel import channel_gains, sample_positions
from repro_torch.core.selection import (AgeAwareScheme, ProposedOnline,
                                        RandomScheme)
from repro_torch.data import (Dataset, data_stream_key, from_client_datasets,
                              make_mnist_like, shard_noniid)
from repro_torch.data.device import (gather_round, round_indices,
                                     round_indices_client_stream)
from repro_torch.fl import (AggregatorConfig, ClientPlacement, FaultConfig,
                            GuardConfig, RowBlocks, SimConfig, make_runner,
                            run_simulation, stack_round_batches)
from repro_torch.kernels import ops
from repro_torch.models.small import init_mlp, mlp_accuracy, mlp_loss
from repro_torch.obs.taps import MetricsSpec
from repro_torch.optim import adam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, T, DIM = 8, 4, 64
RTOL, ATOL = 1e-4, 1e-5        # tests/golden/harness.py
BASE = dict(rounds=T, local_iters=2, batch_size=8, eval_every=2,
            eval_batch=200, data_path="device")
CPU = torch.device("cpu")


@contextlib.contextmanager
def placed(d: int):
    """``make_runner`` places over ``("cpu",) * d`` (the placement the
    engine builds over d cards, here of one device)."""
    rule = E._client_mesh
    E._client_mesh = lambda k, device=None: ClientPlacement((CPU,) * d, k)
    try:
        yield
    finally:
        E._client_mesh = rule


def quickstart_world(clients, test, h, params):
    cell = CellConfig(num_clients=len(clients))
    return dict(clients=clients, test=test, h=h, params=params, cell=cell)


@pytest.fixture(scope="module")
def world():
    """``examples/quickstart.py``'s world reduced (n_train 1,000, 64
    features, a 64-24-10 MLP, T 4) at K 8, made by the port."""
    tr, te = make_mnist_like(jr.PRNGKey(0), n_train=1000, n_test=200,
                             device="cpu")
    clients = [Dataset(c.x[:, :DIM], c.y, c.num_classes)
               for c in shard_noniid(jr.PRNGKey(1), tr, K, d=5)]
    te = Dataset(te.x[:, :DIM], te.y, te.num_classes)
    cell = CellConfig(num_clients=K)
    h = channel_gains(jr.PRNGKey(3), sample_positions(
        jr.PRNGKey(2), cell, device="cpu"), T).T
    params = init_mlp(jr.PRNGKey(4), dims=(DIM, 24, 10), device="cpu")
    spec = ProblemSpec(cell=cell, rho=0.05, lam=0.01, num_rounds=T)
    w = quickstart_world(clients, te, h, params)
    # one (P1') solve over the T rounds, replayed by every run
    w["proposed"] = E.solve_once(ProposedOnline(spec), h)
    return w


CASES = {
    "device": ("random", {}, None),
    "prestack": ("random", dict(data_path="prestack"), None),
    "participants": ("random", dict(local_mode="participants"), None),
    "prestack_participants": ("random", dict(data_path="prestack",
                                             local_mode="participants"),
                              None),
    "client_stream": ("random", dict(data_stream="client"), None),
    "proposed_delta3": ("proposed", dict(max_staleness=3), None),
    "age_guarded": ("age", dict(aggregator=AggregatorConfig(kind="age"),
                                guards=GuardConfig(quarantine=True)), None),
    "faults_nan": ("random", dict(faults=FaultConfig(
        p_fail=0.2, p_recover=0.5, p_crash=0.1, p_loss=0.3, max_retries=1,
        p_corrupt=0.3, corrupt_mode="nan")), None),
    "taps": ("random", dict(metrics=MetricsSpec(), guards=GuardConfig(
        quarantine=True, clip_norm=0.5, staleness_power=0.5)), None),
    "adam": ("random", {}, "adam"),
}


def policy_of(name, w):
    if name == "proposed":
        return w["proposed"]
    if name == "age":
        return AgeAwareScheme(3, K)
    return RandomScheme(0.5, K)


def run_case(w, case, d=None):
    """The case's run, unplaced (``d=None``) or placed over d blocks, with
    the eq.-3 calls counted by K1 mode."""
    pol, extra, opt = CASES[case]
    cfg = SimConfig(**{**BASE, **extra})
    calls = {"plain": 0, "subset": 0, "weighted": 0}
    wrapped = {"plain": "fl_aggregate", "subset": "fl_aggregate_subset",
               "weighted": "fl_aggregate_guarded"}
    saved = {m: getattr(ops, f) for m, f in wrapped.items()}

    def counting(mode):
        def call(*args):
            calls[mode] += 1
            return saved[mode](*args)
        return call

    with contextlib.ExitStack() as stack:
        if d is not None:
            stack.enter_context(placed(d))
        for mode, fn in wrapped.items():
            setattr(ops, fn, counting(mode))
        stack.callback(lambda: [setattr(ops, f, saved[m])
                                for m, f in wrapped.items()])
        res = make_runner(mlp_loss, mlp_accuracy, w["clients"], w["test"],
                          policy_of(pol, w), w["cell"], cfg,
                          adam(0.01) if opt == "adam" else None,
                          device="cpu")(w["params"], w["h"])
    return res, calls


@pytest.fixture(scope="module")
def unplaced(world):
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = run_case(world, case)
        return cache[case]

    return get


def held_floats(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True,
                               err_msg=what)


def held_placed(got, want):
    """``got`` (placed) against ``want`` (unplaced): the ledgers bit for
    bit, the floats within the golden tolerance."""
    for name in ("participation", "eval_rounds", "energy_per_client",
                 "energy_timeline", "delivered", "corrupted"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    np.testing.assert_array_equal(got.state.last_tx.numpy(),
                                  want.state.last_tx.numpy())
    assert int(got.state.round) == int(want.state.round)
    held_floats(got.test_acc, want.test_acc, "test_acc")
    held_floats(got.test_loss, want.test_loss, "test_loss")
    st = got.state.gathered()
    for name in ("global_params", "client_params", "anchor_params"):
        held_floats(getattr(st, name).numpy(),
                    getattr(want.state, name).numpy(), name)
    if want.metrics is not None:
        for name, a in want.metrics._asdict().items():
            if a is None:
                continue
            b = getattr(got.metrics, name)
            if np.issubdtype(np.asarray(a).dtype, np.integer) \
                    or name == "energy_cause":
                np.testing.assert_array_equal(b, a, err_msg=name)
            else:
                held_floats(b, a, name)


# ---------------------------------------------------------------------------
# JAX's reference, dumped in a subprocess with 4 host devices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_dump(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "placement.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(
        REPO, "tests", "_jax_placement_dump.py"), str(out)], env=env,
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(out))


@pytest.mark.parametrize("num_clients,d", [(3, 3), (7, None), (8, 4),
                                           (10, 2), (12, 4)])
def test_client_mesh_is_jax_mesh(jax_dump, monkeypatch, num_clients, d):
    """Four visible cards: d is JAX's mesh size (the largest divisor of K
    no larger than 4), over the first d cards, K/d rows a block; a CPU
    device is never placed."""
    ks = list(jax_dump["mesh_ks"])
    assert int(jax_dump["mesh_d"][ks.index(num_clients)]) == (d or 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    got = E._client_mesh(num_clients, device="cuda")
    if d is None:
        assert got is None
    else:
        assert got.devices == tuple(torch.device("cuda", i)
                                    for i in range(d))
        assert got.rows * d == num_clients
    assert E._client_mesh(num_clients, device="cpu") is None
    got = E._client_mesh(num_clients, device="cuda:2")
    if d is not None:
        assert got.devices[0] == torch.device("cuda", 2)
        assert len(set(got.devices)) == d


def test_run_simulation_never_places(world, monkeypatch):
    """With four cards visible, ``run_simulation`` builds an unplaced
    dense runner, as JAX's never places; ``make_runner``'s default builds
    one placed over the four (the runner itself is not built: no card)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    seen = []

    def dense_runner(*args, placement=None, **kw):
        seen.append(placement)
        return lambda params, h: None

    monkeypatch.setattr(E, "_dense_runner", dense_runner)
    cfg = SimConfig(**BASE)
    args = (mlp_loss, mlp_accuracy, world["clients"], world["test"],
            RandomScheme(0.5, K), world["cell"], cfg)
    run_simulation(world["params"], *args[:5], world["h"], *args[5:],
                   device="cuda")
    make_runner(*args, device="cuda")
    make_runner(*args, device="cuda", shard_clients=True)
    make_runner(*args, device="cuda", shard_clients=False)
    assert seen[0] is None and seen[3] is None
    for p in seen[1:3]:
        assert p.devices == tuple(torch.device("cuda", i) for i in range(4))


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_placed_equals_unplaced(world, unplaced, case, d):
    want, plain_calls = unplaced(case)
    got, calls = run_case(world, case, d)
    held_placed(got, want)
    for rows in (got.state.client_params, got.state.anchor_params):
        assert isinstance(rows, RowBlocks) and len(rows) == d
        assert all(b.shape == (K // d, got.state.layout.width)
                   for b in rows)
    weighted = CASES[case][1].get("aggregator") is not None \
        or CASES[case][1].get("guards") is not None
    mode = "weighted" if weighted else "subset"
    assert plain_calls == {"plain": 0 if weighted else T, "subset": 0,
                           "weighted": T if weighted else 0}
    assert calls == {"plain": 0, "subset": 0, "weighted": 0, mode: d * T}
    if case == "faults_nan":        # the corruption reached eq. 3
        assert want.corrupted.sum() > 0
        assert np.isnan(want.state.global_params.numpy()).any()


def test_unplaced_state_gathers_to_itself(unplaced):
    res, _ = unplaced("device")
    assert res.state.gathered() is res.state
    assert isinstance(res.state.client_params, torch.Tensor)


# ---------------------------------------------------------------------------
# against JAX's placed runs
# ---------------------------------------------------------------------------

def dumped_world(dump, num_clients):
    p = f"K{num_clients}/"
    clients = [Dataset(torch.from_numpy(dump[p + f"x{k}"]),
                       torch.from_numpy(dump[p + f"y{k}"]), 10)
               for k in range(num_clients)]
    test = Dataset(torch.from_numpy(dump[p + "test_x"]),
                   torch.from_numpy(dump[p + "test_y"]), 10)
    layers = {}
    for key in dump:
        if key.startswith(p + "param"):
            i, name = key[len(p + "param"):].split("_", 1)
            layers.setdefault(int(i), {})[name] = dump[key]
    params = params_from_jax([layers[i] for i in sorted(layers)],
                             device="cpu")
    return quickstart_world(clients, test, torch.from_numpy(dump[p + "h"]),
                            params)


JAX_CASES = {"random": (lambda n: RandomScheme(0.5, n), {}),
             "age_guarded": (lambda n: AgeAwareScheme(3, n), dict(
                 aggregator=AggregatorConfig(kind="age"),
                 guards=GuardConfig(quarantine=True)))}


@pytest.mark.parametrize("case", list(JAX_CASES))
@pytest.mark.parametrize("num_clients,d", [(8, 4), (10, 2)])
def test_placed_equals_jax_placed(jax_dump, num_clients, d, case):
    """JAX's ``make_runner`` default on 4 host devices keeps the client
    leaves split over its ``("k",)`` mesh for the whole run; the port
    placed over d blocks agrees with it."""
    w = dumped_world(jax_dump, num_clients)
    policy, extra = JAX_CASES[case]
    cfg = SimConfig(**{**BASE, **extra})
    with placed(d):
        got = make_runner(mlp_loss, mlp_accuracy, w["clients"], w["test"],
                          policy(num_clients), w["cell"], cfg,
                          device="cpu")(w["params"], w["h"])
    q = f"K{num_clients}/{case}/"
    assert str(jax_dump[q + "client_spec"]) == "PartitionSpec('k',)"
    for name in ("participation", "eval_rounds"):
        np.testing.assert_array_equal(getattr(got, name), jax_dump[q + name],
                                      err_msg=name)
    np.testing.assert_array_equal(got.state.last_tx.numpy(),
                                  jax_dump[q + "last_tx"])
    # the energies to the tolerance, as every comparison with JAX holds
    # them: XLA's eq.-5 rounding moves by an ulp between JAX's own placed
    # and unplaced programs (K 10, random)
    for name in ("energy_per_client", "energy_timeline", "test_acc",
                 "test_loss"):
        held_floats(getattr(got, name), jax_dump[q + name], name)
    st = got.state.gathered()
    leaves = [a for layer in params_to_numpy(
        st.layout.unflatten(st.global_params)) for _, a in sorted(
            layer.items())]
    for i, a in enumerate(leaves):
        held_floats(a, jax_dump[q + f"global{i}"], f"global leaf {i}")
    clients = [a for layer in params_to_numpy(
        st.layout.unflatten(st.client_params)) for _, a in sorted(
            layer.items())]
    for i, a in enumerate(clients):
        held_floats(a, jax_dump[q + f"client{i}"], f"client leaf {i}")


# ---------------------------------------------------------------------------
# the data: the store's blocks and each block's draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", ["round", "client"])
@pytest.mark.parametrize("d", [2, 4])
def test_placed_store_and_draw_are_the_unplaced_rows(world, d, stream):
    store = from_client_datasets(world["clients"], device="cpu")
    place = ClientPlacement((CPU,) * d, K)
    ps = place.place_store(store)
    n = K // d
    assert ps.num_clients == K and len(ps.blocks) == d
    assert torch.equal(ps.lengths, store.lengths)
    for s, block in enumerate(ps.blocks):
        for got, want in zip(block, store):
            assert torch.equal(got, want[s * n:(s + 1) * n])
    draw = round_indices_client_stream if stream == "client" \
        else round_indices
    key = data_stream_key(0, device="cpu")
    for t in range(T):
        idx = draw(key, t, store.lengths, 2, 8)
        rows = ps.indices(jr.fold_in(key, t), 2, 8, stream)
        xs, ys = ps.sample(jr.fold_in(key, t), 2, 8, stream)
        x, y = gather_round(store, idx)
        for s in range(d):
            assert torch.equal(rows[s], idx[s * n:(s + 1) * n])
            assert torch.equal(xs[s], x[s * n:(s + 1) * n])
            assert torch.equal(ys[s], y[s * n:(s + 1) * n])


@pytest.mark.parametrize("d", [2, 4])
def test_placed_prestack_batches_are_the_unplaced_rows(world, d):
    cfg = SimConfig(**{**BASE, "data_path": "prestack"})
    xb, yb = stack_round_batches(world["clients"], cfg, "cpu")
    place = ClientPlacement((CPU,) * d, K)
    n = K // d
    for whole, blocks in ((xb, place.split(xb, dim=1)),
                          (yb, place.split(yb, dim=1))):
        assert len(blocks) == d
        for s, b in enumerate(blocks):
            assert torch.equal(b, whole[:, s * n:(s + 1) * n])
            assert b.is_contiguous()


def test_placement_refuses_a_k_its_devices_do_not_divide():
    with pytest.raises(ValueError, match="do not divide"):
        ClientPlacement((CPU,) * 3, 8)
    assert ClientPlacement((CPU,) * 2, 6).rows == 3
