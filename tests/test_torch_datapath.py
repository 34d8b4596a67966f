"""The data paths of the port against the JAX package: the host batching
(``BatchIterator``, ``client_batches``), the prestack batches
(``stack_round_batches``), the device stream stacked
(``stack_rounds_reference``), the stream sampler's chunks, the footprint
planning (``choose_data_path``, ``device_memory_budget``), and
``make_runner`` on the prestack, stream and auto-resolved paths, with
``eval_mode="replay"`` and the matrices on a ``"stream"`` config.

Batches, indices and masks are held bit for bit; energy, accuracy, loss
and the final model to the golden tolerance rtol 1e-4, atol 1e-5.  In the
port, the stream path equals the device path bit for bit: both gather the
same examples and run the same round transition.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.device as jdev
from repro.core import CellConfig as JCell
from repro.core.channel import channel_gains as j_channel_gains
from repro.core.channel import sample_positions as j_sample_positions
from repro.core.selection import RandomScheme as JRandom
from repro.data import make_mnist_like as j_make_mnist_like
from repro.data import shard_noniid as j_shard_noniid
from repro.data.pipeline import BatchIterator as JBatchIterator
from repro.data.pipeline import client_batches as j_client_batches
from repro.data.synthetic import Dataset as JDataset
import repro.fl.faults as jf
from repro.fl import GuardConfig as JGuard
from repro.fl import SimConfig as JSimConfig
from repro.fl import make_runner as j_make_runner
from repro.fl import run_fault_matrix as j_run_fault_matrix
from repro.fl import run_seed_matrix as j_run_seed_matrix
from repro.fl import stack_round_batches as j_stack_round_batches
from repro.models.small import init_mlp as j_init_mlp
from repro.models.small import mlp_accuracy as j_mlp_accuracy
from repro.models.small import mlp_loss as j_mlp_loss
import repro_torch.fl.faults as tf
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import CellConfig
from repro_torch.core.selection import RandomScheme
from repro_torch.data import (DEFAULT_BUDGET_BYTES, STORE_BUDGET_FRACTION,
                              BatchIterator, Dataset, StreamingSampler,
                              choose_data_path, client_batches,
                              data_stream_key, device_memory_budget,
                              estimate_store_bytes, from_client_datasets,
                              stack_rounds_reference)
from repro_torch.fl import (GuardConfig, SimConfig, make_runner,
                            resolve_data_path, run_fault_matrix,
                            run_seed_matrix, stack_round_batches)
from repro_torch.models.small import mlp_accuracy, mlp_loss

K, T, DIM = 5, 12, 64
RTOL, ATOL = 1e-4, 1e-5        # tests/golden/harness.py
BASE = dict(rounds=T, local_iters=1, batch_size=8, eval_every=4,
            eval_batch=200)
FAULTS = dict(p_fail=0.2, p_recover=0.5, diurnal_amp=0.5, p_crash=0.1,
              p_loss=0.3, max_retries=1, backoff=2.0, p_corrupt=0.3,
              corrupt_mode="nan")
GUARDS = dict(quarantine=True, clip_norm=10.0, staleness_power=0.5)


def to_torch(ds):
    return Dataset(torch.from_numpy(np.array(ds.x)),
                   torch.from_numpy(np.array(ds.y)), ds.num_classes)


@pytest.fixture(scope="module")
def world():
    """tests/test_resume.py's ``tiny_world`` on both sides."""
    tr, te = j_make_mnist_like(jax.random.PRNGKey(0), n_train=1000,
                               n_test=300)
    clients = j_shard_noniid(jax.random.PRNGKey(1), tr, K, d=2)
    clients = [JDataset(c.x[:, :DIM], c.y, c.num_classes) for c in clients]
    te = JDataset(te.x[:, :DIM], te.y, te.num_classes)
    h = j_channel_gains(jax.random.PRNGKey(3), j_sample_positions(
        jax.random.PRNGKey(2), JCell(num_clients=K)), T).T
    params = j_init_mlp(jax.random.PRNGKey(4), dims=(DIM, 24, 10))
    return dict(clients=clients, test=te, h=h, params=params,
                t_clients=[to_torch(c) for c in clients], t_test=to_torch(te),
                t_h=torch.from_numpy(np.array(h)),
                t_params=params_from_jax(
                    jax.tree_util.tree_map(np.asarray, params), device="cpu"))


def model(res):
    st = res.state
    if isinstance(st.global_params, torch.Tensor):
        return jax.tree_util.tree_leaves(params_to_numpy(
            st.layout.unflatten(st.global_params)))
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(
        st.global_params)]


def held_to_jax(got, want):
    for name in ("participation", "eval_rounds"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    if want.delivered is not None:
        for name in ("delivered", "corrupted"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(np.asarray(got.state.last_tx),
                                  np.asarray(want.state.last_tx))
    pairs = [(got.energy_per_client, want.energy_per_client),
             (got.energy_timeline, want.energy_timeline),
             (got.test_acc, want.test_acc), (got.test_loss, want.test_loss)]
    for a, b in pairs + list(zip(model(got), model(want))):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(np.asarray(b)))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   equal_nan=True)


def bit_equal(a, b):
    """Two port results with the same bits everywhere."""
    for name in ("participation", "eval_rounds", "test_acc", "test_loss",
                 "energy_per_client", "energy_timeline", "delivered",
                 "corrupted"):
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None, name
            continue
        np.testing.assert_array_equal(x, y, err_msg=name)
    for f in ("global_params", "client_params", "anchor_params", "round",
              "last_tx"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


# --- host batching -----------------------------------------------------------


@pytest.mark.parametrize("batch", [8, 37, 10_000])
def test_batch_iterator_matches_jax(world, batch):
    """Shuffled batches from ``default_rng(seed)``, reshuffled when a batch
    would run past the end; a batch as large as the shard is the shard."""
    jit_ = JBatchIterator(world["clients"][1], batch, seed=17)
    tit = BatchIterator(world["t_clients"][1], batch, seed=17)
    for _ in range(12):
        (jx, jy), (tx, ty) = next(jit_), next(tit)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_client_batches_match_jax(world):
    jits = [JBatchIterator(c, 8, seed=3 + k)
            for k, c in enumerate(world["clients"])]
    tits = [BatchIterator(c, 8, seed=3 + k)
            for k, c in enumerate(world["t_clients"])]
    for _ in range(5):
        (jx, jy), (tx, ty) = j_client_batches(jits), client_batches(tits)
        assert tuple(tx.shape) == (K, 8, DIM)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("local_iters", [0, 2])
def test_stack_round_batches_match_jax(world, local_iters):
    cfg = dict(rounds=6, local_iters=local_iters, batch_size=8, seed=2)
    jx, jy = j_stack_round_batches(world["clients"], JSimConfig(**cfg))
    tx, ty = stack_round_batches(world["t_clients"], SimConfig(**cfg),
                                 device="cpu")
    assert tx.shape == jx.shape and ty.shape == jy.shape
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_stack_rounds_reference_matches_jax(world):
    jstore = jdev.from_client_datasets(world["clients"])
    tstore = from_client_datasets(world["t_clients"], device="cpu")
    jx, jy = jdev.stack_rounds_reference(jstore, jdev.data_stream_key(5), 7,
                                         3, 8)
    tx, ty = stack_rounds_reference(tstore, data_stream_key(5, "cpu"), 7, 3,
                                    8)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("t0,t1", [(0, 4), (4, 8), (8, 10), (9, 10)])
def test_streaming_sampler_chunks_match_jax(world, t0, t1):
    """The chunk's indices are the device path's stream; the gather runs
    on the host: JAX's sampler's batches bit for bit, and the device
    store's rounds ``[t0, t1)``."""
    jsam = jdev.StreamingSampler(world["clients"], jdev.data_stream_key(1),
                                 2, 8)
    tsam = StreamingSampler(world["t_clients"], data_stream_key(1, "cpu"),
                            2, 8, device="cpu")
    jx, jy = jsam.chunk(t0, t1)
    tx, ty = tsam.chunk(t0, t1)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    store = from_client_datasets(world["t_clients"], device="cpu")
    rx, ry = stack_rounds_reference(store, data_stream_key(1, "cpu"), t1, 2,
                                    8)
    assert torch.equal(tx, rx[t0:t1]) and torch.equal(ty, ry[t0:t1])
    assert tsam.nbytes_host == jsam.nbytes_host


# --- footprint planning ------------------------------------------------------


def test_device_memory_budget_order(monkeypatch):
    """JAX's order: the env override first, then the device's own memory,
    then 4 GiB where it reports none (the CPU)."""
    monkeypatch.delenv("REPRO_DATA_BUDGET_BYTES", raising=False)
    assert device_memory_budget("cpu") == DEFAULT_BUDGET_BYTES == 4 << 30
    assert jdev.device_memory_budget() == DEFAULT_BUDGET_BYTES
    monkeypatch.setenv("REPRO_DATA_BUDGET_BYTES", "123456")
    assert device_memory_budget("cpu") == 123456 == \
        jdev.device_memory_budget()


@pytest.mark.parametrize("share", [0.25, 0.5, 0.75])
def test_choose_data_path_by_footprint(world, share):
    need = estimate_store_bytes(world["t_clients"])
    assert need == jdev.estimate_store_bytes(world["clients"])
    budget = int(need / share)
    want = jdev.choose_data_path(world["clients"], budget)
    assert want == ("device" if share <= STORE_BUDGET_FRACTION else "stream")
    assert choose_data_path(world["t_clients"], budget) == want
    store = from_client_datasets(world["t_clients"], device="cpu")
    assert choose_data_path(store, budget) == want
    assert choose_data_path(need, budget) == want


def test_choose_data_path_reads_the_env_budget(world, monkeypatch):
    need = estimate_store_bytes(world["t_clients"])
    monkeypatch.setenv("REPRO_DATA_BUDGET_BYTES", str(need))
    assert choose_data_path(world["t_clients"], device="cpu") == "stream" \
        == jdev.choose_data_path(world["clients"])
    monkeypatch.setenv("REPRO_DATA_BUDGET_BYTES", str(2 * need))
    assert choose_data_path(world["t_clients"], device="cpu") == "device"


def test_resolve_data_path_auto_matches_jax(world):
    need = estimate_store_bytes(world["t_clients"])
    for budget in (need, 2 * need, 10 * need):
        cfg = SimConfig(**BASE)
        assert resolve_data_path(world["t_clients"], cfg, None, budget,
                                 "cpu") == jdev.choose_data_path(
            world["clients"], budget)
    assert resolve_data_path(world["t_clients"], cfg, "prestack") == \
        "prestack"


# --- make_runner on each path, against JAX -----------------------------------


def runners(world, path, budget=None, faults=False, **extra):
    kw = {**BASE, **extra}
    jcfg, tcfg = JSimConfig(**kw), SimConfig(**kw)
    if faults:
        jcfg = dataclasses.replace(jcfg, faults=jf.FaultConfig(**FAULTS),
                                   guards=JGuard(**GUARDS))
        tcfg = dataclasses.replace(tcfg, faults=tf.FaultConfig(**FAULTS),
                                   guards=GuardConfig(**GUARDS))
    j = j_make_runner(j_mlp_loss, j_mlp_accuracy, world["clients"],
                      world["test"], JRandom(0.5, K), JCell(num_clients=K),
                      jcfg, data_path=path, data_budget_bytes=budget)
    t = make_runner(mlp_loss, mlp_accuracy, world["t_clients"],
                    world["t_test"], RandomScheme(0.5, K),
                    CellConfig(num_clients=K), tcfg, device="cpu",
                    data_path=path, data_budget_bytes=budget)
    return j, t


CASES = {   # name: (data_path, rounds, extra SimConfig)
    "prestack": ("prestack", T, dict(local_iters=2)),
    "prestack-participants": ("prestack", T,
                              dict(local_mode="participants")),
    "stream-chunk4-T10": ("stream", 10, dict(stream_chunk=4)),
    "stream-chunk5-faults-guards": ("stream", T,
                                    dict(stream_chunk=5, faults=True)),
    "prestack-faults-guards": ("prestack", T, dict(faults=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_make_runner_path_matches_jax(world, case):
    path, rounds, extra = CASES[case]
    j, t = runners(world, path, **extra, rounds=rounds)
    h_j, h_t = world["h"][:, :rounds], world["t_h"][:, :rounds]
    held_to_jax(t(world["t_params"], h_t), j(world["params"], h_j))


@pytest.mark.parametrize("resolved", ["device", "stream"])
def test_auto_resolves_by_budget_and_matches_jax(world, resolved):
    need = estimate_store_bytes(world["t_clients"])
    budget = 4 * need if resolved == "device" else need
    j, t = runners(world, "auto", budget, stream_chunk=4)
    assert hasattr(t, "sampler") == (resolved == "stream")
    held_to_jax(t(world["t_params"], world["t_h"]),
                j(world["params"], world["h"]))


@pytest.mark.parametrize("chunk", [1, 4, 5, T])
@pytest.mark.parametrize("faults", [False, True])
def test_stream_equals_device_bit_for_bit(world, chunk, faults):
    """Any chunk length: the same examples, the same round transition, the
    same bits (faults, guards and K1's weighted mode included)."""
    cfg = SimConfig(**BASE, stream_chunk=chunk)
    if faults:
        cfg = dataclasses.replace(cfg, faults=tf.FaultConfig(**FAULTS),
                                  guards=GuardConfig(**GUARDS))
    out = {}
    for path in ("device", "stream"):
        out[path] = make_runner(
            mlp_loss, mlp_accuracy, world["t_clients"], world["t_test"],
            RandomScheme(0.5, K), CellConfig(num_clients=K), cfg,
            device="cpu", data_path=path)(world["t_params"], world["t_h"])
    bit_equal(out["stream"], out["device"])


def test_replay_eval_mode_on_the_dense_runner(world):
    """``eval_mode="replay"`` drops the in-loop evals (no eval rounds) and
    changes nothing else, as in JAX."""
    results = []
    for mode in ("inscan", "replay"):
        jcfg = JSimConfig(**BASE, data_path="device", eval_mode=mode)
        tcfg = SimConfig(**BASE, data_path="device", eval_mode=mode)
        want = j_make_runner(j_mlp_loss, j_mlp_accuracy, world["clients"],
                             world["test"], JRandom(0.5, K),
                             JCell(num_clients=K), jcfg)(world["params"],
                                                         world["h"])
        got = make_runner(mlp_loss, mlp_accuracy, world["t_clients"],
                          world["t_test"], RandomScheme(0.5, K),
                          CellConfig(num_clients=K), tcfg, device="cpu")(
            world["t_params"], world["t_h"])
        held_to_jax(got, want)
        results.append(got)
    inscan, replay = results
    assert replay.eval_rounds.size == replay.test_acc.size == 0
    assert torch.equal(inscan.state.global_params, replay.state.global_params)
    np.testing.assert_array_equal(inscan.participation, replay.participation)


def test_unknown_eval_mode_raises(world):
    with pytest.raises(ValueError, match="unknown eval_mode"):
        make_runner(mlp_loss, mlp_accuracy, world["t_clients"],
                    world["t_test"], RandomScheme(0.5, K),
                    CellConfig(num_clients=K),
                    SimConfig(**BASE, eval_mode="later"), device="cpu")


@pytest.mark.parametrize("path", ["stream", "prestack"])
def test_host_paths_refuse_a_built_store(world, path):
    store = from_client_datasets(world["t_clients"], device="cpu")
    with pytest.raises(ValueError, match="DeviceDataStore"):
        make_runner(mlp_loss, mlp_accuracy, store, world["t_test"],
                    RandomScheme(0.5, K), CellConfig(num_clients=K),
                    SimConfig(**BASE), device="cpu", data_path=path)


def test_a_store_resolving_to_stream_raises(world):
    store = from_client_datasets(world["t_clients"], device="cpu")
    with pytest.raises(ValueError, match="DeviceDataStore"):
        make_runner(mlp_loss, mlp_accuracy, store, world["t_test"],
                    RandomScheme(0.5, K), CellConfig(num_clients=K),
                    SimConfig(**BASE), device="cpu",
                    data_budget_bytes=store.nbytes)


# --- the matrices on a "stream" config ---------------------------------------


MATRIX = dict(BASE, rounds=6, eval_every=2)


def test_seed_matrix_runs_stream_on_the_device_store(world):
    """JAX's seed matrix resolves ``"stream"`` to the device store; so does
    the port's: the lanes equal the device config's bit for bit and JAX's
    to tolerance."""
    seeds = [0, 5]
    h_stack = np.stack([np.asarray(world["h"])[:, :6]] * 2)
    want = j_run_seed_matrix(world["params"], j_mlp_loss, j_mlp_accuracy,
                             world["clients"], world["test"],
                             JRandom(0.5, K), jnp.asarray(h_stack),
                             JCell(num_clients=K),
                             JSimConfig(**MATRIX, data_path="stream"), seeds)
    out = {path: run_seed_matrix(
        world["t_params"], mlp_loss, mlp_accuracy, world["t_clients"],
        world["t_test"], RandomScheme(0.5, K), torch.from_numpy(h_stack),
        CellConfig(num_clients=K), SimConfig(**MATRIX, data_path=path),
        seeds, device="cpu") for path in ("stream", "device")}
    for name in ("participation", "e_round", "energy", "acc", "loss"):
        np.testing.assert_array_equal(getattr(out["stream"], name),
                                      getattr(out["device"], name))
    np.testing.assert_array_equal(out["stream"].participation,
                                  want.participation)
    for name in ("energy", "e_round", "acc", "loss"):
        np.testing.assert_allclose(getattr(out["stream"], name),
                                   getattr(want, name), rtol=RTOL, atol=ATOL)


def test_seed_matrix_on_the_prestack_path_matches_jax(world):
    seeds = [1, 2]
    h_stack = np.stack([np.asarray(world["h"])[:, :6]] * 2)
    want = j_run_seed_matrix(world["params"], j_mlp_loss, j_mlp_accuracy,
                             world["clients"], world["test"],
                             JRandom(0.5, K), jnp.asarray(h_stack),
                             JCell(num_clients=K),
                             JSimConfig(**MATRIX, data_path="prestack"),
                             seeds)
    got = run_seed_matrix(world["t_params"], mlp_loss, mlp_accuracy,
                          world["t_clients"], world["t_test"],
                          RandomScheme(0.5, K), torch.from_numpy(h_stack),
                          CellConfig(num_clients=K),
                          SimConfig(**MATRIX, data_path="prestack"), seeds,
                          device="cpu")
    np.testing.assert_array_equal(got.participation, want.participation)
    for name in ("energy", "e_round", "acc", "loss"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=RTOL, atol=ATOL)


def test_fault_matrix_runs_stream_on_the_device_store(world):
    """JAX's fault matrix runs ``"stream"`` on the device store, and so
    does the port's: the same deliveries, energy and evals as JAX's."""
    rates = [0.0, 1.0]
    got = run_fault_matrix(world["t_params"], mlp_loss, mlp_accuracy,
                           world["t_clients"], world["t_test"],
                           RandomScheme(0.5, K), world["t_h"][:, :6],
                           CellConfig(num_clients=K),
                           SimConfig(**MATRIX, data_path="stream",
                                     faults=tf.FaultConfig(**FAULTS)),
                           rates, device="cpu")
    want = j_run_fault_matrix(world["params"], j_mlp_loss, j_mlp_accuracy,
                              world["clients"], world["test"],
                              JRandom(0.5, K), world["h"][:, :6],
                              JCell(num_clients=K),
                              JSimConfig(**MATRIX, data_path="stream",
                                         faults=jf.FaultConfig(**FAULTS)),
                              rates)
    for g in ("guarded", "unguarded"):
        np.testing.assert_array_equal(got.delivered[g], want.delivered[g])
        np.testing.assert_allclose(got.energy[g], want.energy[g], rtol=1e-6)
        np.testing.assert_allclose(got.acc[g], want.acc[g], rtol=RTOL,
                                   atol=ATOL)
