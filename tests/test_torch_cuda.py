"""The port on an NVIDIA card: K1 (fl_aggregate) against its plain version,
a small simulation on the card against the same run on the CPU, the sparse
engine against the dense one on the card, faulty runs and a scheme matrix
on the card against the CPU, the stream path against the device path and
a killed-and-resumed run against an uninterrupted one on the card, the
stream sampler's pinned side-stream copy, ``shard_store`` on the card
against the CPU, tapped runs on the three paths (tapped = untapped, card =
CPU, taps included), the legacy loop against the dense engine, the
card's memory snapshot, profile and ``timed_compile``, the round-phase
spans timed on the card under a profiler, the MLP's local-SGD kernel
(``mlp_sgd``) against its plain version and inside dense, sparse and
placed runs, and the dense round loop, unplaced and placed, under
``torch.cuda.set_sync_debug_mode("error")`` (no host sync in it).

Every test here is marked ``cuda`` and skips where there is no card.  This
file imports neither JAX nor the JAX package, so it also runs on a host that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.fl.engine as E
from repro_torch import random as jr
from repro_torch.core import CellConfig
from repro_torch.core.channel import channel_gains, sample_positions
from repro_torch.core.selection import AgeAwareScheme, RandomScheme
from repro_torch.data import (Dataset, DeviceDataStore, StreamingSampler,
                              data_stream_key, from_client_datasets,
                              make_mnist_like, shard_noniid, shard_store,
                              stack_rounds_reference)
from repro_torch.fl import (AggregatorConfig, ClientPlacement, FaultConfig,
                            GuardConfig, RowBlocks, SchemeSpec, SimConfig,
                            guarded_aggregate,
                            make_runner, make_sparse_runner, run_resumable,
                            run_scheme_matrix, run_simulation,
                            run_simulation_legacy, scheme_aggregate)
from repro_torch.fl.engine import make_local_train
from repro_torch.fl.state import ParamLayout
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda
from repro_torch.kernels.mlp_sgd import launch_plan, mlp_local_sgd_cuda
from repro_torch.models.small import init_mlp, mlp_accuracy, mlp_loss
from repro_torch.obs import MetricsSpec, maybe_profile, timed_compile
from repro_torch.obs.telemetry import get_telemetry
from repro_torch.optim import sgd

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),   # tests/test_kernels.py
       torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
MODES = ("plain", "subset", "guarded")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def call(mode, g, d, mask, plain=False):
    R = d.shape[0]
    if mode == "plain":
        return (ref.fl_aggregate_ref if plain else ops.fl_aggregate)(g, d,
                                                                       mask)
    if mode == "subset":
        return (ref.fl_aggregate_subset_ref if plain
                else ops.fl_aggregate_subset)(g, d, mask, 3 * R)
    return (ref.fl_aggregate_guarded_ref if plain
            else ops.fl_aggregate_guarded)(g, d, mask / R)


def inputs(card, R, M, dtype, offset):
    gen = torch.Generator(device=card).manual_seed(R * M)
    g = torch.randn(M + offset, generator=gen, device=card).to(dtype)[offset:]
    d = torch.randn(R * M + offset, generator=gen, device=card).to(dtype)[
        offset:].view(R, M)
    mask = (torch.rand(R, generator=gen, device=card) < 0.5).float()
    return g, d, mask


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [1, 7, 10, 11, 12, 64, 65, 100, 1000])
@pytest.mark.parametrize("M", [77, 8192, 8193, 159_012, 199_210, 600_001])
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_matches_plain_version(card, mode, dtype, R, M, offset):
    """R up to 11 loads every row directly, from 12 the rows stream through
    the ring (65 and 1000 end in a partial stage); 199,210 leaves every
    other row off 16 bytes, 600,001 gives each block three tiles; offset=1
    makes every operand a misaligned view."""
    g, d, mask = inputs(card, R, M, dtype, offset)
    before = fl_aggregate_cuda.launches
    got = call(mode, g, d, mask)
    assert fl_aggregate_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (M,)
    torch.testing.assert_close(got.float(),
                               call(mode, g, d, mask, plain=True).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [4, 64])
def test_guard_on_and_off(card, dtype, R):
    """R = 4 loads its rows directly, R = 64 streams them through the
    ring."""
    g = torch.randn(8193, device=card).to(dtype)
    d = torch.randn(R, 8193, device=card).to(dtype)
    d[1] = torch.nan
    d[2, 0] = torch.inf
    w = torch.zeros(R, device=card)
    w[0::2] = 1.0 / R
    out = ops.fl_aggregate_guarded(g, d, w)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(
        out.float(), ref.fl_aggregate_guarded_ref(g, d, w).float(),
        **TOL[dtype])
    mask = torch.zeros(R, device=card)
    mask[0] = 1.0
    plain = ops.fl_aggregate(g, d, mask)
    assert torch.isnan(plain).all()     # 0 · NaN = NaN: the row poisons


@pytest.mark.parametrize("mode,dtype,R,M,offset", [
    ("plain", torch.float32, 10, 159_012, 0),
    ("guarded", torch.float32, 1000, 159_012, 0),
    ("subset", torch.bfloat16, 65, 199_210, 1)])
def test_kernel_is_deterministic(card, mode, dtype, R, M, offset):
    """No atomics and a fixed order: two launches give the same bits."""
    g, d, mask = inputs(card, R, M, dtype, offset)
    assert torch.equal(call(mode, g, d, mask), call(mode, g, d, mask))


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    g = torch.zeros(16, device=card)
    d = torch.zeros(2, 16, device=card)
    m = torch.ones(2, device=card)
    with pytest.raises(TypeError):
        fl_aggregate_cuda(g.half(), d.half(), m, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        fl_aggregate_cuda(g, torch.zeros(16, 2, device=card).T, m, 0.5)
    with pytest.raises(ValueError, match="shape"):
        fl_aggregate_cuda(g, d, torch.ones(3, device=card), 0.5)
    with pytest.raises(ValueError, match="device"):
        fl_aggregate_cuda(g, d.cpu(), m, 0.5)


def test_simulation_on_the_card_matches_the_cpu(card):
    K, T = 10, 4
    cell = CellConfig(num_clients=K)
    train, test = make_mnist_like(jr.PRNGKey(0), n_train=1000, n_test=200,
                                  device=card)
    clients = shard_noniid(jr.PRNGKey(1), train, K, d=5)
    h = channel_gains(jr.PRNGKey(3), sample_positions(jr.PRNGKey(2), cell),
                      T).T
    params = init_mlp(jr.PRNGKey(4), device=card)
    cfg = SimConfig(rounds=T, local_iters=2, eval_every=2, max_staleness=3)
    policy = RandomScheme(p_bar=0.3, num_clients=K)
    before = fl_aggregate_cuda.launches
    got = run_simulation(params, mlp_loss, mlp_accuracy, clients, test,
                         policy, h, cell, cfg)
    assert fl_aggregate_cuda.launches == before + T
    cpu = [Dataset(c.x.cpu(), c.y.cpu(), 10) for c in clients]
    want = run_simulation([{k: v.cpu() for k, v in p.items()} for p in params],
                          mlp_loss, mlp_accuracy, cpu,
                          Dataset(test.x.cpu(), test.y.cpu(), 10), policy, h,
                          cell, cfg, device="cpu")
    np.testing.assert_array_equal(got.participation, want.participation)
    for name in ("energy_per_client", "test_acc", "test_loss"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("fn", ["scheme", "guarded"])
@pytest.mark.parametrize("R,M", [(10, 159_012), (64, 8193)])
def test_weighted_aggregators_launch_k1_once(card, fn, R, M):
    """``scheme_aggregate`` and ``guarded_aggregate`` (active guards) are one
    K1 launch in its weighted mode each, and equal their CPU results; a
    NaN row is quarantined on both devices."""
    gen = torch.Generator().manual_seed(R)
    g = torch.randn(M, generator=gen)
    d = torch.randn(R, M, generator=gen) * 1e-2
    d[1, 5] = torch.nan
    mask = (torch.rand(R, generator=gen) < 0.7).float()
    mask[1] = 1.0
    stale = torch.randint(0, 6, (R,), generator=gen, dtype=torch.int32)
    probs = torch.rand(R, generator=gen)
    guards = GuardConfig(clip_norm=0.5, staleness_power=0.5)

    def run(dev):
        args = [x.to(dev) for x in (g, d, mask)]
        if fn == "scheme":
            return scheme_aggregate(*args, R, stale.to(dev), probs.to(dev),
                                    AggregatorConfig(kind="csmaafl"),
                                    guards=guards)
        return guarded_aggregate(*args, R, stale.to(dev), guards)

    before = (fl_aggregate_cuda.launches, fl_aggregate_cuda.guarded_launches)
    got = run(card)
    assert (fl_aggregate_cuda.launches,
            fl_aggregate_cuda.guarded_launches) == (before[0] + 1,
                                                    before[1] + 1)
    want = run("cpu")
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


SPARSE_KW = dict(local_mode="participants", data_path="device",
                 data_stream="client")


def small_world(card, K, T):
    gen = torch.Generator(device=card).manual_seed(K)
    x = torch.randn(K, 6, 12, generator=gen, device=card)
    y = (torch.arange(6, device=card, dtype=torch.int32) % 10).expand(K, 6)
    clients = [Dataset(x[k], y[k].contiguous(), 10) for k in range(K)]
    test = Dataset(x[:, 0], y[:, 0].contiguous(), 10)
    h = torch.rand(K, T, generator=gen, device=card) * 9.9e-13 + 1e-14
    return clients, test, h, init_mlp(jr.PRNGKey(4), dims=(12, 8, 10),
                                      device=card)


@pytest.mark.parametrize("name", ["random", "random-staleness", "age-aware"])
def test_sparse_matches_dense_on_the_card(card, name):
    """Masks, eval rounds and ``last_tx`` bit for bit; energy at rtol 1e-6;
    accuracy, loss and the model at rtol 1e-4, atol 1e-5 (K1's subset mode
    and its plain mode round eq. 3 differently)."""
    K, T = 24, 8
    clients, test, h, params = small_world(card, K, T)
    policy, extra = {
        "random": (RandomScheme(0.25, K), {}),
        "random-staleness": (RandomScheme(0.1, K), dict(max_staleness=3)),
        "age-aware": (AgeAwareScheme(3, K), dict(
            aggregator=AggregatorConfig(kind="age"),
            guards=GuardConfig(quarantine=True)))}[name]
    cfg = SimConfig(rounds=T, local_iters=2, batch_size=4, eval_every=3,
                    participant_bucket=K, **SPARSE_KW, **extra)
    cell = CellConfig(num_clients=K)
    runs = {mode: run_simulation(params, mlp_loss, mlp_accuracy, clients,
                                 test, policy, h, cell,
                                 dataclasses.replace(cfg, participation=mode))
            for mode in ("dense", "sparse")}
    dense, sp = runs["dense"], runs["sparse"]
    assert sp.state.client_params is None
    np.testing.assert_array_equal(sp.participation, dense.participation)
    np.testing.assert_array_equal(sp.eval_rounds, dense.eval_rounds)
    assert torch.equal(sp.state.last_tx, dense.state.last_tx)
    np.testing.assert_allclose(sp.energy_per_client, dense.energy_per_client,
                               rtol=1e-6)
    for field in ("test_acc", "test_loss"):
        np.testing.assert_allclose(getattr(sp, field), getattr(dense, field),
                                   rtol=1e-4, atol=1e-5, err_msg=field)
    torch.testing.assert_close(sp.state.global_params,
                               dense.state.global_params, rtol=1e-4,
                               atol=1e-5)


def test_sparse_launches_k1_once_a_round_in_subset_mode(card):
    """A pre-built store on the card: phase B launches K1 once a round in
    its subset mode over the bucket, and equals the same run on the CPU."""
    K, T, bucket = 1031, 6, 64
    gen = torch.Generator(device=card).manual_seed(0)
    store = DeviceDataStore(
        torch.randn(K, 8, 12, generator=gen, device=card),
        (torch.arange(8, device=card, dtype=torch.int32) % 10).repeat(K, 1),
        torch.full((K,), 8, dtype=torch.int32, device=card))
    test = Dataset(store.x[:64, 0], store.y[:64, 0], 10)
    h = torch.rand(K, T, generator=gen, device=card) * 9.9e-13 + 1e-14
    params = init_mlp(jr.PRNGKey(4), dims=(12, 8, 10), device=card)
    cfg = SimConfig(rounds=T, local_iters=2, batch_size=4, eval_every=2,
                    participant_bucket=bucket, **SPARSE_KW)
    policy, cell = RandomScheme(16 / K, K), CellConfig(num_clients=K)
    before = (fl_aggregate_cuda.launches, fl_aggregate_cuda.subset_launches)
    got = make_sparse_runner(mlp_loss, mlp_accuracy, store, test, policy,
                             cell, cfg)(params, h)
    assert (fl_aggregate_cuda.launches - before[0],
            fl_aggregate_cuda.subset_launches - before[1]) == (T, T)
    cpu = DeviceDataStore(*(t.cpu() for t in store))
    want = make_sparse_runner(
        mlp_loss, mlp_accuracy, cpu, Dataset(test.x.cpu(), test.y.cpu(), 10),
        policy, cell, cfg, device="cpu")(
        [{k: v.cpu() for k, v in layer.items()} for layer in params], h.cpu())
    np.testing.assert_array_equal(got.participation, want.participation)
    for field in ("energy_per_client", "test_acc", "test_loss"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=1e-4, atol=1e-5, err_msg=field)


# chip_smoke.py's fault world (benchmarks/bench_faults.py's rates) with a
# heavier corruption rate, so a short run poisons several uploads
FAULTS = FaultConfig(p_fail=0.1, p_recover=0.5, diurnal_amp=0.5,
                     p_crash=0.05, p_loss=0.2, max_retries=1, backoff=2.0,
                     p_corrupt=0.4, corrupt_mode="nan")


def cpu_args(clients, test, h, params):
    return ([Dataset(c.x.cpu(), c.y.cpu(), 10) for c in clients],
            Dataset(test.x.cpu(), test.y.cpu(), 10), h.cpu(),
            [{k: v.cpu() for k, v in layer.items()} for layer in params])


def assert_same_faulty_run(got, want):
    """Masks, deliveries, corruptions and ``last_tx`` bit for bit; floats
    at rtol 1e-4, atol 1e-5 with NaN in the same places."""
    for name in ("participation", "delivered", "corrupted", "eval_rounds"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(got.state.last_tx.cpu(),
                                  want.state.last_tx.cpu())
    pairs = [(getattr(got, n), getattr(want, n)) for n in (
        "energy_per_client", "energy_timeline", "test_acc", "test_loss")]
    pairs.append((got.state.global_params.cpu().numpy(),
                  want.state.global_params.cpu().numpy()))
    for a, b in pairs:
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   equal_nan=True)


@pytest.mark.parametrize("guarded", [False, True])
def test_faulty_dense_run_on_the_card_matches_the_cpu(card, guarded):
    """NaN uploads through K1's plain mode (unguarded: the model goes NaN,
    as on the CPU) and its weighted mode (guarded: quarantined)."""
    K, T = 24, 8
    clients, test, h, params = small_world(card, K, T)
    cfg = SimConfig(rounds=T, local_iters=2, batch_size=4, eval_every=3,
                    faults=FAULTS,
                    guards=GuardConfig(clip_norm=10.0, staleness_power=0.5)
                    if guarded else None)
    policy, cell = RandomScheme(0.5, K), CellConfig(num_clients=K)
    before = (fl_aggregate_cuda.launches, fl_aggregate_cuda.guarded_launches)
    got = run_simulation(params, mlp_loss, mlp_accuracy, clients, test,
                         policy, h, cell, cfg)
    assert (fl_aggregate_cuda.launches - before[0],
            fl_aggregate_cuda.guarded_launches - before[1]) == (
        T, T if guarded else 0)
    c_clients, c_test, c_h, c_params = cpu_args(clients, test, h, params)
    want = run_simulation(c_params, mlp_loss, mlp_accuracy, c_clients,
                          c_test, policy, c_h, cell, cfg, device="cpu")
    assert got.corrupted.sum() >= 1
    assert_same_faulty_run(got, want)
    assert torch.isfinite(got.state.global_params).all() == guarded


def test_faulty_sparse_run_on_the_card_matches_the_cpu(card):
    """Guarded NaN uploads on the sparse path: phase A's fault lanes and
    phase B's corrupted bucket, card against CPU and against the dense
    engine on the card."""
    K, T = 24, 8
    clients, test, h, params = small_world(card, K, T)
    cfg = SimConfig(rounds=T, local_iters=2, batch_size=4, eval_every=3,
                    participant_bucket=K, faults=FAULTS,
                    guards=GuardConfig(clip_norm=10.0, staleness_power=0.5),
                    participation="sparse", **SPARSE_KW)
    policy, cell = RandomScheme(0.5, K), CellConfig(num_clients=K)
    got = run_simulation(params, mlp_loss, mlp_accuracy, clients, test,
                         policy, h, cell, cfg)
    c_clients, c_test, c_h, c_params = cpu_args(clients, test, h, params)
    want = run_simulation(c_params, mlp_loss, mlp_accuracy, c_clients,
                          c_test, policy, c_h, cell, cfg, device="cpu")
    dense = run_simulation(params, mlp_loss, mlp_accuracy, clients, test,
                           policy, h, cell,
                           dataclasses.replace(cfg, participation="dense"))
    assert got.state.client_params is None and got.corrupted.sum() >= 1
    assert_same_faulty_run(got, want)
    assert_same_faulty_run(got, dense)


@pytest.mark.parametrize("path", ["dense", "sparse"])
def test_two_lane_scheme_matrix_on_the_card_matches_the_cpu(card, path):
    K, T = 24, 8
    clients, test, h, params = small_world(card, K, T)
    panel = [SchemeSpec("paper", RandomScheme(0.25, K),
                        AggregatorConfig(kind="paper")),
             SchemeSpec("age-aware", AgeAwareScheme(3, K),
                        AggregatorConfig(kind="age"))]
    cfg = SimConfig(rounds=T, local_iters=2, batch_size=4, eval_every=3,
                    **SPARSE_KW)
    got = run_scheme_matrix(params, mlp_loss, mlp_accuracy, [clients], test,
                            panel, h[None], CellConfig(num_clients=K), cfg,
                            [0], participation=path)
    c_clients, c_test, c_h, c_params = cpu_args(clients, test, h, params)
    want = run_scheme_matrix(c_params, mlp_loss, mlp_accuracy, [c_clients],
                             c_test, panel, c_h[None],
                             CellConfig(num_clients=K), cfg, [0],
                             participation=path, device="cpu")
    assert got.participation.shape == (1, 2, 1, T, K)
    np.testing.assert_array_equal(got.participation, want.participation)
    for name in ("energy", "energy_timeline", "acc", "loss"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# the stream path, resume and the partitioners on the card
# ---------------------------------------------------------------------------

STREAM_BASE = dict(rounds=10, local_iters=2, batch_size=4, eval_every=3,
                   stream_chunk=4)


def bits_equal(a, b):
    for name in ("participation", "eval_rounds", "test_acc", "test_loss",
                 "energy_per_client", "energy_timeline", "delivered",
                 "corrupted"):
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None, name
            continue
        np.testing.assert_array_equal(x, y, err_msg=name)
    for f in ("global_params", "client_params", "anchor_params", "last_tx"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


@pytest.mark.parametrize("faulty", [False, True])
def test_stream_equals_device_on_the_card(card, faulty):
    """Chunks of 4 over 10 rounds, copied from pinned memory on a side
    stream: the device path's bits, faults and guards included."""
    K = 12
    clients, test, h, params = small_world(card, K, 10)
    cfg = SimConfig(**STREAM_BASE)
    if faulty:
        cfg = dataclasses.replace(cfg, faults=FAULTS,
                                  guards=GuardConfig(quarantine=True,
                                                     clip_norm=10.0))
    out = {}
    for path in ("device", "stream"):
        runner = make_runner(mlp_loss, mlp_accuracy, clients, test,
                             RandomScheme(0.5, K), CellConfig(num_clients=K),
                             cfg, data_path=path)
        out[path] = runner(params, h)
    assert out["stream"].state.global_params.is_cuda
    bits_equal(out["stream"], out["device"])


def test_kill_and_resume_on_the_card(card, tmp_path):
    K = 12
    clients, test, h, params = small_world(card, K, 10)
    cfg = SimConfig(**STREAM_BASE, checkpoint_every=3,
                    faults=FAULTS,
                    guards=GuardConfig(quarantine=True, clip_norm=10.0))
    policy, cell = RandomScheme(0.5, K), CellConfig(num_clients=K)
    whole = run_simulation(params, mlp_loss, mlp_accuracy, clients, test,
                           policy, h, cell, cfg)
    args = (params, mlp_loss, mlp_accuracy, clients, test, policy, h, cell,
            cfg, str(tmp_path))
    assert run_resumable(*args, stop_after_segment=2) is None
    resumed = run_resumable(*args)
    assert resumed.state.global_params.is_cuda
    bits_equal(resumed, whole)


def test_stream_sampler_copies_from_pinned_memory(card):
    """The host blocks are pinned; a chunk lands on the card through a side
    stream, and what the compute stream reads is the device store's
    gather, also for chunks asked ahead of use."""
    K = 8
    clients, _, _, _ = small_world(card, K, 4)
    key = data_stream_key(3)
    sampler = StreamingSampler(clients, key, 2, 4)
    assert sampler._x.is_pinned() and sampler._y.is_pinned()
    store = from_client_datasets(clients)
    rx, ry = stack_rounds_reference(store, key.to(card), 9, 2, 4)
    chunks = [sampler.chunk(t0, min(t0 + 3, 9)) for t0 in range(0, 9, 3)]
    for i, (xb, yb) in enumerate(chunks):
        assert xb.is_cuda and yb.is_cuda
        assert torch.equal(xb, rx[3 * i:3 * i + 3])
        assert torch.equal(yb, ry[3 * i:3 * i + 3])
    assert sampler.copies == 3
    assert sampler._side is not None and \
        sampler._side != torch.cuda.current_stream()


def test_shard_store_on_the_card_matches_the_cpu(card):
    train, _ = make_mnist_like(jr.PRNGKey(0), n_train=6000, n_test=10,
                               device="cpu")
    got = shard_store(jr.PRNGKey(2, device=card), train, 10, 5)
    want = shard_store(jr.PRNGKey(2, device="cpu"), train, 10, 5)
    for a, b in zip(got, want):
        assert a.is_cuda
        assert torch.equal(a.cpu(), b)


def taps_close(got, want):
    """Integer taps bit for bit, float taps at rtol 1e-4, atol 1e-5."""
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("path", ["dense", "legacy", "sparse"])
def test_tapped_runs_on_the_card(card, path):
    """Every tap on, under faults, guards and the fedasync aggregator: the
    tapped run equals the untapped one bit for bit on the card, launches
    K1 once a round (weighted mode), and equals the CPU's run, taps
    included."""
    K, T = 12, 10
    clients, test, h, params = small_world(card, K, T)
    cfg = SimConfig(rounds=T, local_iters=2, batch_size=4, eval_every=3,
                    participant_bucket=K, faults=FAULTS,
                    guards=GuardConfig(quarantine=True, clip_norm=10.0),
                    aggregator=AggregatorConfig(kind="fedasync",
                                                staleness_fn="poly"),
                    metrics=MetricsSpec(), **SPARSE_KW)
    policy, cell = RandomScheme(0.5, K), CellConfig(num_clients=K)

    def run(c, args, device=None):
        if path == "legacy":
            return run_simulation_legacy(*args[:7], cell, c, device=device)
        return run_simulation(*args[:7], cell,
                              dataclasses.replace(c, participation=path),
                              device=device)

    args = (params, mlp_loss, mlp_accuracy, clients, test, policy, h)
    fl_aggregate_cuda.launches = fl_aggregate_cuda.guarded_launches = 0
    on = run(cfg, args)
    assert (fl_aggregate_cuda.launches,
            fl_aggregate_cuda.guarded_launches) == (T, T)
    off = run(dataclasses.replace(cfg, metrics=None), args)
    assert off.metrics is None and on.metrics is not None
    for name in ("participation", "eval_rounds", "test_acc", "test_loss",
                 "energy_per_client", "energy_timeline", "delivered",
                 "corrupted"):
        np.testing.assert_array_equal(getattr(on, name), getattr(off, name),
                                      err_msg=name)
    assert torch.equal(on.state.global_params, off.state.global_params)
    assert torch.equal(on.state.last_tx, off.state.last_tx)
    c_clients, c_test, c_h, c_params = cpu_args(clients, test, h, params)
    cpu = run(cfg, (c_params, mlp_loss, mlp_accuracy, c_clients, c_test,
                    policy, c_h), device="cpu")
    assert_same_faulty_run(on, cpu)
    taps_close(on.metrics, cpu.metrics)
    assert on.metrics.guard_events[0] >= 1


def test_legacy_loop_on_the_card_matches_the_dense_engine(card):
    K, T = 12, 10
    clients, test, h, params = small_world(card, K, T)
    cfg = SimConfig(**STREAM_BASE)
    args = (params, mlp_loss, mlp_accuracy, clients, test,
            RandomScheme(0.5, K), h, CellConfig(num_clients=K), cfg)
    legacy = run_simulation_legacy(*args)
    dense = run_simulation(*args)
    assert legacy.state.global_params.is_cuda
    np.testing.assert_array_equal(legacy.participation, dense.participation)
    assert torch.equal(legacy.state.last_tx, dense.state.last_tx)
    for name in ("energy_per_client", "energy_timeline", "test_acc",
                 "test_loss"):
        np.testing.assert_allclose(getattr(legacy, name),
                                   getattr(dense, name), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_memory_snapshot_and_profile_on_the_card(card, tmp_path):
    tel = get_telemetry()
    x = torch.ones(1 << 20, device=card)
    snap = tel.memory_snapshot()
    assert snap[0]["device"].startswith("cuda:0")
    assert snap[0]["bytes_in_use"] >= x.numel() * 4
    assert snap[0]["peak_bytes_in_use"] >= snap[0]["bytes_in_use"]
    with maybe_profile(str(tmp_path)) as d:
        (x * 2).sum().item()
    files = list(tmp_path.iterdir())
    assert d == str(tmp_path) and len(files) == 1
    fn = timed_compile(lambda v: (v * 2).sum(), x, label="cuda_test")
    assert float(fn(x)) == 2.0 * x.numel()
    assert tel.span_stats("cuda_test.compile")["count"] >= 1


def test_round_spans_are_timed_on_the_card_under_a_profiler(card,
                                                            monkeypatch):
    """Under a profiler each round span of a dense run gets a ``.device``
    entry of T records, and the phases' device times add up to no more
    than the run's host time (they tile the card's timeline inside it)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import telemetry
    tel = telemetry.Telemetry()
    monkeypatch.setattr(telemetry, "_TELEMETRY", tel)
    K, T = 24, 8
    clients, test, h, params = small_world(card, K, T)
    run = make_runner(mlp_loss, mlp_accuracy, clients, test,
                      RandomScheme(0.25, K), CellConfig(num_clients=K),
                      SimConfig(rounds=T, local_iters=2, batch_size=4,
                                eval_every=3, data_path="device"),
                      device=card, shard_clients=False)
    run(params, h)
    assert not any(n.endswith(".device") for n in tel.spans)
    untraced = tel.spans["engine.execute"][1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run(params, h)
    names = ("round.data", "round.decision", "round.local_sgd",
             "round.server")
    for name in names:
        count, total, _, parent = tel.spans[name + ".device"]
        assert (count, parent) == (T, "engine.execute.device"), name
        assert total > 0.0
    assert tel.spans["engine.execute.device"][0] == 1
    phases = sum(tel.spans[n + ".device"][1] for n in names)
    assert phases <= tel.spans["engine.execute"][1] - untraced


# ---------------------------------------------------------------------------
# the MLP's local SGD (kernels/mlp_sgd.py, csrc/mlp_sgd.cu)
# ---------------------------------------------------------------------------

def sgd_inputs(card, R, L, B, dims=(784, 200, 10), seed=0, margin=False):
    """``R`` rows near one initial MLP, one row into a larger tensor (an
    offset) with non-zero padding, and ``[R, L, B, D]`` inputs and ``[R, L,
    B]`` int32 labels.  With ``margin`` every pre-activation stays far from
    relu's kink: b1 is +1 and -1 in turn and the inputs 0.1 N(0, 1), so
    x.W1 is ~N(0, 0.02) and each unit is on, or off, by 7 sigma.  Without
    it, over millions of pre-activations a few land within rounding of 0.
    The kernel gives autograd's bits (below), but the plain version rounds
    the softmax's gradient in two steps where PyTorch's kernel fuses them,
    so after a step the two sets of parameters differ in their last bits
    and such a z may fall on relu's two sides: that unit's W1 column then
    differs by ~1e-3, both equally right."""
    gen = torch.Generator(device=card).manual_seed(seed)
    params = init_mlp(jr.PRNGKey(seed), dims, device=card)
    if margin:
        params[0]["b"] = 1.0 - 2.0 * (torch.arange(
            dims[1], device=card) % 2).float()
    layout = ParamLayout.of(params)
    big = layout.flatten(params).expand(R + 1, -1) + 0.01 * torch.randn(
        R + 1, layout.width, generator=gen, device=card)
    big[:, layout.size:] = 7.25
    xb = torch.randn(R, L, B, dims[0], generator=gen, device=card)
    if margin:
        xb *= 0.1
    yb = torch.randint(0, dims[-1], (R, L, B), generator=gen, device=card,
                       dtype=torch.int32)
    return big[1:], xb, yb, layout


@pytest.mark.parametrize("R", [1, 7, 2048])
@pytest.mark.parametrize("B", [1, 10, 32])
@pytest.mark.parametrize("L", [0, 1, 5])
def test_mlp_sgd_matches_plain_version(card, R, B, L):
    rows, xb, yb, layout = sgd_inputs(card, R, L, B, margin=True)
    before = mlp_local_sgd_cuda.launches
    got = mlp_local_sgd_cuda(rows, xb, yb, 0.05, layout)
    torch.cuda.synchronize()
    assert mlp_local_sgd_cuda.launches == before + 1
    want = ref.mlp_local_sgd_ref(rows, xb, yb, 0.05, layout)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(got[:, layout.size:], rows[:, layout.size:])
    if L == 0:
        assert torch.equal(got, rows)


# The build whose kernels' summation order csrc/mlp_sgd.cu copies (cuBLAS's
# FMA chains at these shapes, torch.sum's accumulators, the warp softmax).
AUTOGRAD_ORDER_BUILD = ("2.11.0+cu128", "12.8")


@pytest.mark.parametrize("L", [1, 5])
def test_mlp_sgd_equals_autograd_bit_for_bit(card, L):
    """On the paper's inputs (no margin at relu's kink) at the sparse
    bucket's R 2,048 and B 10, the kernel gives autograd's rows bit for
    bit on the PyTorch and CUDA build whose order it copies: it sums every
    product, the softmax and the bias gradients as PyTorch's kernels do on
    the card there.  Another build may pick other cuBLAS kernels (at R 64
    this one already does), so there the kernel is held to autograd at the
    rounding tolerance, on inputs with a margin at relu's kink.  (A lambda
    around the loss declares no fused trainer, so ``make_local_train``
    takes the autograd loop.)"""
    exact = (torch.__version__, torch.version.cuda) == AUTOGRAD_ORDER_BUILD
    rows, xb, yb, layout = sgd_inputs(card, 2048, L, 10, margin=not exact)
    got = mlp_local_sgd_cuda(rows, xb, yb, 0.01, layout)
    want = make_local_train(lambda p, x, y: mlp_loss(p, x, y), sgd(0.01))(
        rows, xb, yb, layout)
    if exact:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("B,cluster", [(1, 4), (10, 4), (16, 8), (32, 8)])
def test_launch_plan_at_the_papers_widths(card, B, cluster):
    """The library's plan: 4 CTAs a row up to B 10 (a CTA's 50 W1 columns,
    157 KB, and the batch), 8 above."""
    p = launch_plan(B, 784, 200, 10, 159_012)
    assert p.cluster == cluster and 0 < p.smem <= 232_448


@pytest.mark.parametrize("B,D,H,C,W", [
    (33, 784, 200, 10, 159_012),     # batch above the largest tile
    (10, 784, 202, 10, 160_404),     # hidden width not a multiple of 4
    (10, 784, 2048, 10, 1_628_176),  # a CTA's W1 columns past its memory
    (10, 784, 200, 10, 159_010),     # row not a multiple of 4 floats
    (10, 784, 200, 13, 159_616),     # more classes than the kernel holds
    (10, 4096, 200, 10, 821_412)])   # a W1 span past shared memory
def test_launch_plan_refuses(card, B, D, H, C, W):
    assert launch_plan(B, D, H, C, W) is None


def test_route_takes_the_kernel_whatever_the_labels_and_strides(card):
    """The route is chosen by what the function is (the MLP's loss, plain
    SGD, CUDA float32 rows); int64 labels and a strided batch are made
    int32 and contiguous for the kernel, which counts and gives the same
    rows, and a batch past the kernel's 32 raises rather than falling back
    to autograd."""
    rows, xb, yb, layout = sgd_inputs(card, 6, 2, 10, margin=True)
    want = mlp_local_sgd_cuda(rows, xb, yb, 0.05, layout)
    train = make_local_train(mlp_loss, sgd(0.05))
    tel = get_telemetry()
    tel.reset()
    before = mlp_local_sgd_cuda.launches
    strided = xb.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    assert torch.equal(train(rows, xb, yb.long(), layout), want)
    assert torch.equal(train(rows, strided, yb, layout), want)
    assert mlp_local_sgd_cuda.launches == before + 2
    assert (tel.counters.get("local_sgd.kernel", 0),
            tel.counters.get("local_sgd.autograd", 0)) == (2, 0)
    big = torch.zeros(6, 1, 33, 784, device=card)
    with pytest.raises(ValueError, match="no launch plan"):
        train(rows, big, torch.zeros(6, 1, 33, dtype=torch.int32,
                                     device=card), layout)
    assert tel.counters.get("local_sgd.autograd", 0) == 0


@pytest.mark.parametrize("dims,B", [((10, 8, 3), 4), ((20, 12, 5), 7),
                                    ((64, 32, 10), 16)])
def test_mlp_sgd_other_widths(card, dims, B):
    rows, xb, yb, layout = sgd_inputs(card, 9, 3, B, dims=dims, seed=1)
    got = mlp_local_sgd_cuda(rows, xb, yb, 0.1, layout)
    want = ref.mlp_local_sgd_ref(rows, xb, yb, 0.1, layout)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_mlp_sgd_is_deterministic_and_row_by_row(card):
    """Two launches give the same bits, and a row's result does not depend
    on the launch's other rows."""
    rows, xb, yb, layout = sgd_inputs(card, 300, 5, 10)
    a = mlp_local_sgd_cuda(rows, xb, yb, 0.01, layout)
    b = mlp_local_sgd_cuda(rows, xb, yb, 0.01, layout)
    assert torch.equal(a, b)
    for r in (0, 137, 299):
        one = mlp_local_sgd_cuda(rows[r:r + 1].contiguous(),
                                 xb[r:r + 1].contiguous(),
                                 yb[r:r + 1].contiguous(), 0.01, layout)
        assert torch.equal(one[0], a[r])


def test_mlp_sgd_wrapper_refuses_what_the_kernel_does_not_take(card):
    rows, xb, yb, layout = sgd_inputs(card, 4, 2, 10)
    with pytest.raises(ValueError, match="CUDA"):
        mlp_local_sgd_cuda(rows.cpu(), xb.cpu(), yb.cpu(), 0.01, layout)
    with pytest.raises(ValueError, match="contiguous"):
        mlp_local_sgd_cuda(rows, xb.transpose(0, 1).contiguous().transpose(
            0, 1), yb, 0.01, layout)
    with pytest.raises(ValueError, match="int32"):
        mlp_local_sgd_cuda(rows, xb, yb.long(), 0.01, layout)
    with pytest.raises(ValueError, match="float32"):
        mlp_local_sgd_cuda(rows.double(), xb, yb, 0.01, layout)
    deep = ParamLayout.of(init_mlp(jr.PRNGKey(0), (784, 200, 8, 10),
                                   device=card))
    with pytest.raises(ValueError, match="layout"):
        mlp_local_sgd_cuda(torch.zeros(4, deep.width, device=card), xb, yb,
                           0.01, deep)
    big_batch = torch.zeros(4, 2, 33, 784, device=card)
    with pytest.raises(ValueError, match="no launch plan"):
        mlp_local_sgd_cuda(rows, big_batch, torch.zeros(
            4, 2, 33, dtype=torch.int32, device=card), 0.01, layout)


@contextlib.contextmanager
def placed_over(devices):
    rule = E._client_mesh
    E._client_mesh = lambda k, device=None: ClientPlacement(tuple(devices), k)
    try:
        yield
    finally:
        E._client_mesh = rule


@pytest.mark.parametrize("path", ["dense", "sparse", "placed"])
def test_mlp_runs_take_the_kernel_on_the_card(card, path, monkeypatch):
    """The MLP under plain SGD on the card: one kernel launch a round (a
    block a round placed, the blocks over the visible cards, each launch
    on its block's card), ``local_sgd.kernel`` counted and
    ``local_sgd.autograd`` never; the same run on the CPU takes the
    autograd loop and agrees at the golden tolerance."""
    from repro_torch.obs import telemetry
    K, T, blocks = 24, 6, 4
    clients, test, h, params = small_world(card, K, T)
    kw = SPARSE_KW if path == "sparse" else dict(data_path="device")
    cfg = SimConfig(rounds=T, local_iters=3, batch_size=4, eval_every=2,
                    participation="sparse" if path == "sparse" else "dense",
                    participant_bucket=K, **kw)
    policy, cell = RandomScheme(0.25, K), CellConfig(num_clients=K)
    n = torch.cuda.device_count()   # the blocks over every visible card
    cards = [torch.device("cuda", i % n) for i in range(blocks)]

    def run(device):
        tel = telemetry.Telemetry()
        monkeypatch.setattr(telemetry, "_TELEMETRY", tel)
        on = [Dataset(c.x.to(device), c.y.to(device), 10) for c in clients]
        ctx = placed_over(cards) if (
            path == "placed" and device == card) else contextlib.nullcontext()
        with ctx:
            res = make_runner(
                mlp_loss, mlp_accuracy, on,
                Dataset(test.x.to(device), test.y.to(device), 10), policy,
                cell, cfg, device=device, shard_clients=path == "placed")(
                [{k: v.to(device) for k, v in p.items()} for p in params],
                h.to(device))
        c = tel.counters
        return res, (c.get("local_sgd.kernel", 0),
                     c.get("local_sgd.autograd", 0))

    before = mlp_local_sgd_cuda.launches
    got, on_card = run(card)
    calls = T * (blocks if path == "placed" else 1)
    assert on_card == (calls, 0)
    assert mlp_local_sgd_cuda.launches == before + calls
    want, on_cpu = run(torch.device("cpu"))
    assert on_cpu == (0, T)
    np.testing.assert_array_equal(got.participation, want.participation)
    for field in ("energy_per_client", "test_acc", "test_loss"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=1e-4, atol=1e-5, err_msg=field)
    torch.testing.assert_close(got.state.global_params.cpu(),
                               want.state.global_params, rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the dense round loop enqueues without waiting for the card
# ---------------------------------------------------------------------------

@pytest.fixture
def watch_rounds(monkeypatch):
    """``torch.cuda.set_sync_debug_mode("error")`` from the moment a dense
    run's carry is made (``init_carry``) to its readback (``_to_result``):
    a host-to-device copy of a number or a wait for the card in the round
    loop raises.  Yields the list of watched runs."""
    watched = []
    init, readback = E.init_carry, E._to_result

    def init_then_watch(*args, **kw):
        carry = init(*args, **kw)
        torch.cuda.set_sync_debug_mode("error")
        watched.append(True)
        return carry

    def unwatch_then_read(*args, **kw):
        torch.cuda.set_sync_debug_mode(0)
        return readback(*args, **kw)

    monkeypatch.setattr(E, "init_carry", init_then_watch)
    monkeypatch.setattr(E, "_to_result", unwatch_then_read)
    try:
        yield watched
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("blocks", [1, 4])
def test_dense_round_loop_has_no_host_sync(card, watch_rounds, blocks):
    """A dense run at K 1,000 (the paper's MLP through ``mlp_sgd``, the
    device store, evals) unplaced and over 4 virtual blocks of the card,
    its round loop watched: nothing raises, and the masks, eval rounds and
    ``last_tx`` equal the same run's on the CPU."""
    K, T, N = 1000, 6, 16
    torch.cuda.set_sync_debug_mode("error")
    try:   # the watch is armed on this build: a pageable copy raises
        with pytest.raises(RuntimeError):
            torch.tensor(1, device=card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    gen = torch.Generator().manual_seed(K)
    store = DeviceDataStore(
        torch.randn(K, N, 784, generator=gen),
        torch.randint(0, 10, (K, N), generator=gen, dtype=torch.int32),
        torch.randint(4, N + 1, (K,), generator=gen, dtype=torch.int32))
    test = Dataset(store.x[:256, 0], store.y[:256, 0], 10)
    h = torch.rand(K, T, generator=gen) * 9.9e-13 + 1e-14
    params = init_mlp(jr.PRNGKey(4), device="cpu")
    cfg = SimConfig(rounds=T, local_iters=2, batch_size=10, eval_every=2,
                    eval_batch=256, data_path="device")
    policy, cell = RandomScheme(0.1, K), CellConfig(num_clients=K)

    def run(device):
        on = DeviceDataStore(*(v.to(device) for v in store))
        return make_runner(
            mlp_loss, mlp_accuracy, on,
            Dataset(test.x.to(device), test.y.to(device), 10), policy, cell,
            cfg, device=device, shard_clients=blocks > 1)(
            [{k: v.to(device) for k, v in p.items()} for p in params],
            h.to(device))

    ctx = placed_over([card] * blocks) if blocks > 1 \
        else contextlib.nullcontext()
    with ctx:
        got = run(card)
    assert len(watch_rounds) == 1
    if blocks > 1:
        assert isinstance(got.state.client_params, RowBlocks)
        assert len(got.state.client_params) == blocks
    want = run(torch.device("cpu"))
    np.testing.assert_array_equal(got.participation, want.participation)
    np.testing.assert_array_equal(got.eval_rounds, want.eval_rounds)
    assert torch.equal(got.state.last_tx.cpu(), want.state.last_tx)
