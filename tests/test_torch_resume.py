"""Resumable runs, checkpoints and the optimizers of the port.

The counterparts of tests/test_resume.py's eight tests (segments cover the
horizon; a segmented run equals one run; kill and resume reproduce the
uninterrupted run, faults included; a finished directory reruns nothing;
replay evals on the segment boundaries; a fingerprint mismatch, the
prestack path and a missing marker) and tests/test_optim_ckpt.py's five
(SGD, momentum and Adam converge; a checkpoint round trip; a structure
mismatch), on the port; then the port's ``run_resumable`` against JAX's
on the same world, ``momentum``/``adam`` against JAX's on the same
gradients and through a run, and checkpoints across the two packages.

Segmented, killed-and-resumed and uninterrupted runs of the port are held
bit for bit to one another; the port to JAX with masks bit for bit and
floats within rtol 1e-4, atol 1e-5.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
import repro.fl.faults as jf
import repro.optim as joptim
from repro.core import CellConfig as JCell
from repro.core.channel import channel_gains as j_channel_gains
from repro.core.channel import sample_positions as j_sample_positions
from repro.core.selection import RandomScheme as JRandom
from repro.data import make_mnist_like as j_make_mnist_like
from repro.data import shard_noniid as j_shard_noniid
from repro.data.synthetic import Dataset as JDataset
from repro.fl import GuardConfig as JGuard
from repro.fl import SimConfig as JSimConfig
from repro.fl import make_runner as j_make_runner
from repro.fl import run_resumable as j_run_resumable
from repro.models.small import init_mlp as j_init_mlp
from repro.models.small import mlp_accuracy as j_mlp_accuracy
from repro.models.small import mlp_loss as j_mlp_loss
import repro_torch.fl.faults as tf
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import CellConfig
from repro_torch.core.selection import RandomScheme
from repro_torch.data import Dataset
from repro_torch.fl import (GuardConfig, SimConfig, completed_segments,
                            init_carry, make_runner, read_segment_manifest,
                            run_resumable, run_simulation, segment_bounds,
                            sparse)
from repro_torch.models.small import mlp_accuracy, mlp_loss
from repro_torch.obs.telemetry import get_telemetry
from repro_torch.optim import adam, apply_updates, momentum, sgd

DIM = 64
K, T = 5, 12
RTOL, ATOL = 1e-4, 1e-5        # tests/golden/harness.py
BASE = dict(rounds=T, local_iters=1, batch_size=8, eval_every=4,
            eval_batch=200, data_path="device")
FAULTS = dict(p_loss=0.3, max_retries=1, p_corrupt=0.3, corrupt_mode="nan")
GUARDS = dict(quarantine=True, clip_norm=10.0)


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


CELL = CellConfig(num_clients=K)
POLICY = RandomScheme(p_bar=0.5, num_clients=K)


def faulty(**kw):
    return SimConfig(**BASE, **kw, faults=tf.FaultConfig(**FAULTS),
                     guards=GuardConfig(**GUARDS))


def whole_run(world, cfg, **kw):
    return run_simulation(world["t_params"], mlp_loss, mlp_accuracy,
                          world["t_clients"], world["t_test"], POLICY,
                          world["t_h"], CELL, cfg, device="cpu", **kw)


def resumable(world, cfg, path, **kw):
    return run_resumable(world["t_params"], mlp_loss, mlp_accuracy,
                         world["t_clients"], world["t_test"], POLICY,
                         world["t_h"], CELL, cfg, str(path), device="cpu",
                         **kw)


def bit_equal(a, b, evals=True):
    names = ["participation", "energy_per_client", "energy_timeline",
             "delivered", "corrupted"]
    if evals:
        names += ["eval_rounds", "test_acc", "test_loss"]
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None, name
            continue
        np.testing.assert_array_equal(x, y, err_msg=name)
    for f in ("global_params", "client_params", "anchor_params", "round",
              "last_tx"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


# --- tests/test_resume.py's eight, on the port -------------------------------


def test_segment_bounds_cover_the_horizon():
    assert segment_bounds(10, 4) == [(0, 4), (4, 8), (8, 10)]
    assert segment_bounds(8, 4) == [(0, 4), (4, 8)]
    assert segment_bounds(3, 100) == [(0, 3)]


@pytest.mark.parametrize("stride", [1, 5, 12])
def test_chunked_equals_single_scan(world, tmp_path, stride):
    """Segmenting the horizon changes no stream and no operation: the
    resumable run's result is the single run's, bit for bit."""
    cfg = SimConfig(**BASE, checkpoint_every=stride)
    bit_equal(resumable(world, cfg, tmp_path), whole_run(world, cfg))


@pytest.mark.parametrize("path", ["device", "stream"])
def test_kill_and_resume_reproduces_exactly(world, tmp_path, path):
    """Stop after one committed segment, resume in a fresh call: the
    uninterrupted run's bits — faults, guards and all."""
    cfg = dataclasses.replace(faulty(checkpoint_every=4), data_path=path)
    whole = whole_run(world, cfg)
    killed = resumable(world, cfg, tmp_path, stop_after_segment=1)
    assert killed is None
    assert completed_segments(str(tmp_path), len(segment_bounds(T, 4))) == 1
    resumed = resumable(world, cfg, tmp_path)
    bit_equal(resumed, whole)
    assert np.isnan(resumed.test_loss).any() or resumed.corrupted.sum() > 0


def test_resume_skips_completed_segments(world, tmp_path):
    cfg = SimConfig(**BASE, checkpoint_every=4)
    first = resumable(world, cfg, tmp_path)
    n_seg = len(segment_bounds(T, 4))
    assert completed_segments(str(tmp_path), n_seg) == n_seg
    spans = get_telemetry().span_stats("resume.segment")["count"]
    again = resumable(world, cfg, tmp_path)
    assert get_telemetry().span_stats("resume.segment")["count"] == spans
    bit_equal(first, again)
    assert len(read_segment_manifest(str(tmp_path))) == n_seg


def test_replay_eval_mode_boundary_checkpoints(world, tmp_path):
    """``eval_mode="replay"``: no eval in the rounds; the segment-boundary
    models are evaluated afterwards in one batched pass, the final model is
    the in-loop run's bit for bit and its eval agrees."""
    inscan = whole_run(world, SimConfig(**BASE))
    cfg = SimConfig(**BASE, eval_mode="replay", checkpoint_every=4)
    rep = resumable(world, cfg, tmp_path)
    assert torch.equal(inscan.state.global_params, rep.state.global_params)
    np.testing.assert_array_equal(rep.eval_rounds, [3, 7, 11])
    assert np.isfinite(rep.test_acc).all()
    np.testing.assert_allclose(rep.test_acc[-1], inscan.test_acc[-1],
                               atol=1e-6)
    np.testing.assert_allclose(rep.test_loss[-1], inscan.test_loss[-1],
                               rtol=RTOL, atol=ATOL)


def test_fingerprint_mismatch_rejected(world, tmp_path):
    cfg = SimConfig(**BASE, checkpoint_every=4)
    resumable(world, cfg, tmp_path, stop_after_segment=1)
    other = SimConfig(**{**BASE, "seed": 99}, checkpoint_every=4)
    with pytest.raises(ValueError, match="different run"):
        resumable(world, other, tmp_path)


def test_prestack_path_cannot_resume(world, tmp_path):
    cfg = SimConfig(**{**BASE, "data_path": "prestack"}, checkpoint_every=4)
    with pytest.raises(ValueError, match="prestack"):
        resumable(world, cfg, tmp_path)


def test_marker_gap_truncates_restore(world, tmp_path):
    cfg = SimConfig(**BASE, checkpoint_every=4)
    whole = resumable(world, cfg, tmp_path)
    os.remove(os.path.join(str(tmp_path), "seg_00001.done"))
    assert completed_segments(str(tmp_path),
                              len(segment_bounds(T, 4))) == 1
    redone = resumable(world, cfg, tmp_path)
    bit_equal(whole, redone)
    segs = [e["segment"] for e in read_segment_manifest(str(tmp_path))]
    assert segs == [0, 1, 2, 1, 2]


# --- the port against JAX's run_resumable ------------------------------------


@pytest.mark.parametrize("case", ["device-faults", "stream-replay"])
def test_run_resumable_matches_jax(world, tmp_path, case):
    path, mode = case.split("-")
    kw = dict(BASE, data_path=path, checkpoint_every=4, stream_chunk=4)
    if mode == "faults":
        jcfg = JSimConfig(**kw, faults=jf.FaultConfig(**FAULTS),
                          guards=JGuard(**GUARDS))
        tcfg = SimConfig(**kw, faults=tf.FaultConfig(**FAULTS),
                         guards=GuardConfig(**GUARDS))
    else:
        jcfg = JSimConfig(**kw, eval_mode="replay")
        tcfg = SimConfig(**kw, eval_mode="replay")
    want = j_run_resumable(world["params"], j_mlp_loss, j_mlp_accuracy,
                           world["clients"], world["test"],
                           JRandom(p_bar=0.5, num_clients=K), world["h"],
                           JCell(num_clients=K), jcfg, str(tmp_path / "j"))
    got = run_resumable(world["t_params"], mlp_loss, mlp_accuracy,
                        world["t_clients"], world["t_test"], POLICY,
                        world["t_h"], CELL, tcfg, str(tmp_path / "t"),
                        device="cpu")
    for name in ("participation", "eval_rounds", "delivered", "corrupted"):
        a, b = getattr(got, name), getattr(want, name)
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(got.state.last_tx.numpy(),
                                  np.asarray(want.state.last_tx))
    leaves = jax.tree_util.tree_leaves(params_to_numpy(
        got.state.layout.unflatten(got.state.global_params)))
    pairs = list(zip(leaves, jax.tree_util.tree_leaves(
        want.state.global_params)))
    pairs += [(got.test_acc, want.test_acc), (got.test_loss, want.test_loss),
              (got.energy_per_client, want.energy_per_client)]
    for a, b in pairs:
        np.testing.assert_array_equal(np.isnan(a), np.isnan(np.asarray(b)))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   equal_nan=True)
    # the same files, one segment a stride
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))


def test_segment_checkpoint_holds_the_carry(world, tmp_path):
    """A segment's checkpoint is the carry: FLState's tensors, the energy
    ledger and the fault state, restored into ``init_carry``'s structure
    (the layout comes from ``like``)."""
    cfg = faulty(checkpoint_every=6)
    resumable(world, cfg, tmp_path)
    like = init_carry(world["t_params"], K, cfg, "cpu")
    carry, meta = load_checkpoint(str(tmp_path / "seg_00001"), like)
    assert (meta["t0"], meta["t1"], meta["segment"]) == (6, 12, 1)
    assert carry[0].layout is like[0].layout
    assert int(carry[0].round) == T
    assert carry[2].avail.dtype == torch.bool
    entries = read_segment_manifest(str(tmp_path))
    assert [e["segment"] for e in entries] == [0, 1]
    assert entries[0]["fingerprint"]["torch"] == torch.__version__


# --- tests/test_optim_ckpt.py's five, on the port ----------------------------


def quad_grads(p):
    """The gradient of Σ(x − 3)² + Σ(y + 1)² on the flat row [x | y]."""
    target = torch.tensor([3.0] * 4 + [-1.0] * 3)
    return 2.0 * (p - target)


def run_opt(opt, steps=200):
    params = torch.zeros(7)
    state = opt.init(params)
    for _ in range(steps):
        upd, state = opt.update(quad_grads(params), state, params)
        params = apply_updates(params, upd)
    return params


def test_sgd_converges():
    assert torch.allclose(run_opt(sgd(0.1))[:4], torch.tensor(3.0),
                          atol=1e-3)


def test_momentum_converges():
    assert torch.allclose(run_opt(momentum(0.05))[:4], torch.tensor(3.0),
                          atol=1e-2)


def test_adam_converges():
    assert torch.allclose(run_opt(adam(0.1), steps=400)[4:],
                          torch.tensor(-1.0), atol=1e-2)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": [torch.ones(2), {"c": torch.zeros(1, dtype=torch.int32)}]}
    path = os.path.join(tmp_path, "ckpt")
    save_checkpoint(path, tree, metadata={"round": 7})
    like = {"a": torch.zeros(2, 3),
            "b": [torch.zeros(2), {"c": torch.ones(1, dtype=torch.int32)}]}
    restored, meta = load_checkpoint(path, like)
    assert meta["round"] == 7
    assert restored["b"][1]["c"].dtype == torch.int32
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["b"][0], tree["b"][0])


def test_checkpoint_structure_mismatch(tmp_path):
    path = os.path.join(tmp_path, "ckpt")
    save_checkpoint(path, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="1 leaves"):
        load_checkpoint(path, {"a": torch.ones(2), "b": torch.ones(2)})


# --- optimizers against JAX's ------------------------------------------------


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizers_match_jax_on_the_same_gradients(name):
    """Sixty steps on the same gradient sequence; Adam's ``1 − b^t`` are
    float32 powers (here float64 rounded once), so its steps hold to a
    few ulp, not bit for bit."""
    make = {"sgd": (joptim.sgd, sgd, dict(lr=0.05)),
            "momentum": (joptim.momentum, momentum, dict(lr=0.05,
                                                         beta=0.9)),
            "adam": (joptim.adam, adam, dict(lr=0.01))}[name]
    jopt, topt = make[0](**make[2]), make[1](**make[2])
    rng = np.random.default_rng(0)
    grads = rng.standard_normal((60, 33)).astype(np.float32)
    jp = {"x": jnp.zeros(33)}
    tp = torch.zeros(33)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update({"x": jnp.asarray(g)}, js, jp)
        jp = joptim.optim.apply_updates(jp, ju)
        tu, ts = topt.update(torch.from_numpy(g), ts, tp)
        tp = apply_updates(tp, tu)
    want = np.asarray(jp["x"])
    if name == "adam":
        assert int(ts[2]) == int(js[2]) == 60
        np.testing.assert_allclose(tp.numpy(), want, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_array_equal(tp.numpy(), want)


@pytest.mark.parametrize("name", ["momentum", "adam"])
def test_runs_with_momentum_and_adam_match_jax(world, name):
    """The optimizer's state restarts every round (``local_train`` calls
    ``init``), as in JAX; L = 3 local steps."""
    kw = dict(BASE, local_iters=3, rounds=6, eval_every=2)
    jopt = getattr(joptim, name)(0.01)
    topt = {"momentum": momentum, "adam": adam}[name](0.01)
    want = j_make_runner(j_mlp_loss, j_mlp_accuracy, world["clients"],
                         world["test"], JRandom(0.5, K),
                         JCell(num_clients=K), JSimConfig(**kw), opt=jopt)(
        world["params"], world["h"][:, :6])
    got = make_runner(mlp_loss, mlp_accuracy, world["t_clients"],
                      world["t_test"], POLICY, CELL, SimConfig(**kw),
                      opt=topt, device="cpu")(world["t_params"],
                                              world["t_h"][:, :6])
    np.testing.assert_array_equal(got.participation, want.participation)
    leaves = jax.tree_util.tree_leaves(params_to_numpy(
        got.state.layout.unflatten(got.state.global_params)))
    for a, b in zip(leaves, jax.tree_util.tree_leaves(
            want.state.global_params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.test_loss, want.test_loss, rtol=RTOL,
                               atol=ATOL)


def test_sparse_cache_keeps_explicit_optimizers_apart(world):
    """The sparse runner caches phase B under the default optimizer's
    ``(kind, lr)``; an explicit momentum builds its own program and equals
    the dense engine's run with the same optimizer."""
    kw = dict(BASE, local_mode="participants", data_stream="client",
              participation="sparse", participant_bucket=K, local_iters=2,
              rounds=6, eval_every=2)
    cfg = SimConfig(**kw)
    h = world["t_h"][:, :6]
    results = {}
    for name, opt in (("sgd", None), ("momentum", momentum(0.01))):
        before = sparse.train_trace_count()
        results[name] = make_runner(
            mlp_loss, mlp_accuracy, world["t_clients"], world["t_test"],
            POLICY, CELL, cfg, opt=opt, device="cpu")(world["t_params"], h)
    assert sparse.train_trace_count() == before + 1
    dense = make_runner(mlp_loss, mlp_accuracy, world["t_clients"],
                        world["t_test"], POLICY, CELL,
                        SimConfig(**{**kw, "participation": "dense"}),
                        opt=momentum(0.01), device="cpu")(world["t_params"],
                                                          h)
    np.testing.assert_allclose(results["momentum"].state.global_params,
                               dense.state.global_params, rtol=RTOL,
                               atol=ATOL)
    assert not torch.equal(results["sgd"].state.global_params,
                           results["momentum"].state.global_params)


def test_port_reads_a_jax_checkpoint(tmp_path):
    """The same files: a JAX-written checkpoint restores into the port's
    structure (dict keys sorted, sequences in order)."""
    tree = {"w": jnp.arange(6.0).reshape(2, 3),
            "b": [jnp.ones((2,)), {"n": jnp.array([4], jnp.int32)}]}
    path = str(tmp_path / "j")
    jckpt.save_checkpoint(path, tree, metadata={"round": 3})
    like = {"w": torch.zeros(2, 3),
            "b": [torch.zeros(2), {"n": torch.zeros(1, dtype=torch.int32)}]}
    got, meta = load_checkpoint(path, like)
    assert meta == {"round": 3}
    assert torch.equal(got["w"], torch.arange(6.0).reshape(2, 3))
    assert torch.equal(got["b"][1]["n"], torch.tensor([4], dtype=torch.int32))
