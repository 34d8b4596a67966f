"""The port's CIFAR-like data and CNN (repro_torch.data.make_cifar_like,
repro_torch.models.small's cnn) against the JAX package's on the CPU.

Labels are bit for bit and the inputs within atol 1e-5 (the erfinv of
``normal`` differs by a few ulp, as for make_mnist_like); the initial
weights carry across with ``params_from_jax`` and back with
``params_to_numpy``; logits, per-client losses and per-client gradients
(params stacked over R 3 clients, JAX's ``vmap(grad)``) within rtol 1e-4,
atol 1e-5 at the test widths and at the defaults; the flat rows are W
34,524 and 620,364; and ``run_simulation`` with the CNN as
tests/test_system.py's ``test_e2e_cnn_cifar_like`` runs it: masks bit for
bit, accuracy, loss and energy within the same tolerance."""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CellConfig as JCell
from repro.core import ProblemSpec as JSpec
from repro.core.channel import channel_gains as j_channel_gains
from repro.core.channel import sample_positions as j_sample_positions
from repro.core.selection import ProposedOnline as JProposed
from repro.data import make_cifar_like as j_make_cifar_like
from repro.data import shard_noniid as j_shard_noniid
from repro.fl import SimConfig as JSimConfig
from repro.fl import run_simulation as j_run_simulation
from repro.models.small import cnn_accuracy as j_cnn_accuracy
from repro.models.small import cnn_logits as j_cnn_logits
from repro.models.small import cnn_loss as j_cnn_loss
from repro.models.small import init_cnn as j_init_cnn
from repro_torch import random as jr
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import CellConfig, ProblemSpec
from repro_torch.core.selection import ProposedOnline
from repro_torch.data import Dataset, make_cifar_like
from repro_torch.fl import SimConfig, run_simulation
from repro_torch.fl.state import ParamLayout
from repro_torch.models.small import (cnn_accuracy, cnn_logits, cnn_loss,
                                      init_cnn)

RTOL, ATOL = 1e-4, 1e-5        # tests/golden/harness.py
SMALL = dict(widths=(8, 16), fc=32)
SIZES = {"small": (SMALL, 34_522, 34_524), "default": ({}, 620_362, 620_364)}


def to_torch(ds):
    return Dataset(torch.from_numpy(np.array(ds.x)),
                   torch.from_numpy(np.array(ds.y)), ds.num_classes)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_init():
    """JAX's ``init_cnn(PRNGKey(4))`` at each size, as numpy (JAX compiles
    each weight draw: ~5 s a size on this CPU)."""
    return {size: np_tree(j_init_cnn(jax.random.PRNGKey(4), **kw))
            for size, (kw, _, _) in SIZES.items()}


@pytest.fixture(scope="module")
def jax_data():
    """tests/test_system.py's CIFAR-like data: 800/200 examples."""
    return j_make_cifar_like(jax.random.PRNGKey(0), n_train=800, n_test=200)


def test_make_cifar_like_matches(jax_data):
    tr, te = make_cifar_like(jr.PRNGKey(0), n_train=800, n_test=200,
                             device="cpu")
    for mine, want in ((tr, jax_data[0]), (te, jax_data[1])):
        assert tuple(mine.x.shape) == tuple(want.x.shape)
        assert mine.x.shape[1:] == (32, 32, 3)
        np.testing.assert_array_equal(mine.y.numpy(), np.asarray(want.y))
        assert mine.y.dtype == torch.int32 and mine.num_classes == 10
        np.testing.assert_allclose(mine.x.numpy(), np.asarray(want.x),
                                   atol=1e-5)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_init_cnn_carries_across(jax_init, size):
    kw, n_params, width = SIZES[size]
    jp = jax_init[size]
    mine = init_cnn(jr.PRNGKey(4), device="cpu", **kw)
    carried = params_from_jax(jp, device="cpu")
    assert [sorted(layer) for layer in mine] == [["b", "w"]] * len(carried)
    for a, b in zip(mine, carried):
        for k in a:
            assert a[k].shape == b[k].shape
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                       rtol=1e-6, atol=1e-7)
    layout = ParamLayout.of(carried)
    assert (layout.size, layout.width) == (n_params, width)
    back = params_to_numpy(carried)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, b)


def _stacked(jp, R):
    """JAX params stacked over R clients, each a little different."""
    return jax.tree_util.tree_map(
        lambda p: jnp.stack([p * (1.0 + 0.05 * r) for r in range(R)]),
        jax.tree_util.tree_map(jnp.asarray, jp))


@pytest.mark.parametrize("size", sorted(SIZES))
def test_logits_loss_and_per_client_grads_match_jax(jax_init, jax_data,
                                                    size):
    R, B = 3, 4
    jst = _stacked(jax_init[size], R)
    x = np.array(jax_data[0].x[:R * B]).reshape(R, B, 32, 32, 3)
    y = np.array(jax_data[0].y[:R * B]).reshape(R, B)
    tst = params_from_jax(np_tree(jst), device="cpu")
    layout = ParamLayout.of(params_from_jax(jax_init[size], device="cpu"))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    np.testing.assert_allclose(
        cnn_logits(tst, tx).numpy(), np.asarray(jax.vmap(j_cnn_logits)(
            jst, jnp.asarray(x))), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        cnn_loss(tst, tx, ty).numpy(), np.asarray(jax.vmap(j_cnn_loss)(
            jst, jnp.asarray(x), jnp.asarray(y))), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        cnn_accuracy(tst, tx, ty).numpy(),
        np.asarray(jax.vmap(j_cnn_accuracy)(jst, jnp.asarray(x),
                                            jnp.asarray(y))))
    # the flat [R, W] rows, as make_local_train differentiates them
    flat = torch.stack([layout.flatten(
        [{k: v[r] for k, v in layer.items()} for layer in tst])
        for r in range(R)]).requires_grad_(True)
    loss = cnn_loss(layout.unflatten(flat), tx, ty).sum()
    (g,) = torch.autograd.grad(loss, flat)
    jg = jax.vmap(jax.grad(j_cnn_loss))(jst, jnp.asarray(x), jnp.asarray(y))
    want = params_to_numpy(params_from_jax(np_tree(jg), device="cpu"))
    got = params_to_numpy(layout.unflatten(g))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    # one client unstacked = its lane of the stacked call
    one = [{k: v[1] for k, v in layer.items()} for layer in tst]
    np.testing.assert_allclose(cnn_logits(one, tx[1]).numpy(),
                               cnn_logits(tst, tx)[1].detach().numpy(),
                               rtol=RTOL, atol=ATOL)


def test_convolutions_leave_the_tf32_flag_as_found():
    params = init_cnn(jr.PRNGKey(4), device="cpu", **SMALL)
    x = torch.zeros(2, 32, 32, 3)
    for flag in (True, False):
        torch.backends.cudnn.allow_tf32 = flag
        try:
            cnn_logits(params, x)
            assert torch.backends.cudnn.allow_tf32 is flag
        finally:
            torch.backends.cudnn.allow_tf32 = True


def test_run_simulation_with_the_cnn_matches_jax(jax_init, jax_data):
    """tests/test_system.py's test_e2e_cnn_cifar_like on both sides."""
    tr, te = jax_data
    clients = j_shard_noniid(jax.random.PRNGKey(1), tr, 10, d=5)
    jcell = JCell(num_clients=10)
    h = j_channel_gains(jax.random.PRNGKey(3),
                        j_sample_positions(jax.random.PRNGKey(2), jcell), 4).T
    jp = jax.tree_util.tree_map(jnp.asarray, jax_init["small"])
    cfg_kw = dict(rounds=4, local_iters=1, batch_size=16, eval_every=3,
                  eval_batch=200)
    want = j_run_simulation(jp, j_cnn_loss, j_cnn_accuracy, clients, te,
                            JProposed(JSpec(cell=jcell, rho=0.05,
                                            num_rounds=4)),
                            h, jcell, JSimConfig(**cfg_kw))
    cell = CellConfig(num_clients=10)
    got = run_simulation(params_from_jax(jax_init["small"], device="cpu"),
                         cnn_loss, cnn_accuracy,
                         [to_torch(c) for c in clients], to_torch(te),
                         ProposedOnline(ProblemSpec(cell=cell, rho=0.05,
                                                    num_rounds=4)),
                         torch.from_numpy(np.array(h)), cell,
                         SimConfig(**cfg_kw), device="cpu")
    np.testing.assert_array_equal(got.participation,
                                  np.asarray(want.participation))
    np.testing.assert_array_equal(got.eval_rounds,
                                  np.asarray(want.eval_rounds))
    assert np.isfinite(got.test_loss).all()
    for field in ("test_acc", "test_loss", "energy_per_client",
                  "energy_timeline"):
        np.testing.assert_allclose(getattr(got, field),
                                   np.asarray(getattr(want, field)),
                                   rtol=RTOL, atol=ATOL, err_msg=field)
    layout = got.state.layout
    assert layout.width == 34_524
    np.testing.assert_allclose(
        got.state.global_params.numpy()[:layout.size],
        np.concatenate([np.asarray(a).reshape(-1) for a in
                        jax.tree_util.tree_leaves(want.state.global_params)]),
        rtol=RTOL, atol=ATOL)
