"""Data and model of the port against the JAX package: the synthetic MNIST
stand-in, the non-IID shards, the device store's per-round minibatch stream,
and the MLP (init, loss, accuracy, gradients, stacked over clients).

Integer outputs (labels, shard membership, minibatch indices) must match bit
for bit.  Floats: inputs built through ``normal`` to 1e-5 (erfinv rounds a
few ulps apart, then a 49-term product and tanh); the MLP to rtol 1e-5 on
the same weights and inputs (products summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import data_stream_key as j_data_stream_key
from repro.data import from_client_datasets as j_from_client_datasets
from repro.data import make_mnist_like as j_make_mnist_like
from repro.data import sample_round as j_sample_round
from repro.data import shard_noniid as j_shard_noniid
from repro.models.small import init_mlp as j_init_mlp
from repro.models.small import mlp_accuracy as j_mlp_accuracy
from repro.models.small import mlp_loss as j_mlp_loss
from repro_torch import random as jr
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.data import (Dataset, data_stream_key, from_client_datasets,
                              make_mnist_like, round_indices, sample_round,
                              shard_noniid)
from repro_torch.fl.state import ParamLayout
from repro_torch.models.small import init_mlp, mlp_accuracy, mlp_loss

K = 10


@pytest.fixture(scope="module")
def jax_data():
    tr, te = j_make_mnist_like(jax.random.PRNGKey(0), n_train=600, n_test=100)
    return tr, te


def test_make_mnist_like_matches(jax_data):
    tr, te = make_mnist_like(jr.PRNGKey(0), n_train=600, n_test=100,
                             device="cpu")
    for mine, want in ((tr, jax_data[0]), (te, jax_data[1])):
        np.testing.assert_array_equal(mine.y.numpy(), np.asarray(want.y))
        assert mine.y.dtype == torch.int32 and mine.num_classes == 10
        np.testing.assert_allclose(mine.x.numpy(), np.asarray(want.x),
                                   atol=1e-5)


@pytest.mark.parametrize("d", [2, 5])
def test_shard_noniid_assigns_the_same_examples(jax_data, d):
    tr = jax_data[0]
    want = j_shard_noniid(jax.random.PRNGKey(1), tr, K, d=d)
    mine = shard_noniid(jr.PRNGKey(1), Dataset(torch.from_numpy(np.array(
        tr.x)), torch.from_numpy(np.array(tr.y)), 10), K, d=d)
    assert len(mine) == K
    for m, w in zip(mine, want):
        np.testing.assert_array_equal(m.y.numpy(), np.asarray(w.y))
        np.testing.assert_array_equal(m.x.numpy(), np.asarray(w.x))


def test_shard_noniid_rejects_bad_d(jax_data):
    tr = jax_data[0]
    ds = Dataset(torch.from_numpy(np.array(tr.x)),
                 torch.from_numpy(np.array(tr.y)), 10)
    with pytest.raises(ValueError, match="divisible"):
        shard_noniid(jr.PRNGKey(1), ds, 3, d=3)


@pytest.fixture(scope="module")
def stores(jax_data):
    clients = j_shard_noniid(jax.random.PRNGKey(1), jax_data[0], K, d=5)
    mine = from_client_datasets(
        [Dataset(torch.from_numpy(np.array(c.x)),
                 torch.from_numpy(np.array(c.y)), 10) for c in clients],
        device="cpu")
    return j_from_client_datasets(clients), mine


def test_store_layout_matches(stores):
    want, mine = stores
    np.testing.assert_array_equal(mine.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(mine.y.numpy(), np.asarray(want.y))
    np.testing.assert_array_equal(mine.lengths.numpy(),
                                  np.asarray(want.lengths))
    assert mine.nbytes == want.nbytes


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("t", [0, 1, 17])
def test_round_batches_bit_exact(stores, seed, t):
    want, mine = stores
    np.testing.assert_array_equal(data_stream_key(seed).numpy(),
                                  np.asarray(j_data_stream_key(seed)))
    wx, wy = j_sample_round(want, j_data_stream_key(seed), jnp.int32(t), 5,
                            10)
    x, y = sample_round(mine, data_stream_key(seed), t, 5, 10)
    assert x.shape == (K, 5, 10, 784)
    np.testing.assert_array_equal(y.numpy(), np.asarray(wy))
    np.testing.assert_array_equal(x.numpy(), np.asarray(wx))
    idx = round_indices(data_stream_key(seed), t, mine.lengths, 5, 10)
    assert (idx.numpy() < mine.lengths.numpy()[:, None, None]).all()


def test_init_mlp_matches():
    want = j_init_mlp(jax.random.PRNGKey(4))
    mine = params_to_numpy(init_mlp(jr.PRNGKey(4), device="cpu"))
    for m, w in zip(mine, want):
        assert m.keys() == w.keys()
        for name in m:
            assert m[name].shape == w[name].shape
            np.testing.assert_allclose(m[name], np.asarray(w[name]),
                                       rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def mlp_world():
    rng = np.random.default_rng(0)
    params = j_init_mlp(jax.random.PRNGKey(4), dims=(64, 24, 10))
    x = rng.standard_normal((K, 8, 64)).astype(np.float32)
    y = rng.integers(0, 10, (K, 8)).astype(np.int32)
    return params, x, y


def test_mlp_loss_accuracy_match(mlp_world):
    params, x, y = mlp_world
    mine = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")
    for k in range(3):
        np.testing.assert_allclose(
            float(mlp_loss(mine, torch.from_numpy(x[k]),
                           torch.from_numpy(y[k]))),
            float(j_mlp_loss(params, x[k], y[k])), rtol=1e-5)
        assert float(mlp_accuracy(mine, torch.from_numpy(x[k]),
                                  torch.from_numpy(y[k]))) == \
            float(j_mlp_accuracy(params, x[k], y[k]))


def test_stacked_gradients_equal_vmap_grad(mlp_world):
    """d/dθ Σ_k loss_k(θ_k) over the stacked row = vmap(grad) per client."""
    params, x, y = mlp_world
    # give every client its own weights
    stacked = jax.tree_util.tree_map(
        lambda p: p[None] * (1.0 + 0.1 * jnp.arange(K).reshape(
            (K,) + (1,) * p.ndim)), params)
    want = jax.vmap(jax.grad(j_mlp_loss))(stacked, x, y)
    layout = ParamLayout.of(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    flat = torch.stack([layout.flatten(params_from_jax(
        jax.tree_util.tree_map(lambda p: np.asarray(p[k]), stacked),
        device="cpu")) for k in range(K)]).requires_grad_(True)
    loss = mlp_loss(layout.unflatten(flat), torch.from_numpy(x),
                    torch.from_numpy(y))
    assert loss.shape == (K,)
    (g,) = torch.autograd.grad(loss.sum(), flat)
    got = params_to_numpy(layout.unflatten(g))
    for gk, wk in zip(jax.tree_util.tree_leaves(got),
                      jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(gk, np.asarray(wk), rtol=1e-5, atol=1e-6)
    assert torch.count_nonzero(g[:, layout.size:]) == 0   # the padding
