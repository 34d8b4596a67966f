"""Data and model of the port against the JAX package: the synthetic MNIST
stand-in, the non-IID shards, the device store's per-round and per-client
minibatch streams, the participant gather and the store footprint, and the
MLP (init, loss, accuracy, gradients, stacked over clients).

Integer outputs (labels, shard membership, minibatch indices) must match bit
for bit.  Floats: inputs built through ``normal`` to 1e-5 (erfinv rounds a
few ulps apart, then a 49-term product and tanh); the MLP to rtol 1e-5 on
the same weights and inputs (products summed in another order).
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.device as jdev
from _hypothesis_stub import given, settings, st
from repro.data import Dataset as JDataset
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
from repro_torch.data import (Dataset, client_round_indices, data_stream_key,
                              estimate_store_bytes, from_client_datasets,
                              gather_participant_rounds, make_mnist_like,
                              round_indices, round_indices_client_stream,
                              sample_round, sample_round_client_stream,
                              shard_noniid, store_bytes)
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


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("t", [0, 17])
def test_client_stream_bit_exact(stores, seed, t):
    """The per-client stream (``data_stream="client"``): indices, batches and
    one client's direct draw equal JAX's; row k is client k's own draw."""
    want, mine = stores
    key, jkey = data_stream_key(seed), j_data_stream_key(seed)
    idx = round_indices_client_stream(key, t, mine.lengths, 5, 10)
    widx = jdev.round_indices_client_stream(jkey, jnp.int32(t), want.lengths,
                                            5, 10)
    assert idx.shape == (K, 5, 10) and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    assert (idx.numpy() < mine.lengths.numpy()[:, None, None]).all()
    x, y = sample_round_client_stream(mine, key, t, 5, 10)
    wx, wy = jdev.sample_round_client_stream(want, jkey, jnp.int32(t), 5, 10)
    np.testing.assert_array_equal(x.numpy(), np.asarray(wx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(wy))
    for k in (0, K - 1):
        one = client_round_indices(key, t, k, mine.lengths[k], 5, 10)
        np.testing.assert_array_equal(one.numpy(), idx[k].numpy())


def test_participant_gather_bit_exact(stores):
    """Every round's participants at once, padding lanes (id K) included:
    JAX's raw-id hash and clamped row, bit for bit."""
    want, mine = stores
    part = np.array([[0, 3, 9, K], [2, K, K, K], [1, 4, 5, 8]], np.int32)
    x, y = gather_participant_rounds(mine, data_stream_key(5),
                                     torch.from_numpy(part), 3, 4)
    wx, wy = jdev.gather_participant_rounds(want, j_data_stream_key(5),
                                            jnp.asarray(part), 3, 4)
    assert x.shape == (3, 4, 3, 4, 784) and y.shape == (3, 4, 3, 4)
    np.testing.assert_array_equal(x.numpy(), np.asarray(wx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(wy))


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 16), st.integers(0, 7),
       st.lists(st.integers(1, 9), min_size=2, max_size=6),
       st.integers(0, 2 ** 10))
def test_property_participant_gather_matches_dense_stream(seed, t, lens,
                                                          subset_bits):
    """tests/test_sparse_engine.py's property on the port, held against JAX
    too: indices never land in padding, and gathering a participant subset
    equals the same rows of the dense client-stream draw."""
    n = len(lens)
    key = data_stream_key(seed)
    lengths = torch.tensor(lens, dtype=torch.int32)
    idx = round_indices_client_stream(key, t, lengths, 2, 3)
    assert ((idx >= 0) & (idx < lengths[:, None, None])).all()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(
        jdev.round_indices_client_stream(j_data_stream_key(seed),
                                         jnp.int32(t), jnp.asarray(lens), 2,
                                         3)))
    # x rows encode (client, example)
    store = from_client_datasets([Dataset(
        (torch.arange(m, dtype=torch.float32)[:, None] + 100.0 * k)
        * torch.ones(1, 2), torch.full((m,), k % 4, dtype=torch.int32), 4)
        for k, m in enumerate(lens)], device="cpu")
    dense_x, dense_y = sample_round_client_stream(store, key, t, 2, 3)
    chosen = [k for k in range(n) if (subset_bits >> k) & 1]
    bucket = len(chosen) + 1                          # ≥ 1 padding lane
    part = torch.tensor(chosen + [n] * (bucket - len(chosen)),
                        dtype=torch.int32)
    gx, gy = gather_participant_rounds(store, key, part.repeat(t + 1, 1), 2,
                                       3)
    for p, k in enumerate(chosen):
        assert torch.equal(gx[t, p], dense_x[k])
        assert torch.equal(gy[t, p], dense_y[k])


def test_store_bytes_match_jax_and_the_built_store(stores):
    want, mine = stores
    clients = [Dataset(torch.ones(m, 5), torch.zeros(m, dtype=torch.int32), 3)
               for m in (4, 9, 6)]
    assert estimate_store_bytes(clients) == from_client_datasets(
        clients, device="cpu").nbytes == jdev.estimate_store_bytes(
        [JDataset(jnp.ones((m, 5)), jnp.zeros((m,), jnp.int32), 3)
         for m in (4, 9, 6)])
    assert store_bytes(K, mine.x.shape[1], (784,)) == mine.nbytes
    for args in ((10 ** 6, 8, (784,)), (10 ** 9, 64, (28, 28)),
                 (3, 5, (2, 3), 2)):
        assert store_bytes(*args) == jdev.store_bytes(*args)
    assert store_bytes(10 ** 6, 8, (784,)) == 25_124_000_000   # 25.1 GB


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
