"""The partitioners of the port against the JAX package: the random draws
they rest on (``permutation``, ``gumbel``, ``gamma``/``loggamma``,
``dirichlet``), the label-shard and Dirichlet assignments and their stores,
``_default_cap``'s and ``shard_assignment``'s errors, ``label_histogram``
and ``heterogeneity``.

Integer outputs are held bit for bit: ``permutation``, ``shard_assignment``
and ``dirichlet_assignment`` on every seed, K, α and N below.  The float
draws take their transcendental steps in float64 rounded once, where XLA's
float32 ``log``/``log1p``/``exp`` are not correctly rounded: they agree to
a few ulp, and each test asserts the share of draws that are bit-equal.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.device as jdev
from repro.data import Dataset as JDataset
from repro.data import make_mnist_like as j_make_mnist_like
from repro.data import shard_noniid as j_shard_noniid
from repro.data.noniid import heterogeneity as j_heterogeneity
from repro_torch import random as jr
from repro_torch.data import (Dataset, dirichlet_assignment, dirichlet_store,
                              heterogeneity, label_histogram,
                              shard_assignment, shard_store)
from repro_torch.data.device import (DeviceDataStore, _default_cap,
                                     assignment_to_store)

N = 3000
ALPHAS = [0.05, 0.3, 1.0, 100.0]


def tkey(seed):
    return jr.PRNGKey(seed, device="cpu")


def ulps(a, b):
    """|a − b| in ulps of max(|a|, 1) (float32)."""
    a = np.asarray(a, np.float32)
    scale = np.spacing(np.maximum(np.abs(a), np.float32(1.0)))
    return float(np.max(np.abs(a.astype(np.float64) - b) / scale))


@pytest.fixture(scope="module")
def data():
    tr, _ = j_make_mnist_like(jax.random.PRNGKey(0), n_train=N, n_test=10)
    return dict(j=tr, t=Dataset(torch.from_numpy(np.array(tr.x)),
                                torch.from_numpy(np.array(tr.y)), 10),
                y=np.array(tr.y))


# --- the draws --------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 10, 1625, 1626, 100_000])
@pytest.mark.parametrize("seed", [0, 7])
def test_permutation_is_bit_exact(n, seed):
    """One sort round up to n = 1,625, two from 1,626: JAX's ``_shuffle``
    with its stable sort, bit for bit."""
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
    got = jr.permutation(tkey(seed), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_permutation_on_batched_keys():
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    want = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, 2000))(
        keys))
    got = jr.permutation(torch.from_numpy(np.asarray(keys, np.int64)), 2000)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gumbel_within_an_ulp(seed):
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (64, 500)))
    got = jr.gumbel(tkey(seed), (64, 500)).numpy()
    share = float(np.mean(got == want))
    assert ulps(want, got) <= 2.0
    assert share >= 0.70, share    # 0.77 measured


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("seed", [0, 1])
def test_loggamma_and_gamma(alpha, seed):
    """Marsaglia–Tsang on every lane at once: below α = 1 the boost branch
    (log1p(−u)·(1/α)), from α = 1 none.  Each lane's rejection chain is
    JAX's (no draw lands on another chain), so the samples agree to float
    rounding."""
    a = jnp.full((10,), alpha)
    want = np.asarray(jax.random.loggamma(jax.random.PRNGKey(seed), a,
                                          (20, 10)))
    got = jr.loggamma(tkey(seed), torch.full((10,), alpha), (20, 10)).numpy()
    assert ulps(want, got) <= 8.0
    share = float(np.mean(got == want))
    assert share >= 0.70, share    # 0.74-1.0 measured
    if alpha < 1.0:
        assert (want < np.log(alpha + 1.0)).mean() > 0.5   # boosted down
    g_want = np.asarray(jax.random.gamma(jax.random.PRNGKey(seed), a,
                                         (20, 10)))
    g_got = jr.gamma(tkey(seed), torch.full((10,), alpha), (20, 10)).numpy()
    np.testing.assert_allclose(g_got, g_want, rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("seed", [0, 3])
def test_dirichlet(alpha, seed):
    want = np.asarray(jax.random.dirichlet(jax.random.PRNGKey(seed),
                                           jnp.full((10,), alpha), (20,)))
    got = jr.dirichlet(tkey(seed), torch.full((10,), alpha), (20,)).numpy()
    assert got.shape == (20, 10) and got.dtype == np.float32
    # probabilities: within 4 ulps of 1.0 everywhere
    assert np.max(np.abs(got.astype(np.float64) - want)) <= 4 * 2.0 ** -23
    share = float(np.mean(got == want))
    assert share >= 0.35, share    # 0.39-0.92 measured
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


# --- the assignments ---------------------------------------------------------


@pytest.mark.parametrize("K,d", [(10, 5), (20, 2), (100, 3), (30, 1)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shard_assignment_is_bit_exact(data, K, d, seed):
    want = np.asarray(jdev.shard_assignment(
        jax.random.PRNGKey(seed), jnp.asarray(data["y"]), K, d, 10))
    got = shard_assignment(tkey(seed), data["t"].y, K, d, 10)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("K,alpha", [(10, 0.3), (100, 0.3), (20, 0.05),
                                     (20, 1.0), (20, 100.0)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dirichlet_assignment_equals_jax(data, K, alpha, seed):
    """Equal on every case here: no near-tie of ``argmax(logits +
    gumbel)`` flipped (ROADMAP Queue 3 would name the seed)."""
    want = np.asarray(jdev.dirichlet_assignment(
        jax.random.PRNGKey(seed), jnp.asarray(data["y"]), K, alpha, 10))
    got = dirichlet_assignment(tkey(seed), data["t"].y, K, alpha, 10)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def held_store(got: DeviceDataStore, want):
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))


@pytest.mark.parametrize("cap", [None, 120])
def test_shard_store_is_bit_exact(data, cap):
    want = jdev.shard_store(jax.random.PRNGKey(4), data["j"], 10, 2, cap=cap)
    got = shard_store(tkey(4), data["t"], 10, 2, cap=cap)
    held_store(got, want)


@pytest.mark.parametrize("cap", [None, 64])
def test_dirichlet_store_equals_jax(data, cap):
    want = jdev.dirichlet_store(jax.random.PRNGKey(5), data["j"], 12, 0.5,
                                cap=cap)
    got = dirichlet_store(tkey(5), data["t"], 12, 0.5, cap=cap)
    held_store(got, want)


def test_assignment_to_store_truncates_and_pads(data):
    assign = np.arange(N, dtype=np.int32) % 7
    want = jdev.assignment_to_store(data["j"].x, data["j"].y,
                                    jnp.asarray(assign), 8, 300)
    got = assignment_to_store(data["t"].x, data["t"].y,
                              torch.from_numpy(assign), 8, 300)
    held_store(got, want)
    assert int(got.lengths[7]) == 0 and int(got.lengths[0]) == 300


# --- errors ------------------------------------------------------------------


def test_shard_assignment_refuses_indivisible_shards(data):
    for fn, key, y in ((jdev.shard_assignment, jax.random.PRNGKey(0),
                        jnp.asarray(data["y"])),
                       (shard_assignment, tkey(0), data["t"].y)):
        with pytest.raises(ValueError, match="divisible by C=10"):
            fn(key, y, 7, 3, 10)


@pytest.mark.parametrize("case", ["more clients than examples",
                                  "an empty client"])
def test_default_cap_errors(case):
    if case == "more clients than examples":
        assign, K, match = np.zeros(5, np.int32), 6, "degenerate"
    else:
        assign, K, match = np.array([0, 0, 2, 2, 1, 0], np.int32), 4, \
            "client 3 with no examples"
    with pytest.raises(ValueError, match=match):
        jdev._default_cap(jnp.asarray(assign), K)
    with pytest.raises(ValueError, match=match):
        _default_cap(torch.from_numpy(assign), K)


def test_default_cap_is_the_largest_client():
    assign = np.array([0, 1, 1, 2, 1, 0], np.int32)
    assert _default_cap(torch.from_numpy(assign), 3) == \
        jdev._default_cap(jnp.asarray(assign), 3) == 3


def test_dirichlet_store_refuses_more_clients_than_examples(data):
    small = Dataset(data["t"].x[:20], data["t"].y[:20], 10)
    with pytest.raises(ValueError, match="degenerate"):
        dirichlet_store(tkey(0), small, 50, 0.3)


# --- histograms and heterogeneity --------------------------------------------


def test_label_histogram_honours_lengths(data):
    want = jdev.dirichlet_store(jax.random.PRNGKey(6), data["j"], 8, 0.2)
    got = dirichlet_store(tkey(6), data["t"], 8, 0.2)
    h = label_histogram(got, 10)
    assert h.dtype == torch.int32
    np.testing.assert_array_equal(h.numpy(),
                                  np.asarray(jdev.label_histogram(want, 10)))
    np.testing.assert_array_equal(h.sum(1).numpy(), got.lengths.numpy())


@pytest.mark.parametrize("d", [1, 5])
def test_heterogeneity_matches(data, d):
    clients = j_shard_noniid(jax.random.PRNGKey(2), data["j"], 10, d)
    mine = [Dataset(torch.from_numpy(np.array(c.x)),
                    torch.from_numpy(np.array(c.y)), 10) for c in clients]
    assert heterogeneity(mine) == pytest.approx(j_heterogeneity(clients),
                                                rel=1e-12)
    iid = [JDataset(data["j"].x[i::10], data["j"].y[i::10], 10)
           for i in range(10)]
    assert j_heterogeneity(iid) < heterogeneity(mine)
