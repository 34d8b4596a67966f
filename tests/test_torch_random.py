"""The port's threefry2x32 (repro_torch.random) against jax.random: keys,
bits, uniforms, randint and exponentials bit for bit, normals to a few ulps;
a run's table of round keys against ``fold_in`` of each round, and
uniform's scalar bounds against 0-dim float32 tensor bounds, bit for bit.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as jr

SEEDS = [0, 1, 42, 12345, 2**32 - 1]
# incl. the masks' (K,) and the minibatch indices' (K, L, B)
SHAPES = [(), (10,), (10, 5, 10), (7, 3)]


def _jax(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS + [2**32 + 5, -5])
def test_prng_key(seed):
    np.testing.assert_array_equal(jr.PRNGKey(seed).numpy(),
                                  _jax(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 7, 0x0DA7A, 2**31, 2**32 - 1])
def test_fold_in(seed, data):
    want = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    np.testing.assert_array_equal(jr.fold_in(jr.PRNGKey(seed), data).numpy(),
                                  _jax(want))
    got_t = jr.fold_in(jr.PRNGKey(seed), torch.tensor(data, dtype=torch.int64))
    np.testing.assert_array_equal(got_t.numpy(), _jax(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 5, (3, 4)])
def test_split(seed, num):
    np.testing.assert_array_equal(
        jr.split(jr.PRNGKey(seed), num).numpy(),
        _jax(jax.random.split(jax.random.PRNGKey(seed), num)))


def test_split_is_fold_like():
    key = jr.PRNGKey(3)
    keys = jr.split(key, 4)
    for i in range(4):
        np.testing.assert_array_equal(keys[i].numpy(),
                                      jr.fold_in(key, i).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits(seed, shape):
    want = jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32)
    np.testing.assert_array_equal(
        jr.random_bits(jr.PRNGKey(seed), shape).numpy(), _jax(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_bit_exact(seed, shape):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    got = jr.uniform(jr.PRNGKey(seed), shape).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_uniform_participation_and_minibatch_streams():
    """The engine's two draws: masks from fold_in(base_key, t) over (K,),
    minibatch indices from fold_in(fold_in(key, 0x0DA7A), t) over (K, L, B)."""
    base, data = jax.random.PRNGKey(7), jax.random.fold_in(
        jax.random.PRNGKey(7), 0x0DA7A)
    tbase, tdata = jr.PRNGKey(7), jr.fold_in(jr.PRNGKey(7), 0x0DA7A)
    for t in range(5):
        for jk, tk, shape in ((base, tbase, (10,)),
                              (data, tdata, (10, 5, 10))):
            want = np.asarray(jax.random.uniform(jax.random.fold_in(jk, t),
                                                 shape))
            got = jr.uniform(jr.fold_in(tk, t), shape).numpy()
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (2.0, 5.0)])
def test_uniform_range_bit_exact(lo, hi):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (100,),
                                         minval=lo, maxval=hi))
    got = jr.uniform(jr.PRNGKey(4), (100,), minval=lo, maxval=hi).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0, 10), (0, 2**31 - 1), (-5, 3), (3, 3),
                                   (-2**31, 2**31 - 1)])
def test_randint_bit_exact(seed, lo, hi):
    for shape in [(), (50,)]:
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                             lo, hi))
        got = jr.randint(jr.PRNGKey(seed), shape, lo, hi).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_exponential_matches(seed):
    want = np.asarray(jax.random.exponential(jax.random.PRNGKey(seed), (500,)))
    got = jr.exponential(jr.PRNGKey(seed), (500,)).numpy()
    np.testing.assert_allclose(got, want, rtol=4 * 2.0**-23, atol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_few_ulps(seed):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (4000,)))
    got = jr.normal(jr.PRNGKey(seed), (4000,)).numpy()
    assert got.dtype == np.float32
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= 4, ulps.max()
    assert np.mean(got == want) > 0.9


def test_erfinv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999], dtype=torch.float32)
    got = jr.erfinv(x).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    assert np.isneginf(got[0]) and np.isposinf(got[1]) and got[2] == 0.0
    np.testing.assert_allclose(got[2:], want[2:], rtol=4 * 2.0**-23)


def test_sampling_follows_the_key_or_the_device_argument():
    key = jr.PRNGKey(0)
    assert jr.uniform(key, (3,)).device == key.device
    assert jr.uniform(key, (3,), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("seed", [0, 42, 2**32 - 1])
def test_batched_fold_in_matches_vmap(seed):
    """A vector of data gives ``[n, 2]`` keys, a batch of keys folded with
    data of the same shape gives one key each: ``jax.vmap`` of fold_in."""
    data = np.array([0, 1, 7, 0x0DA7A, 2**31, 2**32 - 1], np.uint32)
    key = jax.random.PRNGKey(seed)
    want = jax.vmap(lambda d: jax.random.fold_in(key, d))(data)
    got = jr.fold_in(jr.PRNGKey(seed), torch.from_numpy(data.astype(np.int64)))
    assert got.shape == (6, 2)
    np.testing.assert_array_equal(got.numpy(), _jax(want))
    # the per-client stream's two levels: rounds [T, 1], then ids [T, P]
    ts, ids = np.arange(3)[:, None], np.array([[0, 5, 9], [2, 3, 9],
                                               [1, 1, 4]], np.uint32)
    want = jax.vmap(jax.vmap(lambda t, k: jax.random.fold_in(
        jax.random.fold_in(key, t), k)))(np.broadcast_to(ts, ids.shape), ids)
    got = jr.fold_in(jr.fold_in(jr.PRNGKey(seed), torch.from_numpy(ts)),
                     torch.from_numpy(ids.astype(np.int64)))
    assert got.shape == (3, 3, 2)
    np.testing.assert_array_equal(got.numpy(), _jax(want))


@pytest.mark.parametrize("shape", [(), (10,), (5, 10)])
def test_batched_uniform_and_bits_match_vmap(shape):
    """Keys ``[..., 2]`` draw ``[..., *shape]``: row i is the draw of key i,
    as ``jax.vmap`` of uniform / bits over the keys."""
    keys = jax.random.split(jax.random.PRNGKey(3), 12).reshape(3, 4, 2)
    tkeys = torch.from_numpy(_jax(keys))
    flat = keys.reshape(12, 2)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(
        flat)).reshape((3, 4) + shape)
    got = jr.uniform(tkeys, shape).numpy()
    assert got.shape == (3, 4) + shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    want = jax.vmap(lambda k: jax.random.bits(k, shape, jnp.uint32))(flat)
    np.testing.assert_array_equal(jr.random_bits(tkeys, shape).numpy(),
                                  _jax(want).reshape((3, 4) + shape))


# ---------------------------------------------------------------------------
# a run's round keys and uniform's bounds, made with no tensor of a number
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("ts", [range(20), range(2**32 - 3, 2**32),
                                range(7, 40, 4)])
def test_fold_in_range_is_fold_in_of_each_round(seed, ts):
    """The ``[T, 2]`` table of a run's round keys: row i is ``fold_in(key,
    ts[i])`` with the round a number, up to 2³² − 1; batched keys give
    ``[..., T, 2]``."""
    key = jr.PRNGKey(seed)
    table = jr.fold_in_range(key, ts)
    assert table.shape == (len(ts), 2) and table.dtype == torch.int64
    for i, t in enumerate(ts):
        assert torch.equal(table[i], jr.fold_in(key, t)), t
    keys = jr.split(key, (2, 3))
    table = jr.fold_in_range(keys, ts)
    assert table.shape == (2, 3, len(ts), 2)
    for i, t in enumerate(ts):
        assert torch.equal(table[:, :, i], jr.fold_in(keys, t)), t
    want = jax.vmap(lambda t: jax.random.fold_in(
        jax.random.PRNGKey(seed), t))(np.asarray(ts, np.uint32))
    np.testing.assert_array_equal(jr.fold_in_range(key, ts).numpy(),
                                  _jax(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_tensor_datum_is_the_number_path(seed):
    """A datum as a 0-dim tensor (int64, int32) or a vector gives the
    number's key, mod 2³² as the number path takes it."""
    key = jr.PRNGKey(seed)
    data = [0, 1, 7, 0x0DA7A, 2**31 - 1, 2**31, 2**32 - 1, 2**32 + 5, -1]
    for d in data:
        want = jr.fold_in(key, d)
        assert torch.equal(jr.fold_in(key, torch.tensor(d)), want), d
        if -2**31 <= d < 2**31:
            assert torch.equal(
                jr.fold_in(key, torch.tensor(d, dtype=torch.int32)), want), d
    batched = jr.fold_in(key, torch.tensor(data))
    for i, d in enumerate(data):
        assert torch.equal(batched[i], jr.fold_in(key, d)), d


def _uniform_tensor_bounds(key, shape, lo, hi):
    """uniform with its bounds made 0-dim float32 tensors, ``hi − lo``
    taken between them."""
    bits = jr.random_bits(key, shape)
    floats = jr._as_f32((bits >> 9) | jr._ONE_BITS) - 1.0
    lo_t = torch.tensor(lo, dtype=torch.float32)
    hi_t = torch.tensor(hi, dtype=torch.float32)
    return torch.maximum(lo_t, floats * (hi_t - lo_t) + lo_t)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [
    (0.0, 1.0), (-1.0, 1.0), (1e-6, 3.5),
    # normal's and gumbel's: hi − lo rounds in float32
    (float(np.nextafter(np.float32(-1.0), np.float32(0.0))), 1.0),
    (float(np.finfo(np.float32).tiny), 1.0)])
def test_uniform_scalar_bounds_are_the_tensor_bounds(seed, lo, hi):
    """Bit for bit the draw with tensor bounds (the JAX comparison is
    ``test_uniform_range_bit_exact``'s)."""
    key = jr.PRNGKey(seed)
    got = jr.uniform(key, (4096,), minval=lo, maxval=hi).numpy()
    want = _uniform_tensor_bounds(key, (4096,), lo, hi).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
