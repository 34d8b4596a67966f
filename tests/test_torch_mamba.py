"""The Mamba mixer in the port against the JAX package on the CPU, in float32,
on reduced Jamba: ``init_mamba`` from a seed, ``mamba_forward``, the
prefill's cache (conv tail and ssm state) and ``mamba_decode``.

S = 24 runs JAX's scan as one block; S = 256 as two chunks of 128, so
JAX's chunk carry is held against the port's single sequential scan.

Tolerances: weights within 3 ulp (the port's normals follow XLA's erfinv to
a few ulps), except ``dt_bias = dt + log1p(−exp(−dt))`` at rtol 2e-5: for
dt in [1e-3, 0.1], ``1 − exp(−dt)`` cancels, so an ulp between XLA's and
PyTorch's ``exp`` becomes up to ~1e-5 relative.  Activations and states
rtol 1e-4, atol 1e-5 (tests/golden/harness.py): float32 on both sides, the
matrix products and the scan summed in other orders.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mamba as JM
from repro_torch import configs
from repro_torch import random as jr
from repro_torch.convert import load_jax_tree
from repro_torch.models import mamba as M

TOL = dict(rtol=1e-4, atol=1e-5)
JCFG = jconfigs.get("jamba-1.5-large-398b").reduced()


def port_cfg(jcfg):
    fields = dataclasses.asdict(jcfg)
    fields["moe"] = configs.MoEConfig(**fields["moe"])
    return configs.ArchConfig(**fields)


CFG = port_cfg(JCFG)


def converted(seed=0):
    params = JM.init_mamba(jax.random.PRNGKey(seed), JCFG, jnp.float32)
    p = M.Mamba(CFG, torch.float32, "cpu")
    load_jax_tree(p, jax.tree_util.tree_map(np.asarray, params))
    return params, p


def activations(B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, JCFG.d_model)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 7])
def test_init_mamba_matches_jax(seed):
    want = JM.init_mamba(jax.random.PRNGKey(seed), JCFG, jnp.float32)
    p = M.Mamba(CFG, torch.float32, "cpu")
    M.init_mamba(p, jr.PRNGKey(seed))
    for name, w in want.items():
        got = getattr(p, name).numpy()
        w = np.asarray(w)
        assert got.shape == w.shape and got.dtype == w.dtype, name
        if name == "dt_bias":
            np.testing.assert_allclose(got, w, rtol=2e-5, atol=0)
        else:
            np.testing.assert_array_max_ulp(got, w, maxulp=3)


def test_init_mamba_dtypes_follow_jax():
    jcfg = dataclasses.replace(JCFG, dtype="bfloat16")
    want = JM.init_mamba(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    p = M.Mamba(port_cfg(jcfg), torch.bfloat16, "cpu")
    M.init_mamba(p, jr.PRNGKey(0))
    for name, w in want.items():
        assert str(getattr(p, name).dtype).split(".")[1] == str(w.dtype), name


@pytest.mark.parametrize("S", [24, 256])
def test_forward_and_prefill_cache_match_jax(S):
    params, p = converted(seed=S)
    x = activations(2, S, seed=S)
    want, cache = JM.mamba_forward(params, JCFG, jnp.asarray(x),
                                   return_cache=True)
    with torch.inference_mode():
        got, gcache = M.mamba_forward(p, CFG, torch.from_numpy(x),
                                      return_cache=True)
        plain = M.mamba_forward(p, CFG, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(plain, got)
    assert gcache.conv.shape == (2, 3, 512) and gcache.ssm.shape == (2, 512,
                                                                    16)
    np.testing.assert_allclose(gcache.conv.numpy(), np.asarray(cache.conv),
                               **TOL)
    np.testing.assert_allclose(gcache.ssm.numpy(), np.asarray(cache.ssm),
                               **TOL)


@pytest.mark.parametrize("S", [24, 256])
def test_decode_matches_jax(S):
    params, p = converted(seed=1)
    x = activations(2, S, seed=S + 1)
    P = S - 6
    _, wc = JM.mamba_forward(params, JCFG, jnp.asarray(x[:, :P]),
                             return_cache=True)
    with torch.inference_mode():
        _, gc = M.mamba_forward(p, CFG, torch.from_numpy(x[:, :P]),
                                return_cache=True)
        for i in range(P, S):
            want, wc = JM.mamba_decode(params, JCFG,
                                       jnp.asarray(x[:, i:i + 1]), wc)
            got, gc = M.mamba_decode(p, CFG, torch.from_numpy(x[:, i:i + 1]),
                                     gc)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gc.ssm.numpy(), np.asarray(wc.ssm), **TOL)
    np.testing.assert_allclose(gc.conv.numpy(), np.asarray(wc.conv), **TOL)


def test_decode_from_an_empty_cache_matches_jax():
    params, p = converted(seed=2)
    x = activations(3, 5, seed=2)
    wc = JM.init_mamba_cache(JCFG, 3, jnp.float32)
    gc = M.init_mamba_cache(CFG, 3, torch.float32, "cpu")
    with torch.inference_mode():
        for i in range(5):
            want, wc = JM.mamba_decode(params, JCFG,
                                       jnp.asarray(x[:, i:i + 1]), wc)
            got, gc = M.mamba_decode(p, CFG, torch.from_numpy(x[:, i:i + 1]),
                                     gc)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [1, 2, 3, 9])
def test_conv_tail_matches_jax(S):
    """The tail is the last k − 1 padded inputs: zero rows when S < k − 1."""
    params, p = converted(seed=3)
    x = activations(2, S, seed=S) @ np.asarray(params["in_proj"])[:, :512]
    want, wtail = JM._conv(params, jnp.asarray(x), JCFG)
    got, gtail = M._conv(p, torch.from_numpy(x), CFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(gtail.numpy(), np.asarray(wtail))
    if S < JCFG.ssm_conv - 1:
        assert not gtail[:, :JCFG.ssm_conv - 1 - S].any()


def test_softplus_is_jax_logaddexp():
    x = np.linspace(-40, 40, 2001, dtype=np.float32)
    np.testing.assert_allclose(M.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-30)
