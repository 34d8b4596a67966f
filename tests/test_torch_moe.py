"""The MoE FFN in the port against the JAX package on the CPU, in float32:
``init_moe`` from a seed, ``capacity`` and ``moe_forward`` (output and aux
loss) on reduced Jamba and reduced Qwen3-MoE, with one group and several,
a ragged token count, and capacities that drop tokens.

Tolerances: weights within 3 ulp (the port's normals follow XLA's erfinv);
outputs rtol 1e-4, atol 1e-5 (tests/golden/harness.py), aux rtol 1e-6: the
same slots are filled (the random gates have no ties, so ``torch.topk``
and ``lax.top_k`` rank alike), and the expert products are summed in other
orders by XLA's and PyTorch's CPU matrix products.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as JMoE
from repro_torch import configs
from repro_torch import random as jr
from repro_torch.convert import load_jax_tree
from repro_torch.models import moe as MoE

TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["jamba-1.5-large-398b", "qwen3-moe-30b-a3b"]


def cfgs(name, **moe):
    jcfg = jconfigs.get(name).reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             **moe))
    fields = dataclasses.asdict(jcfg)
    fields["moe"] = configs.MoEConfig(**fields["moe"])
    return jcfg, configs.ArchConfig(**fields)


def converted(jcfg, cfg, seed):
    params = JMoE.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    p = MoE.MoE(cfg, torch.float32, "cpu")
    load_jax_tree(p, jax.tree_util.tree_map(np.asarray, params))
    return params, p


@pytest.mark.parametrize("name", ARCHS)
def test_init_moe_matches_jax(name):
    jcfg, cfg = cfgs(name)
    want = JMoE.init_moe(jax.random.PRNGKey(5), jcfg, jnp.float32)
    p = MoE.MoE(cfg, torch.float32, "cpu")
    MoE.init_moe(p, jr.PRNGKey(5))
    for key, w in want.items():
        got = getattr(p, key).numpy()
        assert got.shape == w.shape, key
        np.testing.assert_array_max_ulp(got, np.asarray(w), maxulp=3)


@pytest.mark.parametrize("tokens", [1, 4, 24, 100, 1024, 3000])
@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
def test_capacity_matches_jax(tokens, cf):
    jcfg, cfg = cfgs("qwen3-moe-30b-a3b", capacity_factor=cf)
    assert MoE.capacity(tokens, cfg.moe) == JMoE.capacity(tokens, jcfg.moe)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("B,S,cf", [
    (2, 24, 1.25),      # one group, nothing dropped at this size
    (4, 300, 0.5),      # one ragged group (1200 tokens), drops
    (2, 1024, 1.25),    # two groups of 1024
    (1, 2048, 0.25),    # two groups, many drops
])
def test_forward_and_aux_match_jax(name, B, S, cf):
    jcfg, cfg = cfgs(name, capacity_factor=cf)
    params, p = converted(jcfg, cfg, seed=S)
    x = np.random.default_rng(S).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    want, waux = JMoE.moe_forward(params, jcfg, jnp.asarray(x))
    with torch.inference_mode():
        got, aux = MoE.moe_forward(p, cfg, torch.from_numpy(x))
    assert got.shape == x.shape and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    dropped = int((got.abs().sum(-1) == 0).sum())
    assert dropped == int((np.abs(np.asarray(want)).sum(-1) == 0).sum())
    if cf < 1:
        assert dropped > 0     # the case drops every choice of some tokens


def test_decode_sized_batches_match_jax():
    """One token per sequence (decode): T = B, capacity's floor of 4."""
    jcfg, cfg = cfgs("jamba-1.5-large-398b")
    params, p = converted(jcfg, cfg, seed=9)
    x = np.random.default_rng(9).standard_normal(
        (3, 1, jcfg.d_model)).astype(np.float32)
    want, waux = JMoE.moe_forward(params, jcfg, jnp.asarray(x))
    with torch.inference_mode():
        got, aux = MoE.moe_forward(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("B,S,cf", [(2, 24, 1.25), (4, 300, 0.5),
                                    (1, 2048, 0.25)])
def test_expert_parallel_formulation_matches_scatter_and_jax(
        name, B, S, cf, monkeypatch):
    """The formulation the MoE takes on DTensors (``_expert_parallel``:
    JAX's one-hot dispatch and combine contractions) on plain tensors,
    where the sharding hints are the tensor itself: it equals the card's
    scatter/gather formulation and JAX's ``moe_forward`` (output within
    rtol 1e-4, the same tokens dropped, aux rtol 1e-6)."""
    jcfg, cfg = cfgs(name, capacity_factor=cf)
    params, p = converted(jcfg, cfg, seed=S)
    x = np.random.default_rng(S).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    want, waux = JMoE.moe_forward(params, jcfg, jnp.asarray(x))
    calls = []
    for name_, fn in (("_scatter_gather", MoE._scatter_gather),
                      ("_expert_parallel", MoE._expert_parallel)):
        monkeypatch.setattr(MoE, name_, lambda *a, fn=fn, n=name_: (
            calls.append(n), fn(*a))[1])
    with torch.inference_mode():
        scatter, aux_s = MoE.moe_forward(p, cfg, torch.from_numpy(x))
        monkeypatch.setattr(MoE, "is_dtensor", lambda t: True)
        onehot, aux_o = MoE.moe_forward(p, cfg, torch.from_numpy(x))
    assert calls == ["_scatter_gather", "_expert_parallel"]
    for got, aux in ((onehot, aux_o), (scatter, aux_s)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    np.testing.assert_allclose(onehot.numpy(), scatter.numpy(), **TOL)
    zero = [(t.abs().sum(-1) == 0).numpy() for t in (onehot, scatter)]
    np.testing.assert_array_equal(zero[0], zero[1])
    np.testing.assert_array_equal(zero[0],
                                  np.abs(np.asarray(want)).sum(-1) == 0)
