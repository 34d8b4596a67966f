"""K2 (flash_attention) and the attention mixer in the port, against the JAX
package on the CPU.

* K2's plain version (``repro_torch.kernels.ref.flash_attention_ref``, what
  ``ops.flash_attention`` runs on a CPU tensor) against JAX's oracle
  ``ref.flash_attention_ref`` and the Pallas kernel in interpret mode, over
  the sweeps, windows and block geometries of tests/test_kernels.py; plus
  ragged S and ``causal=False`` against the oracle (the Pallas kernel needs
  S % block == 0 and is always run causal there).
* ``attn_forward``, ``attn_prefill`` and ``attn_decode`` against JAX's from
  the same (converted) weights, with ``qk_norm`` on and off and with a
  window.

The CUDA kernel against its plain version is tests/test_torch_cuda_attention.py
(no JAX there, so it runs on the card's host).

Tolerances: the kernel's are tests/test_kernels.py's (fp32 2e-5, bf16 3e-2).
The mixer's, rtol 1e-4 / atol 1e-5 (tests/golden/harness.py): float32 on
both sides, but XLA's and PyTorch's CPU matrix products sum in other orders.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_pallas
from repro.models import attention as jattn
from repro_torch import configs
from repro_torch.convert import load_jax_tree
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models import attention

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
MIXER_TOL = dict(rtol=1e-4, atol=1e-5)
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

SWEEP = [(1, 128, 2, 2, 64),      # MHA
         (2, 256, 4, 2, 64),      # GQA 2:1
         (1, 256, 8, 2, 128),     # GQA 4:1, wide head
         (1, 512, 4, 1, 64)]      # MQA


def qkv(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32))


def port(arrays, dtype, **kw):
    q, k, v = (torch.from_numpy(a).to(TORCH[dtype]) for a in arrays)
    out = ops.flash_attention(q, k, v, **kw)
    assert out.dtype == TORCH[dtype] and out.shape == q.shape
    return out.float().numpy()


def jax_in(arrays, dtype):
    return [jnp.asarray(a, JAX[dtype]) for a in arrays]


@pytest.mark.parametrize("B,S,H,KV,hd", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_oracle_and_pallas(B, S, H, KV, hd, dtype):
    arrays = qkv(B, S, H, KV, hd, seed=S + H)
    got = port(arrays, dtype)
    want = jref.flash_attention_ref(*jax_in(arrays, dtype))
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **TOL[dtype])
    pallas = j_pallas(*jax_in(arrays, dtype), bq=128, bk=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("window", [32, 128])
def test_window_matches_jax_oracle_and_pallas(window):
    arrays = qkv(1, 256, 2, 2, 64, seed=7)
    got = port(arrays, "float32", window=window)
    want = jref.flash_attention_ref(*jax_in(arrays, "float32"), window=window)
    np.testing.assert_allclose(got, np.asarray(want), **TOL["float32"])
    pallas = j_pallas(*jax_in(arrays, "float32"), window=window, bq=64,
                      bk=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL["float32"])


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 64), (64, 128)])
def test_block_geometries_of_pallas_agree(bq, bk):
    arrays = qkv(1, 256, 2, 2, 64, seed=11)
    pallas = j_pallas(*jax_in(arrays, "float32"), bq=bq, bk=bk,
                      interpret=True)
    np.testing.assert_allclose(port(arrays, "float32"), np.asarray(pallas),
                               **TOL["float32"])


def test_first_token_attends_self_only():
    q, k, v = qkv(1, 128, 2, 2, 64, seed=13)
    out = port((q, k, v), "float32")
    np.testing.assert_allclose(out[0, 0], v[0, 0], atol=1e-5)
    pallas = j_pallas(*jax_in((q, k, v), "float32"), interpret=True)
    np.testing.assert_allclose(out[0, 0], np.asarray(pallas)[0, 0],
                               atol=1e-5)


@pytest.mark.parametrize("S", [1, 77, 200])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16), (False, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_and_noncausal_match_jax_oracle(S, causal, window, dtype):
    arrays = qkv(2, S, 4, 2, 64, seed=S)
    got = port(arrays, dtype, causal=causal, window=window)
    want = jref.flash_attention_ref(*jax_in(arrays, dtype), causal=causal,
                                    window=window)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **TOL[dtype])


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    calls = []
    monkeypatch.setattr(ops, "flash_attention_cuda",
                        lambda *a, **k: calls.append(a))
    before = flash_attention_cuda.launches
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 64, 4, 2, 64, seed=1))
    assert torch.equal(ops.flash_attention(q, k, v, window=8),
                       ref.flash_attention_ref(q, k, v, window=8))
    assert calls == [] and flash_attention_cuda.launches == before


def test_kernel_wrapper_refuses_cpu_and_other_devices():
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 64, 4, 2, 64, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    meta = torch.zeros(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        ops.flash_attention(meta, meta, meta)


# ---------------------------------------------------------------------------
# the attention mixer
# ---------------------------------------------------------------------------

def mixer_cfg(qk_norm, window):
    cfg = jconfigs.get("llama3.2-1b").reduced(n_heads=8, n_kv_heads=2)
    return dataclasses.replace(cfg, qk_norm=qk_norm, sliding_window=window)


def port_cfg(jcfg):
    """The port's copy of a JAX ``ArchConfig``."""
    fields = dataclasses.asdict(jcfg)
    if fields["moe"] is not None:
        fields["moe"] = configs.MoEConfig(**fields["moe"])
    return configs.ArchConfig(**fields)


def port_mixer(jp, cfg):
    p = attention.Attention(port_cfg(cfg), torch.float32, "cpu")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    if cfg.qk_norm:   # non-trivial gammas, so the norms are exercised
        rng = np.random.default_rng(5)
        tree["q_norm"] = rng.uniform(0.5, 1.5, cfg.hd).astype(np.float32)
        tree["k_norm"] = rng.uniform(0.5, 1.5, cfg.hd).astype(np.float32)
    load_jax_tree(p, tree)
    return p, tree


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("window", [None, 6])
def test_mixer_matches_jax(qk_norm, window):
    jcfg = mixer_cfg(qk_norm, window)
    jp = jattn.init_attn(jax.random.PRNGKey(3), jcfg, jnp.float32)
    p, tree = port_mixer(jp, jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    pcfg = p.cfg
    B, S, cap = 2, 12, 16
    x = np.random.default_rng(0).standard_normal(
        (B, S + 5, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos.copy())

    want = jattn.attn_forward(jp, jcfg, jnp.asarray(x[:, :S]), pos)
    got = attention.attn_forward(p, pcfg, tx[:, :S], tpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIXER_TOL)

    wy, wcache = jattn.attn_prefill(jp, jcfg, jnp.asarray(x[:, :S]), pos,
                                    cap)
    gy, gcache = attention.attn_prefill(p, pcfg, tx[:, :S], tpos, cap)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **MIXER_TOL)
    assert gcache.pos == int(wcache.pos) == S
    np.testing.assert_allclose(gcache.k.numpy(), np.asarray(wcache.k),
                               **MIXER_TOL)
    np.testing.assert_allclose(gcache.v.numpy(), np.asarray(wcache.v),
                               **MIXER_TOL)
    for i in range(5):    # runs past the capacity: the ring wraps
        xi = x[:, S + i:S + i + 1]
        wy, wcache = jattn.attn_decode(jp, jcfg, jnp.asarray(xi), wcache)
        gy, gcache = attention.attn_decode(p, pcfg, torch.from_numpy(xi),
                                           gcache)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **MIXER_TOL)
        assert gcache.pos == int(wcache.pos)
    np.testing.assert_allclose(gcache.k.numpy(), np.asarray(wcache.k),
                               **MIXER_TOL)


def test_prefill_keeps_the_last_capacity_positions_like_jax():
    """A prompt longer than the capacity keeps its last ``capacity`` keys
    at slots 0..C-1, and decode then writes slot ``pos % C`` — not the
    oldest slot; the port reproduces it (ROADMAP.md, Queue 3)."""
    jcfg = mixer_cfg(False, 4)
    jp = jattn.init_attn(jax.random.PRNGKey(4), jcfg, jnp.float32)
    p, tree = port_mixer(jp, jcfg)
    x = np.random.default_rng(1).standard_normal(
        (1, 13, jcfg.d_model)).astype(np.float32)
    pos = np.arange(10)[None]
    _, wcache = jattn.attn_prefill(jp, jcfg, jnp.asarray(x[:, :10]), pos, 4)
    _, gcache = attention.attn_prefill(p, p.cfg, torch.from_numpy(x[:, :10]),
                                       torch.from_numpy(pos), 4)
    assert gcache.k.shape[1] == 4 and gcache.pos == 10
    for i in range(3):
        xi = x[:, 10 + i:11 + i]
        wy, wcache = jattn.attn_decode(jp, jcfg, jnp.asarray(xi), wcache)
        gy, gcache = attention.attn_decode(p, p.cfg, torch.from_numpy(xi),
                                           gcache)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **MIXER_TOL)
    np.testing.assert_allclose(gcache.k.numpy(), np.asarray(wcache.k),
                               **MIXER_TOL)
