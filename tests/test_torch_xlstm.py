"""The port's xLSTM mixers (``repro_torch.models.xlstm``) and the LLM's
token stream against the JAX package on the CPU, in float32.

* ``make_token_stream``: tokens bit for bit (integer draws only).
* ``init_mlstm`` / ``init_slstm`` and a whole reduced xLSTM-125M: JAX's key
  order (7 and 10 keys; ``out`` from key 8), dtypes (float32 gates and
  sLSTM weights in a bf16 model) and values within 3 ulp (the port's
  normals follow XLA's erfinv to a few ulps, tests/test_torch_random.py);
  in bf16 the values after the same cast.
* mLSTM and sLSTM forward, prefill → decode and the decoder stack's
  forward, prefill and decode against JAX at rtol 1e-4, atol 1e-5
  (tests/golden/harness.py; the frameworks sum their matrix products in
  other orders).
* Inside the port, JAX's tests/test_models.py:201 (decode ≡ parallel) and
  :290 (chunked ≡ single block, and ≡ the step recurrence) at JAX's own
  tolerances, each also held against JAX's function on the same inputs.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import make_token_stream as j_make_token_stream
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro_torch import configs
from repro_torch import random as jr
from repro_torch.convert import (load_jax_tree, transformer_from_jax,
                                 transformer_to_numpy)
from repro_torch.data import make_token_stream
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X

TOL = dict(rtol=1e-4, atol=1e-5)


def jtiny(**kw):
    """JAX's tests/test_models.py ``tiny("xlstm-125m", ...)``."""
    return jconfigs.get("xlstm-125m").reduced(**kw)


def port_cfg(jcfg):
    return configs.ArchConfig(**dataclasses.asdict(jcfg))


def inputs(B, S, d, seed, scale):
    return (np.random.default_rng(seed).standard_normal((B, S, d))
            * scale).astype(np.float32)


@pytest.mark.parametrize("seed,n,S,V", [(0, 32, 64, 512), (5, 7, 9, 50304),
                                        (2, 3, 2, 60)])
def test_make_token_stream_bit_for_bit(seed, n, S, V):
    want = j_make_token_stream(jax.random.PRNGKey(seed), n_seqs=n,
                               seq_len=S, vocab=V)
    got = make_token_stream(jr.PRNGKey(seed), n_seqs=n, seq_len=S, vocab=V,
                            device="cpu")
    assert got.x.dtype == torch.int32 and got.num_classes == V
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_of_xlstm_match_jax(dtype):
    """Both mixers' leaves through the decoder stack's init, in JAX's key
    order and dtypes: every leaf within 3 ulp in float32; in bf16 the
    float32 leaves within 3 ulp and the bf16 ones within one bf16 ulp
    (a normal a few float32 ulps off can round to the neighbour)."""
    jcfg = dataclasses.replace(jtiny(layers=4), dtype=dtype)
    want = dict(leaves(jax.tree_util.tree_map(
        np.asarray, JT.init_params(jax.random.PRNGKey(3), jcfg))))
    model = T.init_params(jr.PRNGKey(3), port_cfg(jcfg), device="cpu")
    got = dict(leaves(transformer_to_numpy(model)))
    assert got.keys() == want.keys()
    assert {k.split(".")[-1] for k in got if ".mixer." in k} == {
        "wq", "wk", "wv", "wi", "wf", "wog", "out", "wz", "wo", "rz", "ri",
        "rf", "ro", "bz", "bi", "bf", "bo"}
    params = dict(model.named_parameters())
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        port_name = name
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            port_name = f"layers.{i}.{rest}"      # repeat 0 of position i
        if w.dtype == np.float32:
            assert params[port_name].dtype == torch.float32, name
            np.testing.assert_array_max_ulp(got[name], w, maxulp=3)
        else:
            assert params[port_name].dtype == torch.bfloat16, name
            w32 = w.astype(np.float32)
            ulp = np.abs(w32) * 2.0 ** -7 + 1e-38
            assert np.all(np.abs(got[name] - w32) <= ulp), name


def mixer(kind, jcfg, seed):
    """JAX's params of one mixer and the port's module loaded from them."""
    init = {"mlstm": JX.init_mlstm, "slstm": JX.init_slstm}[kind]
    jp = init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    cls = {"mlstm": X.MLSTM, "slstm": X.SLSTM}[kind]
    p = cls(port_cfg(jcfg), torch.float32, device="cpu")
    load_jax_tree(p, jax.tree_util.tree_map(np.asarray, jp))
    return jp, p


FORWARD = {"mlstm": (JX.mlstm_forward, X.mlstm_forward),
           "slstm": (JX.slstm_forward, X.slstm_forward)}
DECODE = {"mlstm": (JX.mlstm_decode, X.mlstm_decode),
          "slstm": (JX.slstm_decode, X.slstm_decode)}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_forward_prefill_decode_match_jax(kind):
    """S 24 (one chunk), then prefill 16 and 8 decode steps, carrying each
    package's own cache; the caches' every field is held too."""
    jcfg = jtiny(d_model=64, n_heads=2)
    cfg = port_cfg(jcfg)
    jp, p = mixer(kind, jcfg, seed=4)
    x = inputs(2, 24, 64, seed=1, scale=0.5)
    jf, pf = FORWARD[kind]
    jd, pd = DECODE[kind]
    with torch.inference_mode():
        want = jf(jp, jcfg, jnp.asarray(x))
        got = pf(p, cfg, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        wy, wc = jf(jp, jcfg, jnp.asarray(x[:, :16]), return_cache=True)
        gy, gc = pf(p, cfg, torch.from_numpy(x[:, :16]), return_cache=True)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)
        for i in range(16, 24):
            wy, wc = jd(jp, jcfg, jnp.asarray(x[:, i:i + 1]), wc)
            gy, gc = pd(p, cfg, torch.from_numpy(x[:, i:i + 1]), gc)
            np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)
        for field in wc._fields:
            np.testing.assert_allclose(getattr(gc, field).numpy(),
                                       np.asarray(getattr(wc, field)),
                                       err_msg=field, **TOL)


def test_xlstm_decode_matches_parallel():
    """JAX's tests/test_models.py:201 inside the port: prefill 7 tokens,
    decode the 8th, against the parallel forward's 8th output (mLSTM at
    JAX's atol 2e-3, rtol 2e-2; sLSTM at 1e-4), and the port's decode
    against JAX's on the same inputs."""
    jcfg = jtiny(d_model=64, n_heads=2)
    cfg = port_cfg(jcfg)
    x = inputs(1, 8, 64, seed=10, scale=0.3)
    tols = {"mlstm": dict(atol=2e-3, rtol=2e-2),
            "slstm": dict(atol=1e-4, rtol=1e-4)}
    with torch.inference_mode():
        for kind in ("mlstm", "slstm"):
            jp, p = mixer(kind, jcfg, seed=10)
            pf, pd = FORWARD[kind][1], DECODE[kind][1]
            y_par, _ = pf(p, cfg, torch.from_numpy(x), return_cache=True)
            _, cache = pf(p, cfg, torch.from_numpy(x[:, :7]),
                          return_cache=True)
            y_dec, _ = pd(p, cfg, torch.from_numpy(x[:, 7:8]), cache)
            np.testing.assert_allclose(y_dec[:, 0].numpy(),
                                       y_par[:, 7].numpy(), **tols[kind])
            _, jcache = FORWARD[kind][0](jp, jcfg, jnp.asarray(x[:, :7]),
                                         return_cache=True)
            want, _ = DECODE[kind][0](jp, jcfg, jnp.asarray(x[:, 7:8]),
                                      jcache)
            np.testing.assert_allclose(y_dec.numpy(), np.asarray(want),
                                       **TOL)


def test_chunked_mlstm_matches_single_block():
    """JAX's tests/test_models.py:290 inside the port: S 64 in 4 chunks of
    16 against one block (atol 1e-4, rtol 1e-3) and against the step
    recurrence token by token (atol 1e-3, rtol 1e-2); the chunked forward
    against JAX's chunked forward, and a chunk that does not divide S
    falling back to one block as in JAX."""
    jcfg = jtiny(d_model=64, n_heads=2)
    cfg = port_cfg(jcfg)
    jp, p = mixer("mlstm", jcfg, seed=25)
    x = inputs(2, 64, 64, seed=25, scale=0.4)
    t = torch.from_numpy(x)
    with torch.inference_mode():
        y_full = X.mlstm_forward(p, cfg, t, chunk=64)
        y_chunk = X.mlstm_forward(p, cfg, t, chunk=16)
        np.testing.assert_allclose(y_chunk.numpy(), y_full.numpy(),
                                   atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(
            y_chunk.numpy(),
            np.asarray(JX.mlstm_forward(jp, jcfg, jnp.asarray(x), chunk=16)),
            **TOL)
        assert torch.equal(X.mlstm_forward(p, cfg, t, chunk=24), y_full)
        cache = X.init_mlstm_cache(cfg, 2, torch.float32, device="cpu")
        outs = []
        for i in range(64):
            y_t, cache = X.mlstm_decode(p, cfg, t[:, i:i + 1], cache)
            outs.append(y_t)
        np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                                   y_full.numpy(), atol=1e-3, rtol=1e-2)


def test_xlstm_stack_forward_prefill_decode_match_jax():
    """Reduced xLSTM-125M (an mLSTM and an sLSTM layer, d 256, no FFN)
    through the decoder stack: forward at S 40, prefill 30, 10 decode
    steps."""
    jcfg = jtiny()
    params = JT.init_params(jax.random.PRNGKey(0), jcfg)
    model = transformer_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 port_cfg(jcfg), device="cpu")
    assert [b.mixer_kind for b in model.layers] == ["mlstm", "slstm"]
    assert all(b.ffn_kind == "none" for b in model.layers)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 40),
                                             dtype=np.int32)
    t = torch.from_numpy(toks)
    with torch.inference_mode():
        want, _ = JT.forward(params, jcfg, tokens=jnp.asarray(toks))
        got, aux = T.forward(model, tokens=t)
        assert float(aux) == 0.0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        wl, wc = JT.prefill(params, jcfg, tokens=jnp.asarray(toks[:, :30]),
                            capacity=40)
        gl, gc = T.prefill(model, tokens=t[:, :30], capacity=40)
        assert [type(c) for c in gc] == [X.MLSTMCache, X.SLSTMCache]
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
        for i in range(30, 40):
            wl, wc = JT.decode_step(params, jcfg,
                                    jnp.asarray(toks[:, i:i + 1]), wc)
            gl, gc = T.decode_step(model, t[:, i:i + 1], gc)
            np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
