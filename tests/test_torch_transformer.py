"""The port's decoder stack against the JAX package on the CPU, in float32:
``init_params`` from a seed, ``forward``, ``prefill`` and ``decode_step``
(GQA with G > 1, tied and untied embeddings, a sliding window with the ring
wrapping, and reduced Jamba: Mamba and attention layers with MoE on every
other one), prefill → decode parity inside the port, the caches of each
mixer, the xLSTM stacks that used to raise, and a round trip through
``convert``.

Tolerances: weights within 3 ulp (the port's normals follow XLA's erfinv to
a few ulps, tests/test_torch_random.py), Mamba's ``dt_bias`` at rtol 2e-5
(tests/test_torch_mamba.py says why); activations and logits rtol 1e-4,
atol 1e-5 (tests/golden/harness.py), since XLA's and PyTorch's CPU matrix
products sum in other orders.  Reduced Jamba's logits and caches take atol
5e-5: eight layers (two for the reduced Llama) carry those differences, and
the measured gap is 2.1e-5 on logits of order 1.  Prefill → decode inside
the port uses tests/test_models.py's tolerances.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch import random as jr
from repro_torch.convert import transformer_from_jax, transformer_to_numpy
from repro_torch.models import attention, mamba
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-4, atol=1e-5)
JAMBA_TOL = dict(rtol=1e-4, atol=5e-5)


def port_cfg(jcfg):
    fields = dataclasses.asdict(jcfg)
    if fields["moe"] is not None:
        fields["moe"] = configs.MoEConfig(**fields["moe"])
    return configs.ArchConfig(**fields)


def gqa(**kw):
    """A reduced Llama with G = H / KV = 4 (8 query heads, 2 KV heads)."""
    return dataclasses.replace(
        jconfigs.get("llama3.2-1b").reduced(n_heads=8, n_kv_heads=2), **kw)


def jax_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def assert_weights_match(got, want):
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        if name.endswith("dt_bias"):
            np.testing.assert_allclose(got[name], w, rtol=2e-5, atol=0)
        else:
            np.testing.assert_array_max_ulp(got[name], w.astype(np.float32),
                                            maxulp=3)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("seed", [0, 7])
def test_init_params_match_jax(tied, seed):
    jcfg = gqa(tie_embeddings=tied)
    want = dict(leaves(jax_tree(JT.init_params(jax.random.PRNGKey(seed),
                                               jcfg))))
    model = T.init_params(jr.PRNGKey(seed), port_cfg(jcfg), device="cpu")
    got = dict(leaves(transformer_to_numpy(model)))
    assert ("unembed" in got) == (not tied)
    assert_weights_match(got, want)


@pytest.mark.parametrize("seed", [0, 7])
def test_init_params_of_jamba_match_jax(seed):
    """Mamba, attention, dense and MoE leaves of reduced Jamba."""
    jcfg = jconfigs.get("jamba-1.5-large-398b").reduced()
    want = dict(leaves(jax_tree(JT.init_params(jax.random.PRNGKey(seed),
                                               jcfg))))
    model = T.init_params(jr.PRNGKey(seed), port_cfg(jcfg), device="cpu")
    assert_weights_match(dict(leaves(transformer_to_numpy(model))), want)


def test_normal_in_chunks_is_the_same_draw(monkeypatch):
    key = jr.PRNGKey(11)
    whole = jr.normal(key, (37, 101))
    monkeypatch.setattr(jr, "NORMAL_CHUNK", 1000)
    assert torch.equal(jr.normal(key, (37, 101)), whole)


def converted(jcfg, seed=0):
    params = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return params, transformer_from_jax(jax_tree(params), port_cfg(jcfg),
                                        device="cpu")


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


@pytest.mark.parametrize("tied", [True, False])
def test_forward_prefill_decode_match_jax(tied):
    jcfg = gqa(tie_embeddings=tied)
    params, model = converted(jcfg)
    B, S, P = 2, 20, 14
    toks = tokens(jcfg, B, S)
    t = torch.from_numpy(toks)
    with torch.inference_mode():
        want, _ = JT.forward(params, jcfg, tokens=jnp.asarray(toks))
        got, aux = T.forward(model, tokens=t)
        assert got.dtype == torch.float32 and float(aux) == 0.0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

        wl, wc = JT.prefill(params, jcfg, tokens=jnp.asarray(toks[:, :P]),
                            capacity=S)
        gl, gc = T.prefill(model, tokens=t[:, :P], capacity=S)
        assert gl.shape == (B, 1, jcfg.vocab)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
        for i in range(P, S):
            wl, wc = JT.decode_step(params, jcfg,
                                    jnp.asarray(toks[:, i:i + 1]), wc)
            gl, gc = T.decode_step(model, t[:, i:i + 1], gc)
            np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)


def test_sliding_window_ring_wrap_matches_jax():
    """tests/test_models.py's ring-buffer case (window 8, a 6-token prompt,
    12 decode steps through an 8-slot ring), held against JAX's logits."""
    jcfg = gqa(sliding_window=8)
    params, model = converted(jcfg, seed=11)
    toks = tokens(jcfg, 1, 6, seed=11)
    t = torch.from_numpy(toks)
    with torch.inference_mode():
        want, _ = JT.forward(params, jcfg, tokens=jnp.asarray(toks))
        np.testing.assert_allclose(T.forward(model, tokens=t)[0].numpy(),
                                   np.asarray(want), **TOL)
        wl, wc = JT.prefill(params, jcfg, tokens=jnp.asarray(toks),
                            capacity=8)
        gl, gc = T.prefill(model, tokens=t, capacity=8)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
        for _ in range(12):
            wl, wc = JT.decode_step(params, jcfg, jnp.asarray(toks[:, :1]),
                                    wc)
            gl, gc = T.decode_step(model, t[:, :1], gc)
            assert np.isfinite(gl.numpy()).all()
            np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
        assert [c.pos for c in gc] == [18, 18]


def test_a_window_shorter_than_the_prompt_matches_jax():
    """Window 4 < prompt 10: the forward masks to the window (K2's window),
    the prefill's cache holds the whole capacity (not the window) and decode
    attends to all of it — JAX's behaviour, kept (ROADMAP.md, Queue 3)."""
    jcfg = gqa(sliding_window=4)
    params, model = converted(jcfg, seed=3)
    toks = tokens(jcfg, 2, 13, seed=3)
    t = torch.from_numpy(toks)
    with torch.inference_mode():
        want, _ = JT.forward(params, jcfg, tokens=jnp.asarray(toks))
        np.testing.assert_allclose(T.forward(model, tokens=t)[0].numpy(),
                                   np.asarray(want), **TOL)
        wl, wc = JT.prefill(params, jcfg, tokens=jnp.asarray(toks[:, :10]),
                            capacity=13)
        gl, gc = T.prefill(model, tokens=t[:, :10], capacity=13)
        assert gc[0].k.shape[1] == 13
        for i in range(10, 13):
            wl, wc = JT.decode_step(params, jcfg,
                                    jnp.asarray(toks[:, i:i + 1]), wc)
            gl, gc = T.decode_step(model, t[:, i:i + 1], gc)
            np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)


@pytest.mark.parametrize("S,P", [(24, 16), (256, 248)])
def test_jamba_forward_prefill_decode_match_jax(S, P):
    """Reduced Jamba with MoE (capacity drops included); S = 256 runs JAX's
    Mamba scan as two chunks of 128."""
    jcfg = jconfigs.get("jamba-1.5-large-398b").reduced()
    params, model = converted(jcfg, seed=S)
    B = 2
    toks = tokens(jcfg, B, S, seed=S)
    t = torch.from_numpy(toks)
    with torch.inference_mode():
        want, waux = JT.forward(params, jcfg, tokens=jnp.asarray(toks))
        got, aux = T.forward(model, tokens=t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **JAMBA_TOL)
        np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)

        wl, wc = JT.prefill(params, jcfg, tokens=jnp.asarray(toks[:, :P]),
                            capacity=S)
        gl, gc = T.prefill(model, tokens=t[:, :P], capacity=S)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **JAMBA_TOL)
        plan = jcfg.layer_plan()
        for i, (mixer, _) in enumerate(plan):
            if mixer == "mamba":
                np.testing.assert_allclose(gc[i].ssm.numpy(),
                                           np.asarray(wc[i].ssm[0]), **JAMBA_TOL)
                np.testing.assert_allclose(gc[i].conv.numpy(),
                                           np.asarray(wc[i].conv[0]), **JAMBA_TOL)
        for i in range(P, S):
            wl, wc = JT.decode_step(params, jcfg,
                                    jnp.asarray(toks[:, i:i + 1]), wc)
            gl, gc = T.decode_step(model, t[:, i:i + 1], gc)
            np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **JAMBA_TOL)


def drop_free(cfg):
    """tests/test_models.py's parity config: capacity dropping differs
    between a 12-token forward and 1-token decode batches by design."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


@pytest.mark.parametrize("name", ["llama3.2-1b", "phi4-mini-3.8b",
                                  "internlm2-1.8b", "jamba-1.5-large-398b",
                                  "qwen3-moe-30b-a3b"])
def test_prefill_then_decode_reproduces_forward(name):
    """tests/test_models.py's prefill ↔ decode parity, inside the port."""
    cfg = drop_free(configs.get(name).reduced())
    model = T.init_params(jr.PRNGKey(2), cfg, device="cpu")
    B, S, k = 1, 12, 8
    toks = torch.from_numpy(tokens(cfg, B, S, seed=2))
    with torch.inference_mode():
        full, _ = T.forward(model, tokens=toks)
        lg, caches = T.prefill(model, tokens=toks[:, :k], capacity=S)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, k - 1].numpy(),
                                   atol=2e-2, rtol=2e-2)
        for i in range(k, S):
            lg, caches = T.decode_step(model, toks[:, i:i + 1], caches)
            np.testing.assert_allclose(lg[:, 0].numpy(), full[:, i].numpy(),
                                       atol=5e-2, rtol=5e-2)


def test_init_caches_give_each_mixer_its_cache():
    cfg = configs.get("jamba-1.5-large-398b").reduced(layers=16)
    caches = T.init_caches(cfg, 2, 32, device="cpu")
    assert len(caches) == cfg.n_layers == 16
    for i, cache in enumerate(caches):
        if cfg.mixer_pattern[i % 8] == "attn":
            assert isinstance(cache, attention.KVCache)
            assert cache.k.shape == (2, 32, 1, 64)
        else:
            assert isinstance(cache, mamba.MambaCache)
            assert cache.conv.shape == (2, 3, 512)
            assert cache.ssm.shape == (2, 512, 16)
            assert cache.ssm.dtype == torch.float32
            assert not cache.ssm.any() and not cache.conv.any()


def test_init_caches_capped_at_the_window():
    cfg = configs.get("llama3.2-1b").reduced()
    caches = T.init_caches(cfg, 2, 32, device="cpu")
    assert len(caches) == cfg.n_layers and caches[0].k.shape == (2, 32, 1, 64)
    win = T.init_caches(dataclasses.replace(cfg, sliding_window=8), 2, 32,
                        device="cpu")
    assert win[0].k.shape[1] == 8 and win[0].pos == 0


@pytest.mark.parametrize("entry", ["init_caches", "Transformer"])
def test_entry_points_default_to_the_card(entry):
    """``device=None`` means the card: with no card the allocation itself
    fails, rather than landing on the CPU."""
    cfg = configs.get("llama3.2-1b").reduced()

    def build():
        if entry == "init_caches":
            return T.init_caches(cfg, 1, 8)[0].k
        return T.Transformer(cfg).embed

    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            build()


@pytest.mark.parametrize("name,what", [("xlstm-125m", "'mlstm'")])
def test_unported_mixers_and_ffns_raise(name, what):
    """Every mixer of the configurations is ported now: reduced xLSTM-125M
    builds its mLSTM (the mixer ``what`` names) and sLSTM layers with no
    FFN, and only a mixer JAX does not know either raises, with JAX's
    ``ValueError``.  The name is the one the test had while xLSTM's mixers
    raised, kept so that its record stays one test's."""
    cfg = configs.get(name).reduced()
    model = T.init_params(jr.PRNGKey(0), cfg, device="cpu")
    assert repr(model.layers[0].mixer_kind) == what
    assert [b.mixer_kind for b in model.layers] == ["mlstm", "slstm"]
    assert not any(hasattr(b, "ffn") for b in model.layers)
    bad = dataclasses.replace(cfg, mixer_pattern=("rwkv", "mlstm"))
    with pytest.raises(ValueError, match="'rwkv'"):
        T.init_params(jr.PRNGKey(0), bad, device="cpu")


def test_slstm_raises():
    """A stack of sLSTM layers alone, which used to raise, builds, runs and
    carries an :class:`~repro_torch.models.xlstm.SLSTMCache` per layer whose
    normalizer starts at 1.  The name is the one the test had while the
    sLSTM raised, kept so that its record stays one test's."""
    cfg = dataclasses.replace(configs.get("xlstm-125m").reduced(),
                              mixer_pattern=("slstm",), n_layers=2)
    model = T.init_params(jr.PRNGKey(1), cfg, device="cpu")
    caches = T.init_caches(cfg, 2, 8, device="cpu")
    assert all(torch.equal(c.n, torch.ones(2, cfg.d_model)) for c in caches)
    toks = torch.from_numpy(tokens(cfg, 2, 6))
    with torch.inference_mode():
        logits, aux = T.forward(model, tokens=toks)
        _, caches = T.prefill(model, tokens=toks, capacity=8)
    assert logits.shape == (2, 6, cfg.vocab) and torch.isfinite(logits).all()
    assert [type(c).__name__ for c in caches] == ["SLSTMCache"] * 2


def assert_round_trip(jcfg):
    params, model = converted(jcfg, seed=5)
    want = dict(leaves(jax_tree(params)))
    got = dict(leaves(transformer_to_numpy(model)))
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    again = transformer_from_jax(transformer_to_numpy(model), model.cfg,
                                 device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n
    return got


@pytest.mark.parametrize("tied", [True, False])
def test_convert_round_trip(tied):
    assert_round_trip(gqa(tie_embeddings=tied, n_layers=4))


def test_convert_round_trip_of_mamba_and_moe_leaves():
    """Two periods of reduced Jamba: the Mamba leaves (``in_proj`` …
    ``out_proj``) and the MoE ones (``router``, ``w1``, ``w3``, ``w2`` with
    their ``[E]`` axis) go through the port and back bit for bit."""
    got = assert_round_trip(
        jconfigs.get("jamba-1.5-large-398b").reduced(layers=16))
    assert got["blocks.0.mixer.A_log"].shape == (2, 512, 16)
    assert got["blocks.1.ffn.w1"].shape == (2, 4, 256, 128)
    assert {k.split(".")[-1] for k in got if ".mixer." in k} >= {
        "in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
        "A_log", "D", "out_proj"}


def test_bfloat16_weights_convert_exactly():
    """A bfloat16 JAX tree goes through float32 into bfloat16 parameters
    without rounding."""
    jcfg = dataclasses.replace(gqa(), dtype="bfloat16")
    params, model = converted(jcfg)
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.embed.float().numpy(),
        np.asarray(params["embed"]).astype(np.float32))
