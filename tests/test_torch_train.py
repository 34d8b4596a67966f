"""The LLM training path of the port against the JAX package on the CPU,
in float32: ``transformer.loss`` and its gradients, ``fl/distributed.py``
(replica rounds with local iterations and micro-batches, the store-fed
round, masked-dp, ``param_count`` / ``mode_for``, the ``DistFLState``
conversion), the train CLI's arch mode, the two examples, and K2/K3's
autograd functions (their backward by recompute, on the CPU with the
kernels' plain versions standing in for the kernels).

Tolerances: rtol 1e-4, atol 1e-5 (tests/golden/harness.py) on losses,
gradients and parameters, since XLA's and PyTorch's CPU products sum in
other orders; participation counts and non-participants' anchors exact.
Reduced Jamba's gradients take atol 5e-5, as its logits do in
tests/test_torch_transformer.py (eight layers carry the differences).
Each JAX program is jitted once per configuration and shared by the tests
of this file.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.fl import distributed as JD
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch import random as jr
from repro_torch.convert import (dist_state_from_jax, dist_state_to_numpy,
                                 transformer_from_jax)
from repro_torch.data import Dataset, data_stream_key, from_client_datasets
from repro_torch.fl import distributed as D
from repro_torch.kernels import ops, ref
from repro_torch.launch import train
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-4, atol=1e-5)
JAMBA_TOL = dict(rtol=1e-4, atol=5e-5)
REPO = Path(__file__).resolve().parents[1]


def port_cfg(jcfg):
    fields = dataclasses.asdict(jcfg)
    if fields["moe"] is not None:
        fields["moe"] = configs.MoEConfig(**fields["moe"])
    return configs.ArchConfig(**fields)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def as_rows(tree, cfg):
    """A JAX param (or gradient) tree as the port's rows."""
    return D.row_layout(cfg).flatten(transformer_from_jax(tree, cfg,
                                                          device="cpu"))


@functools.lru_cache(maxsize=None)
def jax_value_and_grad():
    return jax.jit(jax.value_and_grad(JT.loss), static_argnums=1)


# ---------------------------------------------------------------------------
# loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["llama3.2-1b", "xlstm-125m",
                                  "jamba-1.5-large-398b", "musicgen-medium"])
def test_loss_and_grads_match_jax(name):
    """``T.loss`` and its gradient with respect to every parameter against
    ``jax.value_and_grad(T.loss)``: attention (K2's plain version), both
    xLSTM mixers, Mamba (K3's) with MoE and its aux loss, and musicgen's
    ``{"embeds", "labels"}`` batch."""
    jcfg = jconfigs.get(name).reduced()
    cfg = port_cfg(jcfg)
    params = JT.init_params(jax.random.PRNGKey(1), jcfg)
    B, S = 2, 12
    if jcfg.embeds_input:
        rng = np.random.default_rng(2)
        batch = {"embeds": rng.standard_normal((B, S, jcfg.d_model))
                 .astype(np.float32),
                 "labels": tokens(jcfg.vocab, (B, S), 3)}
    else:
        batch = {"tokens": tokens(jcfg.vocab, (B, S), 2)}
    want, jgrad = jax_value_and_grad()(
        params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    rows = as_rows(np_tree(params), cfg)
    got, grads = D.loss_and_grads(
        cfg, rows, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), **TOL)
    tol = JAMBA_TOL if name.startswith("jamba") else TOL
    layout = D.row_layout(cfg)
    want_grads = layout.views(as_rows(np_tree(jgrad), cfg))
    for (pname, w), g in zip(want_grads.items(), grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=pname,
                                   **tol)
    if jcfg.moe is not None:       # the aux term reaches the router
        assert float(grads[layout.names.index("layers.1.ffn.router")]
                     .abs().max()) > 0


# ---------------------------------------------------------------------------
# replica mode
# ---------------------------------------------------------------------------

def jax_round(jcfg, K, B, S, mask, local_iters, micro_batches, seed=3):
    state = JD.init_dist_state(jax.random.PRNGKey(seed), jcfg, K)
    toks = tokens(jcfg.vocab, (K, B, S), seed)
    new, m = JD.fl_train_step(state, jcfg, {"tokens": jnp.asarray(toks)},
                              jnp.asarray(mask), 0.05,
                              local_iters=local_iters,
                              micro_batches=micro_batches)
    return state, toks, np_tree(tuple(new)), m


@pytest.mark.parametrize("name", ["llama3.2-1b", "xlstm-125m"])
def test_fl_train_step_matches_jax(name):
    """One replica round, K 3, mask [1, 0, 1], 2 local iterations of 2
    micro-batches each, from the same initial state: participants exact;
    loss, new global model, clients and anchors to tolerance; the
    participants' rows equal to the new global bit for bit, the
    non-participant's anchor equal to before; the new state converts back
    to JAX's tree layout."""
    jcfg = jconfigs.get(name).reduced()
    cfg = port_cfg(jcfg)
    K, mask = 3, np.array([1.0, 0.0, 1.0], np.float32)
    state, toks, want, jm = jax_round(jcfg, K, 4, 16, mask, 2, 2)
    ps = dist_state_from_jax(np_tree(tuple(state)), cfg, device="cpu")
    before = [a.clone() for a in ps.anchor_params]
    got, m = D.fl_train_step(ps, cfg, {"tokens": torch.from_numpy(toks)},
                             torch.from_numpy(mask), 0.05, local_iters=2,
                             micro_batches=2)
    assert int(m["participants"]) == int(jm["participants"]) == 2
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    want_port = dist_state_from_jax(want, cfg, device="cpu")
    for field in ("global_params", "client_params", "anchor_params"):
        for g, w in zip(getattr(got, field), getattr(want_port, field)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=field,
                                       **TOL)
    for g, c, a, old in zip(got.global_params, got.client_params,
                            got.anchor_params, before):
        for k in (0, 2):
            assert torch.equal(c[k], g) and torch.equal(a[k], g)
        assert torch.equal(a[1], old[1])
        assert not torch.equal(c[1], old[1])     # it trained, unsent
    back = dist_state_to_numpy(got, cfg)
    assert (jax.tree_util.tree_structure(back.client_params)
            == jax.tree_util.tree_structure(want[1]))


def test_fl_train_step_from_store_matches_jax():
    """The store-fed round of examples/llm_federated.py at reduced Llama, K
    4: the round's batch drawn from ``fold_in(data_key, t)`` on each side,
    two rounds."""
    from repro.data import Dataset as JDataset
    from repro.data import data_stream_key as j_data_stream_key
    from repro.data import from_client_datasets as j_from_client_datasets
    jcfg = jconfigs.get("llama3.2-1b").reduced()
    cfg = port_cfg(jcfg)
    K, B, S = 4, 2, 16
    corpus = tokens(jcfg.vocab, (K, 4 * B, S), 5)
    jstore = j_from_client_datasets(
        [JDataset(jnp.asarray(corpus[k]), jnp.zeros((4 * B,), jnp.int32),
                  jcfg.vocab) for k in range(K)])
    store = from_client_datasets(
        [Dataset(torch.from_numpy(corpus[k]),
                 torch.zeros(4 * B, dtype=torch.int32), jcfg.vocab)
         for k in range(K)], device="cpu")
    jstate = JD.init_dist_state(jax.random.PRNGKey(3), jcfg, K)
    state = dist_state_from_jax(np_tree(tuple(jstate)), cfg, device="cpu")
    for t, mask in enumerate(([1.0, 1.0, 0.0, 0.0], [0.0, 1.0, 0.0, 1.0])):
        mask = np.array(mask, np.float32)
        jstate, jm = JD.fl_train_step_from_store(
            jstate, jcfg, jstore, j_data_stream_key(2), jnp.int32(t),
            jnp.asarray(mask), 0.05, B)
        state, m = D.fl_train_step_from_store(
            state, cfg, store, data_stream_key(2, device="cpu"), t,
            torch.from_numpy(mask), 0.05, B)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **TOL)
    want = dist_state_from_jax(np_tree(tuple(jstate)), cfg, device="cpu")
    np.testing.assert_allclose(state.global_params[0].numpy(),
                               want.global_params[0].numpy(), **TOL)


@pytest.mark.parametrize("name", ["llama3.2-1b", "qwen3-moe-30b-a3b"])
def test_fl_train_step_masked_dp_matches_jax(name):
    """One masked-dp round, K 3, mask [1, 0, 1] over probabilities [0.5,
    0.25, 1e-8] (the last clamped at 1e-6, so its loss weighs 1e6 / 3):
    loss, participants and the new global model (one backward of the
    weighted loss, MoE's aux term included).  lr 1e-7 keeps that weight's
    step near 0.03 · ∇loss, where a relative 1e-6 of the gradient stays
    under the tolerance; the step itself is held far above it."""
    jcfg = jconfigs.get(name).reduced()
    cfg = port_cfg(jcfg)
    K = 3
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    probs = np.array([0.5, 0.25, 1e-8], np.float32)
    toks = tokens(jcfg.vocab, (K, 2, 12), 7)
    jstate = JD.init_dist_state(jax.random.PRNGKey(3), jcfg, K,
                                mode="masked_dp")
    state = dist_state_from_jax(np_tree(tuple(jstate)), cfg, device="cpu")
    assert state.client_params is None
    jnew, jm = JD.fl_train_step_masked_dp(
        jstate, jcfg, {"tokens": jnp.asarray(toks)}, jnp.asarray(mask),
        jnp.asarray(probs), 1e-7)
    old = state.global_params[0].clone()
    new, m = D.fl_train_step_masked_dp(
        state, cfg, {"tokens": torch.from_numpy(toks)},
        torch.from_numpy(mask), torch.from_numpy(probs), 1e-7)
    assert int(m["participants"]) == int(jm["participants"]) == 2
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    want = dist_state_from_jax(np_tree(tuple(jnew)), cfg, device="cpu")
    np.testing.assert_allclose(new.global_params[0].numpy(),
                               want.global_params[0].numpy(), **TOL)
    assert float((new.global_params[0] - old).abs().max()) > 100 * TOL[
        "atol"]


@pytest.mark.parametrize("name", jconfigs.names())
def test_param_count_and_mode_for_match_jax(name):
    """The analytic count and the mode for the full configuration, and the
    reduced configuration's rows hold exactly that many parameters."""
    assert D.param_count(configs.get(name)) == JD.param_count(
        jconfigs.get(name))
    assert D.mode_for(configs.get(name)) == JD.mode_for(jconfigs.get(name))
    reduced = configs.get(name).reduced()
    assert sum(D.row_layout(reduced).sizes) == D.param_count(reduced)


def test_bf16_xlstm_rows_keep_each_leafs_dtype():
    """A bf16 xLSTM has a bf16 row and a float32 row (its gates and sLSTM
    weights), so no float32 leaf is rounded through bf16; the views write
    through to the rows."""
    cfg = dataclasses.replace(configs.get("xlstm-125m").reduced(),
                              dtype="bfloat16")
    layout = D.row_layout(cfg)
    assert layout.dtypes == (torch.bfloat16, torch.float32)
    model = T.init_params(jr.PRNGKey(0), cfg, device="cpu")
    rows = layout.flatten(model)
    params = dict(model.named_parameters())
    views = layout.views(rows)
    for name, v in views.items():
        assert v.dtype == params[name].dtype and torch.equal(v, params[name])
    views["layers.1.mixer.rz"].zero_()
    assert float(rows[1].abs().sum()) < float(
        sum(p.float().abs().sum() for n, p in params.items()
            if p.dtype == torch.float32))
    viewed = layout.module(cfg, rows)
    assert viewed.layers[1].mixer.rz.data_ptr() == \
        views["layers.1.mixer.rz"].data_ptr()


# ---------------------------------------------------------------------------
# the train CLI's arch mode and the examples
# ---------------------------------------------------------------------------

def jax_cli_rounds(argv, capsys):
    from repro.launch import train as jtrain
    import sys
    old = sys.argv
    sys.argv = ["train"] + argv
    try:
        jtrain.main()
    finally:
        sys.argv = old
    return [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[train] round")]


def parse(line):
    fields = dict(kv.split("=") for kv in line.split(": ")[1].split())
    return float(fields["loss"]), int(fields["participants"]), float(
        fields["energy_j"])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "xlstm-125m"])
def test_train_cli_arch_mode_matches_jax(arch, capsys):
    """``launch.train --arch … --reduced`` in both packages on the same
    flags: the per-round lines' participants exact, loss and energy within
    rtol 1e-4 (the printed digits)."""
    argv = ["--arch", arch, "--reduced", "--rounds", "3", "--clients", "4",
            "--seq-len", "16"]
    want = jax_cli_rounds(argv, capsys)
    state, rounds = train.main(argv + ["--device", "cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("[train] round")]
    assert len(got) == len(want) == 3 == len(rounds)
    for g, w, r in zip(got, want, rounds):
        (gl, gp, ge), (wl, wp, we) = parse(g), parse(w)
        assert gp == wp == r["participants"]
        np.testing.assert_allclose([gl, ge], [wl, we], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose([r["loss"], r["energy_j"]], [wl, we],
                                   rtol=1e-4, atol=5e-4)


def example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_llm_federated_example_matches_jax(capsys):
    """``examples/llm_federated_torch.main`` against
    ``examples/llm_federated.py`` at 3 rounds: the same p*, tx and losses
    on each round line."""
    import sys
    jmod = example("llm_federated")
    old = sys.argv
    sys.argv = ["llm_federated", "--rounds", "3", "--seq-len", "16"]
    try:
        jmod.main()
    finally:
        sys.argv = old
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.strip().startswith("round")]
    rounds = example("llm_federated_torch").main(
        ["--rounds", "3", "--seq-len", "16", "--device", "cpu"])
    assert len(want) == len(rounds) == 3
    for line, r in zip(want, rounds):
        loss = float(line.split("loss=")[1].split()[0])
        probs = np.array(line.split("p*=[")[1].split("]")[0].split(),
                         np.float32)
        tx = int(line.split("tx=")[1])
        assert r["tx"] == tx
        np.testing.assert_allclose(r["probs"], probs, rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-4, atol=5e-5)


def test_serve_batched_example_runs_xlstm(capsys):
    """``examples/serve_batched_torch.py`` runs ``repro_torch.launch.serve
    --arch xlstm-125m --reduced``; in-process here, the same tokens as
    JAX's ``repro.launch.serve`` on the same flags."""
    from repro.launch import generate as jgenerate
    from repro_torch.launch import serve
    cmd = example("serve_batched_torch").command(["--device", "cpu"])
    assert cmd[1:6] == ["-m", "repro_torch.launch.serve", "--arch",
                        "xlstm-125m", "--reduced"]
    with pytest.warns(DeprecationWarning):
        out = serve.main(cmd[3:])
    import sys
    old = sys.argv
    sys.argv = ["generate", "--arch", "xlstm-125m", "--reduced", "--batch",
                "4", "--new-tokens", "12"]
    try:
        jgenerate.main()
    finally:
        sys.argv = old
    lines = capsys.readouterr().out.splitlines()
    samples = [ln for ln in lines if ln.startswith("[generate] sample")]
    assert len(samples) == 4 and samples[:2] == samples[2:]
    assert out["tokens"].shape == (4, 12)


# ---------------------------------------------------------------------------
# K2 and K3 under autograd, and the package surface
# ---------------------------------------------------------------------------

def test_kernel_functions_backward_by_recompute(monkeypatch):
    """K2 and K3 under autograd, run here with each kernel's plain
    version in the kernel's place: the custom ops (``repro_torch::
    flash_attention``, ``::selective_scan``), which the dispatchers take
    for every autograd call on a CUDA tensor.  Each forward is the plain
    value and the gradients with respect to every input, through the
    recompute backward, equal autograd through the plain version bit for
    bit (K3's ``h_last`` cotangent too)."""
    monkeypatch.setattr(ops, "flash_attention_cuda", ref.flash_attention_ref)
    monkeypatch.setattr(ops, "selective_scan_cuda", ref.selective_scan_ref)
    rng = np.random.default_rng(0)

    def leaf(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32)
                            * scale, requires_grad=True)

    q, k, v = leaf(2, 9, 4, 64), leaf(2, 9, 2, 64), leaf(2, 9, 2, 64)
    g = torch.from_numpy(rng.standard_normal((2, 9, 4, 64))
                         .astype(np.float32))
    want_out = ref.flash_attention_ref(q, k, v, causal=True, window=4)
    want = torch.autograd.grad(want_out, (q, k, v), g)
    out = ops.flash_attention_op(q, k, v, True, 4)
    got = torch.autograd.grad(out, (q, k, v), g)
    torch.testing.assert_close(out, want_out.detach(), rtol=0, atol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    xc, dt = leaf(2, 7, 5), leaf(2, 7, 5, scale=0.1)
    Bm, Cm = leaf(2, 7, 8), leaf(2, 7, 8)
    A = torch.tensor(-np.arange(1, 9, dtype=np.float32)[None].repeat(5, 0),
                     requires_grad=True)
    D_ = leaf(5)
    gy = torch.from_numpy(rng.standard_normal((2, 7, 5)).astype(np.float32))
    gh = torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(np.float32))
    inputs = (xc, dt, Bm, Cm, A, D_)
    wy, wh = ref.selective_scan_ref(*inputs)
    want = torch.autograd.grad((wy, wh), inputs, (gy, gh))
    y, h = ops.selective_scan_op(*inputs)
    got = torch.autograd.grad((y, h), inputs, (gy, gh))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_models_and_kernels_export_the_jax_names():
    """``repro_torch.models`` and ``repro_torch.kernels`` export every name
    of ``repro.models`` and ``repro.kernels``; the kernels' names are the
    dispatchers (plain versions on a CPU tensor)."""
    import repro.kernels as jk
    import repro.models as jm
    import repro_torch.kernels as tk
    import repro_torch.models as tm
    for jmod, tmod in ((jm, tm), (jk, tk)):
        assert set(jmod.__all__) <= set(tmod.__all__)
        assert all(hasattr(tmod, name) for name in tmod.__all__)
    assert tm.loss is T.loss and tm.xlstm.MLSTM is not None
    assert tk.fl_aggregate is ops.fl_aggregate
    g = torch.zeros(5)
    d = torch.ones(2, 5)
    torch.testing.assert_close(tk.fl_aggregate(g, d, torch.tensor([1., 0.])),
                               torch.full((5,), 0.5))
