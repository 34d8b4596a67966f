"""The port's launch layer (``repro_torch.launch.mesh``, ``sharding``,
``specs``) and its model hints (``models/pshard.py``, ``costmode.py``)
against the JAX package on the CPU, with the public functions the port
lacked before it (channel, MLP size, ``replicate``, ``round_decision``,
``make_runner(shard_clients=...)``).

* Placements: every parameter of the 10 configs at full size (built on the
  meta device), on the 16×16 and 2×16×16 meshes, FSDP on and off: the
  port's spec = JAX's ``param_pspec`` on the mapped key path, entry by
  entry (JAX's ``FakeMesh`` of tests/test_launch.py needs no devices).
* Programs: every arch × shape × mesh, the port's ``input_specs`` leaves
  (shape, dtype, spec) = JAX's ``input_specs`` leaves and in-shardings,
  dumped by ``tests/_jax_launch_dump.py`` in one subprocess with 512 host
  devices.  JAX stacks the layers (``[R, ...]``) and its KV caches carry an
  int32 ``pos`` leaf; the port's layers are unstacked and ``pos`` is an int.
* ``pshard`` on plain tensors returns the tensor itself and dispatches no
  operation; a forward with the hints = one without them, bit for bit and
  op for op.  Under ``cost_probe()`` the port's xLSTM (one chunk of S) and
  Mamba forwards = JAX's cost-mode forwards at rtol 1e-4, atol 1e-5.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.core import channel as JC
from repro.fl import state as JS
from repro.launch.sharding import param_pspec as jax_param_pspec
from repro.models import costmode as jcostmode
from repro.models import mamba as JM
from repro.models import small as JSM
from repro.models import xlstm as JX
from repro_torch import configs
from repro_torch import random as jr
from repro_torch.configs.shapes import SHAPES
from repro_torch.convert import load_jax_tree
from repro_torch.core import channel as C
from repro_torch.fl import engine as E
from repro_torch.fl import state as FS
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.launch.specs import input_specs, param_shapes
from repro_torch.models import costmode, pshard
from repro_torch.models import mamba as PM
from repro_torch.models import small as PSM
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as PX

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)
MESHES = {"16x16": M.production_mesh_spec(),
          "2x16x16": M.production_mesh_spec(multi_pod=True)}


class FakeMesh:
    """JAX's mesh as its rules read it (tests/test_launch.py:49)."""

    def __init__(self, spec: M.MeshSpec):
        self.axis_names = spec.axis_names
        self.devices = np.empty(spec.shape, object)


def jspec(p) -> tuple:
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in p)


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

def test_mesh_axes_clients_and_card_constants():
    """JAX's shapes and axis names; dp axes and clients as JAX's; the
    H100 SXM5 data sheet's rates (the TPU v5e constants are not ported)."""
    one, two = MESHES["16x16"], MESHES["2x16x16"]
    assert one == (("data", "model"), (16, 16))
    assert two == (("pod", "data", "model"), (2, 16, 16))
    assert M.dp_axes(one) == ("data",) and M.dp_axes(two) == ("pod", "data")
    assert M.num_clients(one) == 16 and M.num_clients(two) == 32
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW, M.NVLINK_BW, M.HBM_PER_CHIP) == (
        989e12, 3.35e12, 450e9, 80e9)
    assert not hasattr(M, "ICI_BW") and not hasattr(M, "CHIPS_PER_POD")
    assert not torch.distributed.is_initialized()   # importing opened none


# ---------------------------------------------------------------------------
# placements: the port's rules = JAX's, parameter by parameter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.names())
def test_param_specs_equal_jax(arch, mesh, fsdp):
    cfg = configs.get(arch)
    sb, R = len(cfg.mixer_pattern), cfg.n_repeats
    spec, fake = MESHES[mesh], FakeMesh(MESHES[mesh])
    for name, (shape, _) in param_shapes(cfg).items():
        path = SH.jax_path(name, sb)
        stacked = "blocks" in path
        want = jax_param_pspec(path, (R, *shape) if stacked else shape, fake,
                               stacked_layers=True, fsdp=fsdp)
        want = jspec(want)[1:] if stacked else jspec(want)
        got = SH.module_param_spec(name, shape, spec, sb, fsdp=fsdp)
        assert got == want, (name, got, want)


def test_to_placements_splits_a_dim_over_pod_and_data():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)
    assert SH.to_placements((("pod", "data"), None, "model"), Mesh()) == [
        Shard(0), Shard(0), Shard(2)]
    assert SH.to_placements((None,), Mesh()) == [Replicate()] * 3
    Mesh.shape = (1, 16, 1)      # a split over one rank is the whole
    assert SH.to_placements((("pod", "data"), None, "model"), Mesh()) == [
        Replicate(), Shard(0), Replicate()]


def test_client_axis_and_ledger_rules_match_jax():
    """The store and ledger rules on a 1-D ``("k",)`` mesh: the leading K
    over it when it divides, else replicated (JAX's
    tests/test_device_store.py:323)."""
    from repro.launch import sharding as JSH
    from jax.sharding import Mesh
    jmesh = Mesh(np.array(jax.devices()[:1]), ("k",))
    shapes = {"x": (4, 3, 2), "y": (4, 3), "lengths": (4,), "s": ()}
    tree = {n: jnp.zeros(s) for n, s in shapes.items()}
    want = {n: jspec(s.spec) for n, s in
            JSH.client_axis_shardings(tree, jmesh, "k").items()}
    got = SH.client_axis_shardings(shapes, M.MeshSpec(("k",), (1,)), "k")
    assert got == want
    assert SH.ledger_shardings(shapes, M.MeshSpec(("k",), (3,))) == {
        "x": (), "y": (), "lengths": (), "s": ()}


# ---------------------------------------------------------------------------
# programs: the port's input_specs = JAX's, leaf by leaf
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_programs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "specs.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "tests",
                                                     "_jax_launch_dump.py"),
                        "specs", str(out)], env=env, capture_output=True,
                       text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(out.read_text())


def jax_name(path: str, kind: str, sb: int):
    """The port's leaf name(s) of JAX's leaf ``path`` (a keystr over the
    program's arguments), and whether the leaf is layer-stacked."""
    import re
    arg = int(re.match(r"\[(\d+)\]", path).group(1))
    rest = path[len(f"[{arg}]"):]
    names = {"train": ["state", "batch", "mask", "probs"],
             "prefill": ["params", "batch"],
             "decode": ["params", "token", "caches"]}[kind]
    prefix = names[arg]
    keys = re.findall(r"\['([^']+)'\]|\[(\d+)\]|\.(\w+)", rest)
    parts = [a or b or c for a, b, c in keys]
    if prefix == "caches":
        return prefix, ["cache", parts[0], parts[1]], True
    stacked = "blocks" in parts
    return prefix, parts, stacked


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", configs.names())
def test_input_specs_equal_jax(jax_programs, arch, shape, mesh):
    spec = MESHES[mesh]
    want = jax_programs[f"{arch}|{shape}|{'x'.join(map(str, spec.shape))}"]
    prog = input_specs(arch, shape, spec, abstract=True)
    kind = SHAPES[shape].kind
    cfg = prog.meta["cfg"]
    sb, R = len(cfg.mixer_pattern), cfg.n_repeats
    assert prog.meta.get("mode", "-") == want["mode"]
    got = {}
    for tree in prog.in_placements:
        got.update(tree)
    leaves = {}
    from repro_torch.launch.specs import _tree_leaves
    trees = dict(zip({"train": ["state", "batch", "mask", "probs"],
                      "prefill": ["params", "batch"],
                      "decode": ["params", "token", "caches"]}[kind],
                     prog.args))
    for prefix, tree in trees.items():
        leaves.update(dict(_tree_leaves(prefix, tree)))
    matched, pos = set(), 0
    for leaf in want["leaves"]:
        prefix, parts, stacked = jax_name(leaf["path"], kind, sb)
        wshape, wspec = tuple(leaf["shape"]), jspec(leaf["spec"])
        if prefix == "caches":
            i, field = int(parts[1]), parts[2]
            if field == "pos":       # JAX's int32 position: an int here
                pos += 1
                continue
            names = [f"caches.{r * sb + i}.{field}" for r in range(R)]
            lead = 0                 # [R, B, ...]: drop R
        elif stacked:
            # [K?, R, ...] blocks leaves: layer r·sb + i of the port
            bi = parts.index("blocks")
            i = int(parts[bi + 1])
            tail = ".".join(parts[bi + 2:])
            head = ".".join(parts[:bi])
            names = [f"{prefix}.{head + '.' if head else ''}layers."
                     f"{r * sb + i}.{tail}" for r in range(R)]
            lead = 1 if head in ("client_params", "anchor_params") else 0
        else:
            names = [".".join([prefix] + parts)]
            lead = None
        for n in names:
            assert n in leaves, (leaf["path"], n)
            lf = leaves[n]
            if lead is None:
                ws, wp = wshape, wspec
            else:
                ws = wshape[:lead] + wshape[lead + 1:]
                wp = wspec[:lead] + wspec[lead + 1:] if len(wspec) > lead \
                    else wspec
            assert lf.shape == ws, (n, lf.shape, ws)
            assert str(lf.dtype).split(".")[1] == leaf["dtype"], n
            padded = tuple(lf.spec) + (None,) * (len(ws) - len(lf.spec))
            wpad = tuple(wp) + (None,) * (len(ws) - len(wp))
            assert padded == wpad, (n, lf.spec, wp)
            matched.add(n)
    assert matched == set(leaves), set(leaves) - matched
    attn = sum(m == "attn" for m in cfg.mixer_pattern)
    assert pos == (attn if kind == "decode" else 0)


# ---------------------------------------------------------------------------
# pshard and costmode
# ---------------------------------------------------------------------------

class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_pshard_on_plain_tensors_is_the_tensor_and_no_op():
    x = torch.randn(2, 8, 16, requires_grad=True)
    q = x[..., None]
    with OpLog() as log:
        outs = [pshard.shard_dim(x, 1), pshard.shard_last(x),
                pshard.replicate_over(x), pshard.settle(x),
                pshard.gather_dim(x, -2), pshard.whole_heads(x, 3),
                pshard.constrain(x, ())]
        k, v = pshard.gqa_heads(q, x, x)
    assert all(o is x for o in outs) and k is x and v is x
    assert log.ops == []


def _tiny_llama():
    cfg = configs.get("llama3.2-1b").reduced(layers=2)
    return cfg, T.init_params(jr.PRNGKey(0), cfg, device="cpu")


def test_forward_with_hints_equals_without_op_for_op(monkeypatch):
    """The hints on one device change no value and add no operation: the
    loss and its gradients with them and with every hint replaced by the
    identity, bit for bit, the same ATen operations in the same order."""
    cfg, model = _tiny_llama()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))

    def run():
        with OpLog() as log:
            value = T.loss(model, {"tokens": tokens})
        return value, log.ops

    with_hints, ops = run()
    import repro_torch.models.attention as A
    import repro_torch.models.moe as MO
    ident = lambda x, *a, **k: x                      # noqa: E731
    for mod in (T, A, MO, PM, PX):
        for name in ("shard_dim", "shard_last", "settle", "replicate_over",
                     "gather_dim", "whole_heads"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, ident)
    monkeypatch.setattr(A.pshard, "whole_heads", ident)
    monkeypatch.setattr(A.pshard, "gqa_heads", lambda q, k, v: (k, v))
    without, ops_without = run()
    assert torch.equal(with_hints, without) and ops == ops_without


def test_cost_probe_flag_is_jax_flag_semantics():
    assert not costmode.cost_mode()
    with costmode.cost_probe():
        assert costmode.cost_mode()
        with costmode.cost_probe():
            assert costmode.cost_mode()
        assert costmode.cost_mode()
    assert not costmode.cost_mode()


def _port_cfg(jcfg):
    fields = dataclasses.asdict(jcfg)
    if fields["moe"] is not None:
        fields["moe"] = configs.MoEConfig(**fields["moe"])
    return configs.ArchConfig(**fields)


def test_mlstm_under_cost_probe_matches_jax_cost_mode():
    """S 512: two chunks of 256 normally, one chunk of S under the probe,
    in both packages; the port's cost-mode forward = JAX's."""
    jcfg = jconfigs.get("xlstm-125m").reduced(layers=2)
    jp = JX.init_mlstm(jax.random.PRNGKey(4), jcfg, jnp.float32)
    p = PX.MLSTM(_port_cfg(jcfg), torch.float32, device="cpu")
    load_jax_tree(p, jax.tree_util.tree_map(np.asarray, jp))
    x = (np.random.default_rng(4).standard_normal((1, 512, jcfg.d_model))
         * 0.5).astype(np.float32)
    with jcostmode.cost_probe():
        want = JX.mlstm_forward(jp, jcfg, jnp.asarray(x))
    with torch.inference_mode(), costmode.cost_probe():
        got = PX.mlstm_forward(p, _port_cfg(jcfg), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with torch.inference_mode():
        chunked = PX.mlstm_forward(p, _port_cfg(jcfg), torch.from_numpy(x))
    np.testing.assert_allclose(chunked.numpy(), got.numpy(), rtol=1e-3,
                               atol=1e-4)


def test_mamba_under_cost_probe_matches_jax_cost_mode():
    """S 256: JAX's chunks of 128 become one chunk of S under the probe;
    the port has no chunking, so its forward is the same with or without
    the probe, and = JAX's cost-mode forward."""
    jcfg = jconfigs.get("jamba-1.5-large-398b").reduced()
    jp = JM.init_mamba(jax.random.PRNGKey(5), jcfg, jnp.float32)
    cfg = _port_cfg(jcfg)
    p = PM.Mamba(cfg, torch.float32, "cpu")
    load_jax_tree(p, jax.tree_util.tree_map(np.asarray, jp))
    x = np.random.default_rng(5).standard_normal(
        (2, 256, jcfg.d_model)).astype(np.float32)
    with jcostmode.cost_probe():
        want = JM.mamba_forward(jp, jcfg, jnp.asarray(x))
    with torch.inference_mode():
        plain = PM.mamba_forward(p, cfg, torch.from_numpy(x))
        with costmode.cost_probe():
            got = PM.mamba_forward(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(plain, got)


# ---------------------------------------------------------------------------
# the public functions the port lacked
# ---------------------------------------------------------------------------

def test_sample_fading_matches_jax():
    """The port's exponential is ``−log1p(−u)`` on JAX's uniforms: a few
    draws differ in the last float32 ulp."""
    want = np.asarray(JC.sample_fading(jax.random.PRNGKey(3), (7, 11)))
    got = C.sample_fading(jr.PRNGKey(3), (7, 11), device="cpu")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_rate_bits_and_tx_energy_match_jax():
    rng = np.random.default_rng(1)
    cell = JC.CellConfig(num_clients=16)
    w = rng.uniform(0, 0.2, 16).astype(np.float32)
    w[3] = 0.0
    h = rng.exponential(1e-11, 16).astype(np.float32)
    p = rng.uniform(0, 1, 16).astype(np.float32)
    p[5] = 0.0
    args = (cell.tx_power_w, cell.bandwidth_hz, cell.noise_w_per_hz)
    want = np.asarray(JC.rate_bits(jnp.asarray(w), jnp.asarray(h), *args))
    got = C.rate_bits(torch.from_numpy(w), torch.from_numpy(h), *args)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want = np.asarray(JC.tx_energy_j(jnp.asarray(p), jnp.asarray(w),
                                     jnp.asarray(h), *args,
                                     cell.model_size_nats))
    got = C.tx_energy_j(torch.from_numpy(p), torch.from_numpy(w),
                        torch.from_numpy(h), *args, cell.model_size_nats)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert got[5] == 0.0


def test_mlp_size_bits_matches_jax():
    jp = JSM.init_mlp(jax.random.PRNGKey(0))
    pp = PSM.init_mlp(jr.PRNGKey(0), device="cpu")
    assert PSM.mlp_size_bits(pp) == JSM.mlp_size_bits(jp) == 159_010 * 32


def test_replicate_matches_jax():
    jp = JSM.init_mlp(jax.random.PRNGKey(1), dims=(6, 4, 3))
    pp = PSM.init_mlp(jr.PRNGKey(1), dims=(6, 4, 3), device="cpu")
    want = JS.replicate(jp, 5)
    got = FS.replicate(pp, 5)
    for layer_w, layer_g in zip(want, got):
        for name in ("w", "b"):
            assert tuple(layer_g[name].shape) == layer_w[name].shape
            np.testing.assert_array_max_ulp(layer_g[name].numpy(),
                                            np.asarray(layer_w[name]),
                                            maxulp=3)


def test_round_decision_matches_jax():
    """Steps 2–4 of one round through the random policy with Δ_k forcing:
    mask, forced and bandwidth bit for bit, energy at rtol 1e-4."""
    from repro.core import selection as JSEL
    from repro.fl import engine as JE
    from repro_torch.core import selection as PSEL
    K, t = 10, 4
    jcell = JC.CellConfig(num_clients=K)
    pcell = C.CellConfig(num_clients=K)
    h = np.random.default_rng(2).exponential(1e-11, K).astype(np.float32)
    jcfg = JE.SimConfig(rounds=8, max_staleness=2)
    pcfg = E.SimConfig(rounds=8, max_staleness=2)
    jstate = JS.init_fl_state({"w": jnp.zeros(3)}, K)._replace(
        round=jnp.asarray(t, jnp.int32),
        last_tx=jnp.asarray([0, 4, 1, 3, 2, 4, 0, 1, 2, 3], jnp.int32))
    pstate = FS.init_fl_state([{"w": torch.zeros(3)}], K, device="cpu")
    pstate = pstate._replace(
        round=torch.tensor(t, dtype=torch.int32),
        last_tx=torch.tensor([0, 4, 1, 3, 2, 4, 0, 1, 2, 3],
                             dtype=torch.int32))
    jpol = JSEL.as_policy_fn(JSEL.RandomScheme(0.3, K))
    ppol = PSEL.as_policy_fn(PSEL.RandomScheme(0.3, K))
    want = JE.round_decision(jpol, jnp.asarray(t), jnp.asarray(h), jstate,
                             jax.random.PRNGKey(9), jcfg, jcell, K)
    got = E.round_decision(ppol, t, torch.from_numpy(h), pstate,
                           jr.PRNGKey(9), pcfg, pcell, K)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), **TOL)


def test_make_runner_shard_clients_one_card_and_more(monkeypatch):
    """One visible device: ``_client_mesh`` is None, as JAX's, and the
    runner is the same; more than one card: the placement JAX's mesh
    gives, K 10 over the first 2 of 4 cards, 5 rows a card."""
    assert E._client_mesh(10, device="cpu") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert E._client_mesh(10, device="cuda") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    place = E._client_mesh(10, device="cuda")
    assert place.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert place.num_clients == 10 and place.rows == 5
    assert E._client_mesh(7, device="cpu") is None


def test_one_card_prediction_equals_a_real_run_on_the_cpu():
    """``dryrun.check_one_card`` on a world of one rank, here with CPU
    tensors: the fake run's argument bytes, FLOPs and peak temporary bytes
    equal the same programs' on real tensors (reduced Llama: prefill,
    decode against a full cache, a training round at K 4), the real
    outputs are finite, the tokens in range, and they equal the same
    program's on plain copies of the arguments (tokens exactly, floats
    within ``assert_close``'s defaults)."""
    from repro_torch.launch import dryrun as DR
    cfg = configs.get("llama3.2-1b").reduced(layers=2, d_model=256,
                                            n_heads=4, n_kv_heads=1)
    from repro_torch.configs.shapes import InputShape
    progs = {"prefill": InputShape("p", 64, 2, "prefill"),
             "decode": InputShape("d", 72, 2, "decode"),
             "train": InputShape("t", 16, 8, "train")}
    out = DR.check_one_card("llama3.2-1b", progs, clients=4,
                            device_type="cpu", cfg_override=cfg)
    assert not torch.distributed.is_initialized()
    for tag, rec in out.items():
        p, m = rec["predicted"], rec["measured"]
        assert m["allocated_args"] == p["memory"]["argument_size_in_bytes"]
        assert m["cost"]["flops"] == p["cost"]["flops"] > 0, tag
        assert m["peak_temp_bytes"] == p["memory"]["temp_size_in_bytes"], tag
        assert m["out"]["finite"], tag
        assert 0 <= m["out"]["int_range"][0] <= m["out"]["int_range"][1] \
            < max(cfg.vocab, 73), tag
        assert m["plain"]["within"] and m["plain"]["leaves"] == 5, tag


@pytest.mark.parametrize("mode", ["replica", "masked_dp"])
def test_stacked_train_programs_give_the_flat_rows_numbers(mode):
    """The dry run's train programs against ``fl_train_step`` /
    ``fl_train_step_masked_dp`` on the flat rows from the same state.
    Replica: the program is ``fl_train_step`` itself over rows whose
    per-parameter views are DTensors (``RowPlacement``), here on a world
    of one rank (a 1×1 mesh): bit for bit.  Masked-dp, on per-parameter
    tensors, whose K losses come from one merged forward: rtol 1e-6.  (The
    name is the one of the test that held the former per-parameter replica
    round.)"""
    from repro_torch.fl import distributed as FD
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.specs import _replica_rows, param_shapes
    cfg = configs.get("llama3.2-1b").reduced(layers=2, d_model=64,
                                            n_heads=2, vocab=96)
    K = 2
    state = FD.init_dist_state(jr.PRNGKey(1), cfg, K, mode=mode,
                               device="cpu")
    layout = FD.row_layout(cfg)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (K, 2, 12)).astype(np.int32))
    mask = torch.tensor([1.0, 0.0])
    if mode == "replica":
        from torch.distributed.tensor import DTensor, Replicate
        from torch.distributed.tensor.experimental import \
            implicit_replication
        M.fabricate_world(1)
        try:
            mesh = M.make_mesh((1, 1), M.AXES, "cpu")
            shapes = {n: s for n, (s, _) in param_shapes(cfg).items()}
            sb = len(cfg.mixer_pattern)
            pool = [t.clone() for t in (*state.global_params,
                                        *state.client_params,
                                        *state.anchor_params)]
            placement, st = _replica_rows(
                cfg, K, SH.params_shardings(shapes, mesh, sb),
                SH.client_stacked_shardings(shapes, mesh, sb), mesh,
                lambda shape, dtype: pool.pop(0))
            assert placement.k_dims == ()
            on_mesh = {n: DTensor.from_local(x, mesh, [Replicate()] * 2)
                       for n, x in (("tokens", tokens), ("mask", mask))}
            with implicit_replication():    # as the dry run runs it
                got, gm = FD.fl_train_step(
                    st, cfg, {"tokens": on_mesh["tokens"]}, on_mesh["mask"],
                    0.05, placement=placement)
            gm = {k: v.to_local() for k, v in gm.items()}
        finally:
            M.close_world()
        want, wm = FD.fl_train_step(state, cfg, {"tokens": tokens}, mask,
                                    0.05)
        for g, w in zip((*got.global_params, *got.client_params),
                        (*want.global_params, *want.client_params)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        torch.testing.assert_close(gm["loss"], wm["loss"], rtol=0, atol=0)
        return

    def stacked(rows):
        """Per-parameter copies of rows (``[P]``)."""
        return {n: v.clone() for n, v in layout.views(rows).items()}
    probs = torch.tensor([0.5, 0.25])
    got, gm = FD.fl_train_step_masked_dp_stacked(
        FD.DistFLState(stacked(state.global_params), None, None), cfg,
        {"tokens": tokens}, mask, probs, 0.05)
    want, wm = FD.fl_train_step_masked_dp(state, cfg, {"tokens": tokens},
                                          mask, probs, 0.05)
    tol = dict(rtol=1e-6, atol=1e-7)
    for n, v in layout.views(want.global_params).items():
        torch.testing.assert_close(got.global_params[n], v, **tol)
    torch.testing.assert_close(gm["loss"], wm["loss"], **tol)
