"""The port's dry run (``repro_torch.launch.dryrun``) on a fabricated world
at reduced size, against JAX's compiled programs, and the custom ops that
make K2 and K3 (and the sLSTM recurrence) visible to it.

* One config per mixer family (attention: Llama-3.2-1B; attention + MoE:
  Qwen3-MoE; Mamba/attention/MoE: Jamba; mLSTM/sLSTM: xLSTM), reduced, on a
  fake 2×4 ``("data", "model")`` mesh (8 ranks in this process), one
  program of each kind (train, prefill, decode):
  - the dry run runs (``status: ok``);
  - argument bytes on the device = JAX's
    ``memory_analysis().argument_size_in_bytes`` for the same config on a
    2×4 mesh of host devices (``tests/_jax_launch_dump.py reduced``, one
    subprocess started before the port's runs), less JAX's int32 KV-cache
    positions (a Python int in the port);
  - the cost probes' total = the full-depth count
    (``tests/test_torch_dryrun_probes.py``);
  - prefill FLOPs = an analytic count of the matmuls from the config and
    the placements (batch over "data", heads, FFN, experts and channels
    over "model").  The mLSTM's three-operand einsums count by torch's
    contraction order, so xLSTM is held by its probes and the sLSTM
    recurrence's formula instead.
* ``python -m repro_torch.launch.dryrun --arch xlstm-125m --shape
  decode_32k --no-probe`` in a subprocess (JAX's tests/test_launch.py:97).
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.shapes import InputShape
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as M
from repro_torch.launch.specs import input_specs
from repro_torch.models import xlstm as X

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the reduced configs and shapes of tests/_jax_launch_dump.py
REDUCED = {
    "llama3.2-1b": dict(layers=2, d_model=512, n_heads=8, n_kv_heads=8),
    "qwen3-moe-30b-a3b": dict(layers=2, d_model=512, n_heads=8,
                              n_kv_heads=8),
    "jamba-1.5-large-398b": dict(layers=8, d_model=256, n_heads=8,
                                 n_kv_heads=8),
    "xlstm-125m": dict(layers=2, d_model=256, n_heads=4),
}
SHAPES = {"train": InputShape("train_small", 64, 8, "train"),
          "prefill": InputShape("prefill_small", 64, 4, "prefill"),
          "decode": InputShape("decode_small", 64, 4, "decode")}


def reduced(arch, **kw):
    return configs.get(arch).reduced(**{**REDUCED[arch], **kw})


@pytest.fixture(scope="module")
def jax_reduced(tmp_path_factory):
    """JAX's compiled programs, dumped by a subprocess that runs while the
    port's dry runs do."""
    out = tmp_path_factory.mktemp("jax") / "reduced.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_jax_launch_dump.py"),
         "reduced", str(out)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)

    def result():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log
        return json.loads(out.read_text())
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def mesh():
    M.fabricate_world(8)
    yield M.make_mesh((2, 4), ("data", "model"))
    M.close_world()


@pytest.fixture(scope="module")
def runs(mesh, jax_reduced):
    """The port's dry run of each family × kind (started after JAX's
    subprocess, so both run at once)."""
    out = {}
    for arch in REDUCED:
        for kind, shape in SHAPES.items():
            spec = input_specs(arch, shape, mesh, cfg_override=reduced(arch))
            rec = DR.run_program(spec)
            del rec["out"]
            out[(arch, kind)] = rec
    return out


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", list(REDUCED))
def test_argument_bytes_equal_jax(runs, jax_reduced, arch, kind):
    want = jax_reduced()[f"{arch}|{SHAPES[kind].name}"]
    rec = runs[(arch, kind)]
    pos = sum(4 * leaf["shape"][0] for leaf in want["leaves"]
              if leaf["path"].endswith(".pos"))
    assert rec["memory"]["argument_bytes_unrounded"] == \
        want["argument_size_in_bytes"] - pos
    assert rec["cost"]["flops"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0


def _attn_flops(cfg, Bl, S, m):
    """One attention layer's matmuls on a device: batch Bl, heads / m;
    the K/V projections split only when a shard holds ≥ 128 of their
    features (JAX's GQA rule), else whole on every device."""
    T, d, hd = Bl * S, cfg.d_model, cfg.hd
    H, KV = cfg.n_heads // m, cfg.n_kv_heads
    if KV * hd % m == 0 and KV * hd // m >= 128:
        KV //= m
    proj = 2 * T * d * (2 * H + 2 * KV) * hd
    return proj + ops.flash_attention_flops((Bl, S, H, hd), True,
                                            cfg.sliding_window)


def _moe_flops(cfg, T, Tl, m):
    """One MoE layer: the router over this device's tokens, JAX's one-hot
    dispatch (tokens over "data", whole over "model"), the experts over
    "model", the combine split both ways."""
    from repro_torch.models.moe import capacity
    mo, d = cfg.moe, cfg.d_model
    g = min(1024, T)
    C = capacity(g, mo)
    E, f = mo.num_experts, mo.d_ff_expert
    G = T // g
    router = 2 * Tl * d * E
    dispatch = 2 * Tl * E * C * d
    experts = 3 * 2 * G * (E // m) * C * d * f
    combine = 2 * Tl * (E // m) * C * d
    return router + dispatch + experts + combine


def _mamba_flops(cfg, Tl, m):
    import math
    d = cfg.d_model
    di, r, N = cfg.ssm_expand * d, max(1, math.ceil(d / 16)), cfg.ssm_state
    dil = di // m
    return 2 * Tl * (d * 2 * dil + dil * (r + 2 * N) + r * dil + dil * d)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-moe-30b-a3b",
                                  "jamba-1.5-large-398b"])
def test_prefill_matmul_flops_equal_analytic(runs, arch):
    cfg = reduced(arch)
    B, S, dn, m = 4, 64, 2, 4
    Bl, T = B // dn, B * S
    Tl = Bl * S
    total = 0
    for li in range(cfg.n_layers):
        mixer = cfg.mixer_pattern[li % len(cfg.mixer_pattern)]
        total += _attn_flops(cfg, Bl, S, m) if mixer == "attn" else \
            _mamba_flops(cfg, Tl, m)
        kind = cfg.ffn_kind(li)
        if kind == "dense":
            total += 3 * 2 * Tl * cfg.d_model * (cfg.d_ff // m)
        elif kind == "moe":
            total += _moe_flops(cfg, T, Tl, m)
    total += 2 * Bl * cfg.d_model * (cfg.vocab // m)   # last position
    assert runs[(arch, "prefill")]["cost"]["flops"] == total


def test_slstm_recurrence_counts_its_formula(mesh):
    """The sLSTM recurrence is one op in a fake run, counted by its
    formula: an xLSTM forward's FLOPs less the same forward with the
    recurrence's formula at 0 = 8·B·d·hd·S a layer."""
    cfg = reduced("xlstm-125m")
    shape = SHAPES["prefill"]
    spec = input_specs("xlstm-125m", shape, mesh, cfg_override=cfg)
    full = DR.run_program(spec)["cost"]["flops"]
    from torch.utils.flop_counter import flop_registry
    key = torch.ops.repro_torch.slstm_scan
    saved = flop_registry[key]
    flop_registry[key] = lambda *a, **k: 0
    try:
        spec = input_specs("xlstm-125m", shape, mesh, cfg_override=cfg)
        without = DR.run_program(spec)["cost"]["flops"]
    finally:
        flop_registry[key] = saved
    layers = cfg.n_layers // 2
    Bl = shape.global_batch // 2
    assert full - without == layers * X.slstm_scan_flops(
        Bl, shape.seq_len, cfg.d_model, cfg.n_heads)


def test_kernel_ops_fake_flops_and_sharding(mesh):
    """K2 and K3 in a fake run on DTensors: the op's fake outputs only
    (no ``[B, KV, G, S, S]`` scores of the plain version), the formula's
    FLOPs on the local heads, heads and channels over "model"."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch._subclasses.fake_tensor import FakeTensorMode
    ops.register_sharding_rules()
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    B, S, H, KV, hd = 4, 4096, 8, 4, 64
    pl = [Shard(0), Shard(2)]

    def dt(*shape, placements=pl, dtype=torch.bfloat16):
        from repro_torch.launch.specs import local_shape
        with fake:
            local = torch.empty(local_shape(shape, placements, mesh),
                                dtype=dtype)
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape,
                                                     device="meta").stride())

    q, k = dt(B, S, H, hd), dt(B, S, KV, hd)
    mem, flops = DR.MemoryTracker(), DR.flop_counter()
    with fake, DR._instrumented(), mem, flops:
        out = ops.flash_attention(q, k, k)
    assert out.placements == (Shard(0), Shard(2))
    assert flops.get_total_flops() == ops.flash_attention_flops(
        (B // 2, S, H // 4, hd), True, None)
    assert mem.peak == DR.rounded(B // 2 * S * H // 4 * hd * 2)
    xc = dt(B, S, 64, placements=pl, dtype=torch.float32)
    Bm = dt(B, S, 16, placements=[Shard(0), Replicate()],
            dtype=torch.float32)
    A = dt(64, 16, placements=[Replicate(), Shard(0)], dtype=torch.float32)
    D = dt(64, placements=[Replicate(), Shard(0)], dtype=torch.float32)
    with fake, DR._instrumented(), DR.flop_counter() as fc:
        y, h = ops.selective_scan(xc, xc, Bm, Bm, A, D)
    assert y.placements == (Shard(0), Shard(2))
    assert h.placements == (Shard(0), Shard(1))
    assert fc.get_total_flops() == 0


@pytest.mark.parametrize("kernel", ["flash_attention", "selective_scan",
                                    "slstm_scan"])
def test_recompute_backward_temporaries_are_tracked(kernel):
    """A dispatch mode never sees an op's body: the recompute backwards of
    K2, K3 and the sLSTM recurrence report theirs to the listening
    tracker.  Their forward and backward under a ``MemoryTracker`` on fake
    tensors (the backward op's fake implementation runs the recompute) and
    on real CPU tensors (the body) peak alike, and K2's peak holds its
    float32 ``[B, KV, G, S, S]`` scores."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if kernel == "flash_attention":
        B, S, H, KV, hd = 2, 96, 4, 2, 16
        shapes = [(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)]
        fn = ops.flash_attention_op
    elif kernel == "selective_scan":
        B, S, d, N = 2, 24, 8, 4
        shapes = [(B, S, d), (B, S, d), (B, S, N), (B, S, N), (d, N), (d,)]
        fn = ops.selective_scan_op
    else:
        B, S, d, H = 2, 6, 8, 2
        shapes = [(B, S, d)] * 4 + [(H, d // H, d // H)] * 4 + [(d,)] * 4

        def fn(*t):
            return X.slstm_scan_op(*t, H)

    def peak(make):
        args = [make(s).requires_grad_() for s in shapes]
        mem = DR.MemoryTracker()
        ops.BODY_TRACKER[0] = mem
        try:
            with mem:
                out = fn(*args, True, None) if kernel == "flash_attention" \
                    else fn(*args)
                outs = out if isinstance(out, tuple) else (out,)
                torch.autograd.grad(outs, args,
                                    [torch.ones_like(o) for o in outs])
        finally:
            ops.BODY_TRACKER[0] = None
        return mem.peak

    fake = FakeTensorMode()

    def fake_make(s):
        with fake:
            return torch.empty(s)
    real = peak(lambda s: torch.randn(s))
    assert peak(fake_make) == real
    if kernel == "flash_attention":
        assert real > DR.rounded(B * H * S * S * 4)


def test_cli_single_combination(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-125m", "--shape", "decode_32k", "--out", str(tmp_path),
         "--no-probe"], capture_output=True, text=True, env=env,
        timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    rec = json.loads((tmp_path / "xlstm-125m_decode_32k_16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert rec["cost"]["flops"] > 0
    assert set(rec["memory"]) >= {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes"}
