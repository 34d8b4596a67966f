"""K1 (fl_aggregate) in the port: its plain versions against the JAX
package's oracles over the sweep of tests/test_kernels.py, against the
Pallas kernel itself (interpret mode) on a subset, the NaN/Inf guard and
the CPU → plain-version dispatch.  The CUDA kernel against its plain version
is tests/test_torch_cuda.py (no JAX there, so it runs on the card's host).

The CUDA kernel's launch plan (``launch_plan``, a pure function of the
shape and the SM count) is checked here too: every element of g and of
every row is read by exactly one block, once, and every SM gets work at the
main path's shape.

Tolerances are tests/test_kernels.py's: fp32 2e-5, bf16 3e-2.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fl_aggregate import fl_aggregate as j_pallas
from repro_torch.fl.state import ParamLayout
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda, launch_plan

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
MODES = ("plain", "subset", "guarded")
# the K1 module itself: the package's ``fl_aggregate`` attribute is the
# dispatcher, as in ``repro.kernels``
k1 = importlib.import_module("repro_torch.kernels.fl_aggregate")


def inputs(K, M, seed=0):
    """g [M], d [K, M] normal; a 0/1 mask and row weights, from numpy."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(M).astype(np.float32)
    d = rng.standard_normal((K, M)).astype(np.float32)
    mask = (rng.uniform(size=K) < 0.5).astype(np.float32)
    weights = (mask * rng.uniform(0.5, 1.5, K) / K).astype(np.float32)
    return g, d, mask, weights


def run_port(mode, g, d, mask, weights, dtype, device="cpu"):
    tg = torch.from_numpy(g).to(device, TORCH[dtype])
    td = torch.from_numpy(d).to(device, TORCH[dtype])
    if mode == "plain":
        out = ops.fl_aggregate(tg, td, torch.from_numpy(mask).to(device))
    elif mode == "subset":
        out = ops.fl_aggregate_subset(tg, td,
                                      torch.from_numpy(mask).to(device),
                                      3 * d.shape[0])
    else:
        out = ops.fl_aggregate_guarded(tg, td,
                                       torch.from_numpy(weights).to(device))
    assert out.dtype == TORCH[dtype] and out.shape == tg.shape
    return out.float().cpu().numpy()


def run_jax_ref(mode, g, d, mask, weights, dtype):
    jg, jd = jnp.asarray(g, JAX[dtype]), jnp.asarray(d, JAX[dtype])
    if mode == "plain":
        out = jref.fl_aggregate_ref(jg, jd, jnp.asarray(mask))
    elif mode == "subset":
        out = jref.fl_aggregate_subset_ref(jg, jd, jnp.asarray(mask),
                                           3 * d.shape[0])
    else:
        out = jref.fl_aggregate_guarded_ref(jg, jd, jnp.asarray(weights))
    return np.asarray(out, np.float32)


def run_pallas(mode, g, d, mask, weights, dtype):
    jg, jd = jnp.asarray(g, JAX[dtype]), jnp.asarray(d, JAX[dtype])
    if mode == "plain":
        out = j_pallas(jg, jd, jnp.asarray(mask), interpret=True)
    elif mode == "subset":
        out = j_pallas(jg, jd, jnp.asarray(mask) / (3 * d.shape[0]),
                       interpret=True, denom=1)
    else:
        out = j_pallas(jg, jd, jnp.asarray(weights), interpret=True, denom=1,
                       guard=True)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("K", [1, 4, 16, 32])
@pytest.mark.parametrize("M", [128, 8192, 8193, 77])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_jax_refs(mode, K, M, dtype):
    args = inputs(K, M, seed=K * 1000 + M)
    np.testing.assert_allclose(run_port(mode, *args, dtype),
                               run_jax_ref(mode, *args, dtype), **TOL[dtype])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("M", [77, 8193])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_pallas_kernel(mode, M, dtype):
    args = inputs(4, M, seed=M)
    np.testing.assert_allclose(run_port(mode, *args, dtype),
                               run_pallas(mode, *args, dtype), **TOL[dtype])


def poisoned(M):
    g, d, _, _ = inputs(4, M)
    d[1] = np.nan
    d[2, 0] = np.inf
    d[3, -1] = -np.inf
    return g, d, np.array([0.25, 0.0, 0.25, 0.0], np.float32)


@pytest.mark.parametrize("M", [128, 8193, 77])
def test_guard_zeroes_nonfinite(M):
    g, d, w = poisoned(M)
    out = ops.fl_aggregate_guarded(torch.from_numpy(g), torch.from_numpy(d),
                                   torch.from_numpy(w)).numpy()
    assert np.isfinite(out).all()
    want = jref.fl_aggregate_guarded_ref(jnp.asarray(g), jnp.asarray(d),
                                         jnp.asarray(w))
    np.testing.assert_allclose(out, np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("mode", ["plain", "subset"])
def test_unguarded_modes_propagate_nan(mode):
    """Without the guard a poisoned row reaches the output even with weight
    0 (0 · NaN = NaN): the regression that makes quarantine necessary."""
    g = torch.zeros(128)
    d = torch.zeros(2, 128)
    d[0] = torch.nan
    m = torch.tensor([0.0, 1.0])
    out = (ops.fl_aggregate(g, d, m) if mode == "plain"
           else ops.fl_aggregate_subset(g, d, m, 2))
    assert torch.isnan(out).all()


def test_zero_mask_is_identity():
    g = torch.arange(300.0)
    out = ops.fl_aggregate(g, torch.ones(8, 300), torch.zeros(8))
    assert torch.equal(out, g)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    calls = []
    monkeypatch.setattr(ops, "fl_aggregate_cuda",
                        lambda *a, **k: calls.append(a))
    before = fl_aggregate_cuda.launches
    g, d, mask, weights = (torch.from_numpy(a) for a in inputs(4, 77))
    assert torch.equal(ops.fl_aggregate(g, d, mask),
                       ref.fl_aggregate_ref(g, d, mask))
    assert torch.equal(ops.fl_aggregate_subset(g, d, mask, 8),
                       ref.fl_aggregate_subset_ref(g, d, mask, 8))
    assert torch.equal(ops.fl_aggregate_guarded(g, d, weights),
                       ref.fl_aggregate_guarded_ref(g, d, weights))
    assert calls == [] and fl_aggregate_cuda.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    g, d, mask, _ = (torch.from_numpy(a) for a in inputs(4, 77))
    with pytest.raises(ValueError, match="CUDA"):
        fl_aggregate_cuda(g, d, mask, 0.25)


def test_other_devices_are_refused():
    g = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        ops.fl_aggregate(g, torch.zeros(2, 4, device="meta"),
                         torch.zeros(2, device="meta"))


def test_param_layout_rows_are_16_byte_aligned():
    params = [{"w": torch.zeros(784, 200), "b": torch.zeros(200)},
              {"w": torch.zeros(200, 10), "b": torch.zeros(10)}]
    layout = ParamLayout.of(params)
    # 784·200 + 200 + 200·10 + 10 (the JAX docstring says 199,210)
    assert layout.size == 159_010 and layout.width == 159_012
    assert [e[1] for e in layout.entries] == ["b", "w", "b", "w"]


def walk(plan, R, M):
    """The column ranges each of the R + 1 slices (g, then the rows) is
    read in, block by block, as the kernel walks its tiles and stages."""
    reads = [[] for _ in range(R + 1)]
    for block in range(plan.grid):
        for t in range(block, plan.tiles, plan.grid):
            m0 = t * plan.tile
            tw = min(plan.tile, M - m0)
            assert 0 < tw <= k1.CONSUMERS * k1.MAX_COLS
            for q in range(1 + plan.direct):          # g and the direct rows
                reads[q].append((m0, m0 + tw))
            for r0 in range(plan.direct, R, plan.rows):
                for r in range(r0, min(r0 + plan.rows, R)):
                    reads[1 + r].append((m0, m0 + tw))
    return reads


@pytest.mark.parametrize("R", [1, 7, 10, 11, 12, 64, 65, 100, 1000])
@pytest.mark.parametrize("M", [1, 77, 8193, 159_012, 199_210, 600_001,
                               1_200_000_000])
@pytest.mark.parametrize("elem", [4, 2])
def test_launch_plan_reads_every_element_once(R, M, elem):
    plan = launch_plan(R, M, elem, 132)
    vec = 16 // elem
    assert plan.tile % vec == 0 and plan.tile * elem >= k1.MIN_SLICE
    assert (plan.tiles - 1) * plan.tile < M <= plan.tiles * plan.tile
    assert 1 <= plan.grid <= min(plan.tiles, 132)
    assert plan.direct in (0, R) and plan.direct <= k1.DIRECT_MAX
    assert 1 <= plan.rows <= k1.ROWS_MAX
    assert 1 <= plan.stages <= k1.MAX_STAGES
    assert plan.slot_bytes >= plan.tile * elem + 16 and plan.slot_bytes % 16 == 0
    assert plan.smem <= k1.MAX_SMEM
    if plan.direct < R:        # a ring in use holds two stages at least
        assert plan.stages >= 2
    if M * R > 10 ** 9:        # the dense walk below is for sizes a test takes
        return
    for q, ranges in enumerate(walk(plan, R, M)):
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == M, q
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:])), q


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("R", [10, 64, 1000])
def test_every_sm_gets_work_at_the_main_shape(sms, R):
    """M = 159,012 fp32: one tile a block, as wide as 16-byte multiples
    allow, so no SM streams more than a vector more than its share."""
    M = 159_012
    plan = launch_plan(R, M, 4, sms)
    assert plan.grid == plan.tiles == sms
    share = -(-M // sms)
    assert share <= plan.tile < share + 4


def test_launch_plan_balances_blocks_that_walk_several_tiles():
    plan = launch_plan(100, 600_001, 4, 132)
    per_block = [len(range(b, plan.tiles, plan.grid))
                 for b in range(plan.grid)]
    assert plan.grid == 132 and min(per_block) == max(per_block) == 3


@pytest.mark.parametrize("args", [(-1, 10, 4, 132), (10, 0, 4, 132),
                                  (10, 10, 8, 132), (10, 10, 4, 0)])
def test_launch_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError, match="no plan"):
        launch_plan(*args)
