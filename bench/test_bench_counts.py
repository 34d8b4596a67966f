"""The benchmark's own counts at known shapes: parameters and FLOPs of the
configuration, K1's bytes by mode, the samples the MFU counts, the
readers of the spans and of the trace, and the trace's interval
arithmetic."""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from fedbench.cpu_threads import share_cores  # noqa: E402

share_cores()

from fedbench import compare, peaks, spec, trace  # noqa: E402


@pytest.fixture(scope="module")
def cells():
    return {n: spec.cell(n) for n in ("mlp_dense_k10k", "mlp_sparse_k1m",
                                      "mlp_dense_k40k_x4")}


@pytest.mark.parametrize("name,params,flops", [
    ("mlp_dense_k10k", 159_010, 2 * (784 * 200 + 200 * 10)),
])
def test_parameters_and_flops(cells, name, params, flops):
    cell = cells[name]
    layers = cell.config["layers"]
    assert sum(math.prod(s) for l in layers for s in l.values()) == params
    assert cell.config["parameters"] == params
    assert cell.model.forward_flops(cell.config) == flops


def test_flops_match_the_reference_forward(cells):
    """The counted forward FLOPs are the products the reference runs: one
    sample through the configuration under FlopCounterMode."""
    from torch.utils.flop_counter import FlopCounterMode
    cell = cells["mlp_dense_k10k"]
    layers = [{k: torch.zeros((1,) + tuple(s)) for k, s in l.items()}
              for l in cell.config["layers"]]
    x = torch.zeros((1, 1) + tuple(cell.config["input_shape"]))
    with FlopCounterMode(display=False) as fc:
        cell.model.forward(layers, x)
    assert fc.get_total_flops() == cell.model.forward_flops(cell.config)


def _ctx(cell, n_tx_runs, blocks=1, k1=None, kernels=None, spans=None,
         window=2.0):
    runs = [{"n_tx": np.asarray(n)} for n in n_tx_runs]
    rounds = sum(len(n) for n in n_tx_runs)
    return {"config": cell.config, "traffic": cell.traffic,
            "model": cell.model, "runs": runs, "rounds": rounds,
            "window_s": window, "spans": spans or {}, "k1": k1 or {},
            "blocks": blocks, "width": 159_012, "devices": list(range(blocks)),
            "trace": {"kernels": kernels or {}, "window_s": window,
                      "busy_s": {d: 1.5 for d in range(blocks)}}}


def test_k1_bytes_by_mode(cells):
    k1 = cells["mlp_dense_k10k"].readers["k1_roofline_pct"]
    M = 159_012
    assert k1.launch_bytes(10, M) == (10 * M + 2 * M) * 4 + 40
    # plain: every round one launch over all K rows
    ctx = _ctx(cells["mlp_dense_k10k"], [[3, 0, 7]])
    assert k1.launches(ctx) == [("plain", 10_000)] * 3
    # sparse: the real transmitters of each round, not the bucket
    ctx = _ctx(cells["mlp_sparse_k1m"], [[998, 1003], [1010]])
    assert k1.launches(ctx) == [("subset", 998), ("subset", 1003),
                                ("subset", 1010)]
    # placed: one launch a card a round over its K/d rows
    ctx = _ctx(cells["mlp_dense_k40k_x4"], [[1, 2]], blocks=4)
    assert k1.launches(ctx) == [("subset", 10_000)] * 8


def test_k1_roofline_reads_the_trace(cells):
    cell = cells["mlp_dense_k10k"]
    k1 = cell.readers["k1_roofline_pct"]
    need = 2 * k1.launch_bytes(10_000, 159_012)
    t = need / peaks.HBM_BYTES_PER_S / 0.9       # at 90 % of the bound
    ctx = _ctx(cell, [[1, 2]], k1={"launches": 2, "subset": 0, "guarded": 0},
               kernels={"void fl_aggregate_tma<float, false>(...)": t,
                        "elementwise": 5.0})
    assert k1.read(ctx) == pytest.approx(90.0)
    # counters that disagree with the runs, or no kernel in the trace
    ctx["k1"]["launches"] = 3
    assert k1.read(ctx) is None
    ctx["k1"]["launches"] = 2
    ctx["trace"]["kernels"] = {}
    assert k1.read(ctx) is None


def test_mfu_counts_samples(cells):
    dense, sparse = cells["mlp_dense_k10k"], cells["mlp_sparse_k1m"]
    mfu = dense.readers["mfu_pct"]
    ctx = _ctx(dense, [[5] * 20])
    assert mfu.samples(ctx) == 20 * 10_000 * 50
    flops = 3 * 317_600 * mfu.samples(ctx)
    assert mfu.read(ctx) == pytest.approx(
        100 * flops / 2.0 / peaks.FP32_FLOPS)
    ctx = _ctx(sparse, [[1000, 990], [1001]])
    assert mfu.samples(ctx) == (1000 + 990 + 1001) * 50


def test_span_and_idle_readers(cells):
    cell = cells["mlp_sparse_k1m"]
    ctx = _ctx(cell, [[1] * 50, [1] * 50],
               spans={"sparse.phase_a": 0.2, "sparse.train": 5.0})
    assert cell.readers["sparse_phase_a_ms"].read(ctx) == pytest.approx(2.0)
    assert cell.readers["sparse_train_ms"].read(ctx) == pytest.approx(50.0)
    assert cell.readers["device_idle_pct"].read(ctx) == pytest.approx(25.0)
    ctx["spans"] = {}
    assert cell.readers["sparse_phase_a_ms"].read(ctx) is None
    ctx["trace"] = {}
    assert cell.readers["device_idle_pct"].read(ctx) is None


def test_trace_intervals():
    assert trace._merge([(5, 7), (0, 2), (1, 3), (7, 9)]) == [[0, 3],
                                                            [5, 9]]
    cpu = [(0, 10, "a"), (1, 3, "b"), (5, 7, "c")]
    assert trace._innermost(cpu, [0.5, 2, 4, 6, 8, 11]) == [
        "a", "b", "a", "c", "a", "host: no operation"]
    assert trace.top({"x": 1.0, "y": 3.0, "z": 2.0}, 2) == [["y", 3.0],
                                                           ["z", 2.0]]


def test_decode_encode_round_trip(cells):
    layers = cells["mlp_dense_k10k"].config["layers"]
    leaves = [{k: torch.randn((2,) + tuple(s)) for k, s in l.items()}
              for l in layers]
    row = compare.encode(leaves, layers)
    assert row.shape == (2, 159_012)
    assert torch.count_nonzero(row[:, 159_010:]) == 0
    back = compare.decode(row, layers)
    for a, b in zip(leaves, back):
        for k in a:
            assert torch.equal(a[k], b[k].to(torch.float32))


def test_split_metrics_share_their_reader(cells):
    """The four-card cell reports its own end-to-end rate and the per-layer
    parts split from it (``<m>.x4``), each read by ``<m>``'s reader; the
    one-card cells report neither."""
    placed, dense = cells["mlp_dense_k40k_x4"], cells["mlp_dense_k10k"]
    assert [m["name"] for m in placed.end_to_end] == [
        "rounds_per_s.x4", "peak_mem_gb", "setup_s"]
    assert {m["name"]: m["moves"] for m in placed.per_layer} == {
        "k1_roofline_pct.x4": "rounds_per_s.x4",
        "mfu_pct.x4": "rounds_per_s.x4",
        "device_idle_pct.x4": "rounds_per_s.x4"}
    for name, reader in placed.readers.items():
        assert reader.__file__ == dense.readers[spec.base(name)].__file__
    assert "rounds_per_s.x4" not in {m["name"] for m in dense.end_to_end}
    ctx = _ctx(placed, [[1, 2]], blocks=4)
    assert placed.readers["device_idle_pct.x4"].read(ctx) == \
        pytest.approx(25.0)
