"""Discovery by name: in a copy of the benchmark, a new traffic mix, a new
configuration, a new per-layer metric and a new cell are found from their
files and their entries in BENCHMARK.json, with no file of the harness
edited, and the new cell runs."""
import json
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from fedbench.cpu_threads import share_cores  # noqa: E402

share_cores()

from fedbench import harness, spec  # noqa: E402

METRIC = '''"""rounds_seen: the rounds the traced window completed."""


def read(ctx):
    return float(ctx["rounds"]) if ctx["rounds"] else None
'''


def test_new_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root)
    harness_files = {p: p.read_bytes()
                     for p in (root / "bench").rglob("*.py")}
    b = root / "bench"
    traffic = json.loads((b / "traffic" / "dense_k10k.json").read_text())
    traffic.update(clients=12, examples_per_client=8, rounds=2,
                   eval_batch=32, sample_clients=3, p=0.5)
    (b / "traffic" / "dense_tiny.json").write_text(json.dumps(traffic))
    for ext in ("json", "py"):
        shutil.copy(b / "configs" / f"mlp_784_200_10.{ext}",
                    b / "configs" / f"mlp_copy.{ext}")
    (b / "limits" / "mlp_copy_tiny.json").write_text(
        (b / "limits" / "mlp_dense_k10k.json").read_text())
    (b / "metrics" / "rounds_seen.py").write_text(METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="mlp_copy",
                                 file="bench/configs/mlp_copy.json"))
    bench["workloads"].append({"name": "mlp_copy_tiny", "config": "mlp_copy",
                               "traffic": "dense_tiny", "chips": 1,
                               "why": "a cell added by files alone"})
    bench["per_layer"].append({"name": "rounds_seen", "unit": "rounds",
                               "better": "higher", "source": "host_clock",
                               "layer": "the whole round",
                               "moves": "rounds_per_s",
                               "workloads": ["mlp_copy_tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("mlp_copy_tiny", root=root)
    assert cell.traffic["clients"] == 12
    assert cell.config["parameters"] == 159_010
    assert cell.model.forward_flops(cell.config) == 317_600
    assert "rounds_seen" in cell.readers
    assert cell.readers["rounds_seen"].read({"rounds": 4}) == 4.0
    old = spec.cell("mlp_dense_k10k", root=root)
    assert "rounds_seen" not in old.readers
    assert {m["name"] for m in old.per_layer} == {
        "k1_roofline_pct", "mfu_pct", "device_idle_pct"}
    out = harness.run_cell(cell, 3, 0.0, False, ["cpu"], time.time())
    assert out["correct"], out["check"]
    assert harness_files == {p: p.read_bytes() for p in harness_files}
