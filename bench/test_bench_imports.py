"""What the benchmark loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (each compared whole, so ``repro_torch``
passes) in a process that drives a cell's run, and a reference that
imports nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

DRIVE = """
import json, sys, time
sys.path[:0] = [{bench!r}, {src!r}]
from fedbench import harness, spec
from fedbench.cpu_threads import share_cores
share_cores()
cell = spec.cell("mlp_sparse_k1m")
cell.traffic = dict(cell.traffic, clients=32, examples_per_client=8,
                    rounds=2, eval_batch=16, p=0.1)
out = harness.run_cell(cell, 5, 0.0, False, ["cpu"], time.time())
print(json.dumps({{"correct": out["correct"],
                  "banned": harness.banned_modules(),
                  "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_no_jax_in_a_run():
    code = DRIVE.format(bench=str(BENCH), src=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["banned"] == []
    assert "repro_torch" in out["tops"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(out["tops"])


def test_banned_names_are_whole():
    sys.path.insert(0, str(BENCH))
    from fedbench import harness
    assert "repro" in harness.BANNED
    before = dict(sys.modules)
    try:
        sys.modules["repro_torch_x"] = sys.modules[__name__]
        assert "repro_torch_x" not in harness.banned_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(before)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    ref = [BENCH / "fedbench" / f for f in ("reference.py", "threefry.py",
                                            "compare.py", "world.py")]
    ref += sorted((BENCH / "configs").glob("*.py"))
    for path in ref:
        assert not _imports(path) & {"repro_torch", "repro", "jax",
                                     "jaxlib", "flax"}, path
