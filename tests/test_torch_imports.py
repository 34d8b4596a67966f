"""The port stands alone: no module of src/repro_torch, no example of the
port (examples/*_torch.py), no script of tools/ and not chip_smoke.py
imports JAX or the JAX package (``repro``)."""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + sorted(
    (REPO / "examples").glob("*_torch.py")) + sorted(
    (REPO / "tools").glob("*.py")) + [REPO / "chip_smoke.py"]


def forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_the_check_sees_the_whole_port():
    names = {p.name for p in FILES}
    assert {"random.py", "engine.py", "ops.py", "chip_smoke.py",
            "flash_attention.py", "attention.py", "transformer.py",
            "generate.py", "telemetry.py", "llama3_2_1b.py",
            "selective_scan.py", "mamba.py", "moe.py", "fractional.py",
            "convergence.py", "faults.py", "algorithm1.py",
            "selection.py", "sparse.py", "device.py", "schemes.py",
            "server.py", "replay.py", "train.py", "batcher.py", "loadgen.py",
            "quickstart_torch.py", "mnist_fl_schemes_torch.py",
            "cnn_sensitivity.py", "mesh.py", "sharding.py", "specs.py",
            "dryrun.py", "costmode.py", "pshard.py"} <= names
    assert forbidden("jax.numpy") and forbidden("repro.fl")
    assert not forbidden("repro_torch.fl")
