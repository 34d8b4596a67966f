"""The port held against the benchmark's plain reference at a tiny K on
the CPU, through the harness's own run (set-up, window, check), for both
engines and the placed client axis; each number
under the cell's own limit."""
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from fedbench.cpu_threads import share_cores  # noqa: E402

share_cores()

from fedbench import harness, spec  # noqa: E402

#: tiny traffic a cell's run takes on the CPU, the configuration's widths
#: and local SGD unchanged
TINY = {
    "mlp_dense_k10k": dict(clients=16, examples_per_client=8, rounds=3,
                           p=0.3),
    "mlp_sparse_k1m": dict(clients=64, examples_per_client=8, rounds=3,
                           p=0.1),
    "mlp_dense_k40k_x4": dict(clients=8, examples_per_client=8, rounds=2,
                              p=1.0),
}


def tiny_cell(name: str):
    cell = spec.cell(name)
    cell.traffic = dict(cell.traffic, eval_every=1, eval_batch=64,
                        sample_clients=4, **TINY[name])
    cell.config = dict(cell.config, reference_block=3)
    return cell


def placed_over_cpu(monkeypatch, cell):
    """A four-card cell's placement over four CPU blocks (the port's
    placement over a repeated device): its rule picks no placement on the
    CPU."""
    import repro_torch.fl.engine as engine
    from repro_torch.fl.placement import ClientPlacement
    monkeypatch.setattr(engine, "_client_mesh", lambda K, device=None:
                        ClientPlacement(("cpu",) * 4, K))
    return ["cpu"] * cell.chips


def run(cell, devices, seed=2**31 + 77):
    return harness.run_cell(cell, seed, 0.0, False, devices, time.time())


@pytest.mark.parametrize("name", sorted(TINY))
def test_port_matches_reference(monkeypatch, name):
    cell = tiny_cell(name)
    devices = (placed_over_cpu(monkeypatch, cell) if cell.chips > 1
               else ["cpu"])
    out = run(cell, devices)
    assert out["correct"], out["check"]
    assert set(out["check"]) == set(cell.limits)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(out)[-1] == "check"
