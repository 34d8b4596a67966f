"""The check catches a broken program: each cell's tiny CPU run (the
harness's set-up, window and check, the look for a card skipped) with the
timed path broken underneath reads ``correct`` false, once for each fault
the cell can have: a local SGD that returns its state unchanged, half of
each batch left out (the mean over the rest), the exchange between cards
left out (a placed cell: only the first card's partial sum of eq. 3), and
an answer altered where it is produced (the eq.-5 Joules of one client)."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from fedbench.cpu_threads import share_cores  # noqa: E402

share_cores()

from test_bench_port import TINY, placed_over_cpu, run, tiny_cell  # noqa: E402


def _local_train(monkeypatch, wrap):
    """Replace the port's local SGD, in the dense engine and in the sparse
    engine's phase B (whose cache of built programs is emptied)."""
    import repro_torch.fl.engine as engine
    import repro_torch.fl.sparse as sparse
    real = engine.make_local_train

    def make(loss_fn, opt):
        return wrap(real(loss_fn, opt))

    monkeypatch.setattr(engine, "make_local_train", make)
    monkeypatch.setattr(sparse, "make_local_train", make)
    monkeypatch.setattr(sparse, "_TRAIN_CACHE", {})


def unchanged(monkeypatch):
    _local_train(monkeypatch, lambda train: lambda flat, xb, yb, lay: flat)


def half_batch(monkeypatch):
    def wrap(train):
        def half(flat, xb, yb, layout):
            b = xb.shape[2] // 2
            return train(flat, xb[:, :, :b], yb[:, :, :b], layout)
        return half
    _local_train(monkeypatch, wrap)


def no_exchange(monkeypatch):
    import repro_torch.fl.state as state

    def first_card_only(global_params, deltas, weights, launch):
        return launch(global_params, deltas[0], deltas.slices(weights)[0])

    monkeypatch.setattr(state, "_block_sums", first_card_only)


def altered_answer(monkeypatch):
    import repro_torch.fl.engine as engine
    import repro_torch.fl.sparse as sparse
    real = engine.apply_round_decision

    def decide(*args, **kw):
        mask, forced, w, e = real(*args, **kw)
        e = e.clone()
        e[..., 0] = e[..., 0] * 1.001 + 1e-3
        return mask, forced, w, e

    monkeypatch.setattr(engine, "apply_round_decision", decide)
    monkeypatch.setattr(sparse, "apply_round_decision", decide)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "no_exchange": no_exchange, "altered_answer": altered_answer}
CASES = [(name, fault) for name in sorted(TINY) for fault in FAULTS
         if fault != "no_exchange" or name.endswith("_x4")]


@pytest.mark.parametrize("name,fault", CASES)
def test_broken_program_is_not_correct(monkeypatch, name, fault):
    cell = tiny_cell(name)
    devices = (placed_over_cpu(monkeypatch, cell) if cell.chips > 1
               else ["cpu"])
    FAULTS[fault](monkeypatch)
    out = run(cell, devices)
    assert out["correct"] is False, out["check"]
    assert out["failed"] == 1
