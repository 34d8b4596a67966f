"""The readers of the sparse run's phase spans, found by name from
BENCHMARK.json as the harness finds them: each one's value a round on a
hand-made context, and ``None`` when its span is absent."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from fedbench.cpu_threads import share_cores  # noqa: E402

share_cores()

from fedbench import spec  # noqa: E402

#: metric -> the span entry it reads
READS = {"sparse_gather_ms": "sparse.gather.device",
         "sparse_phase_b_ms": "sparse.phase_b.device",
         "sparse_densify_ms": "sparse.densify"}


@pytest.fixture(scope="module")
def cell():
    return spec.cell("mlp_sparse_k1m")


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_gives_ms_a_round(cell, name):
    # two runs of T 50 in the window: 100 rounds
    ctx = {"rounds": 100, "spans": {"sparse.train": 5.0, READS[name]: 0.25}}
    assert cell.readers[name].read(ctx) == pytest.approx(2.5)


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_is_none_without_its_span(cell, name):
    spans = {"sparse.phase_a": 0.2, "sparse.train": 5.0,
             "sparse.train.device": 4.9}
    assert cell.readers[name].read({"rounds": 100, "spans": spans}) is None
    # a span left over from before the window reads 0 in it
    spans[READS[name]] = 0.0
    assert cell.readers[name].read({"rounds": 100, "spans": spans}) is None
    assert cell.readers[name].read({"rounds": 0, "spans": {
        READS[name]: 0.25}}) is None


def test_the_dense_cells_do_not_report_them():
    for name in ("mlp_dense_k10k", "mlp_dense_k40k_x4"):
        assert not set(READS) & set(spec.cell(name).readers)
