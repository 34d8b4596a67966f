"""The port's dry-run cost probes (``repro_torch.launch.dryrun.
cost_probes``) on a fabricated 2×4 world: for one reduced config per mixer
family and each program kind, with R = 2 super-blocks, the probes' total
(JAX's ``M1 + (R−1)(M2 − M1)``) = the full-depth count, FLOPs and
collective bytes.  The port runs eagerly, so unlike XLA's scan-once count
the full depth is counted whole and the two must agree exactly.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import pytest

from repro_torch import configs
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as M
from repro_torch.launch.specs import input_specs
from repro_torch.models.costmode import cost_probe
from test_torch_dryrun import REDUCED, SHAPES, reduced


@pytest.fixture(scope="module")
def mesh():
    M.fabricate_world(8)
    yield M.make_mesh((2, 4), ("data", "model"))
    M.close_world()


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", list(REDUCED))
def test_cost_probe_total_equals_full_depth(mesh, arch, kind):
    """R = 2 super-blocks: the probes' total = the full program's count,
    both under ``cost_probe()`` (outside it, the sequence-parallel hint
    at super-block boundaries moves work between devices, as in JAX)."""
    sb = len(configs.get(arch).mixer_pattern)
    cfg = reduced(arch, layers=2 * sb)
    assert cfg.n_repeats == 2
    probe = DR.cost_probes(arch, SHAPES[kind], mesh, "-", cfg_override=cfg)
    with cost_probe():
        full = DR.run_program(input_specs(arch, SHAPES[kind], mesh,
                                          cfg_override=cfg))
    assert probe["total"]["flops"] == full["cost"]["flops"]
    assert probe["total"]["collective_bytes"] == \
        full["collectives"]["total_bytes"]


