"""K1 on the card: the hand-written CUDA kernel for eq. (3)
(``csrc/fl_aggregate.cu``), replacing the Pallas TPU kernel
``repro.kernels.fl_aggregate``.

:func:`fl_aggregate_cuda` computes ``out = g + inv_k · Σ_r w_r · δ_r`` on
CUDA tensors; :mod:`.ops` folds its three modes into ``w``, ``inv_k`` and
``guard``.  It checks its inputs and raises on anything the kernel does not
take; it never falls back to the plain version.  :func:`launch_plan` is the
kernel's tiling of M over the card's SMs, a pure function of the shape.
The library is built and loaded on the first call, never at import, so the
module imports on a host without CUDA.  ``fl_aggregate_cuda.launches``
counts the launches, ``fl_aggregate_cuda.guarded_launches`` those of them in
the weighted (guarded) mode, ``guard=True``, and
``fl_aggregate_cuda.subset_launches`` those in the subset mode,
``subset=True`` (the same kernel: the flag only names the mode).
``fl_aggregate_cuda.shapes`` collects the ``(mode, dtype, R, M)`` of the
launches, so a caller can check that every shape it ran was held against
the plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ._build import BuiltLibrary, build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_library: list[BuiltLibrary] = []

# The kernel's limits (csrc/fl_aggregate.cu): 256 consumer threads holding
# up to 8 columns each, up to 11 rows loaded directly, stages of up to 16
# rows, a ring of at most 64 stages behind 1 KB of mbarriers, 227 KB of
# shared memory a block.
CONSUMERS = 256
MAX_COLS = 8
DIRECT_MAX = 11
ROWS_MAX = 16
MAX_STAGES = 64
RING_OFFSET = 1024
MAX_SMEM = 232_448
MIN_SLICE = 512          # bytes: the narrowest row slice a tile copies
STAGE_BYTES = 48 * 1024  # what a stage of the ring holds at most
RING_BYTES = 100 * 1024  # what the ring aims to hold (two stages at least)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the kernel cuts ``[R, M]``: tiles of ``tile`` columns (the last
    may be narrower), ``grid`` blocks walking tiles ``b, b + grid, …``; the
    first ``direct`` rows of a tile loaded by the consumers themselves, the
    rest through a ring of ``stages`` stages of ``rows`` row slices, each
    slice in ``slot_bytes`` of shared memory."""
    tile: int
    tiles: int
    grid: int
    direct: int
    rows: int
    stages: int
    slot_bytes: int

    @property
    def smem(self) -> int:
        return RING_OFFSET + self.stages * self.rows * self.slot_bytes


@functools.lru_cache(maxsize=256)
def launch_plan(R: int, M: int, elem: int, sms: int) -> LaunchPlan:
    """The plan for ``R`` rows of ``M`` elements of ``elem`` bytes on a card
    with ``sms`` SMs.  Each block takes the same number of tiles, and the
    tiles are as even as 16-byte multiples allow, so every SM streams the
    same bytes; a tile is at most ``CONSUMERS · MAX_COLS`` columns and its
    row slice at least ``MIN_SLICE`` bytes.  Up to ``DIRECT_MAX`` rows the
    consumers load every row themselves, all at once, and the ring is
    unused; above it every row goes through the ring, in stages of at most
    ``STAGE_BYTES`` and ``ROWS_MAX`` rows, about ``RING_BYTES`` of them and
    two at least (more stages in flight measured slower, not faster)."""
    if R < 0 or M <= 0 or elem not in (2, 4) or sms <= 0:
        raise ValueError(f"no plan for R={R}, M={M}, elem={elem}, "
                         f"sms={sms}")
    vec = 16 // elem
    max_tile = CONSUMERS * MAX_COLS
    per_block = -(-M // (sms * max_tile))
    tile = -(-M // (sms * per_block))
    tile = min(max(-(-tile // vec) * vec, MIN_SLICE // elem), max_tile)
    tiles = -(-M // tile)
    slot_bytes = tile * elem + 16
    if R <= DIRECT_MAX:          # no ring: every row loaded directly
        direct, rows, stages = R, 1, 1
    else:                        # every row through the ring
        direct = 0
        rows = max(1, min(ROWS_MAX, R, STAGE_BYTES // slot_bytes))
        stages = max(2, min(MAX_STAGES, RING_BYTES // (rows * slot_bytes)))
    return LaunchPlan(tile=tile, tiles=tiles, grid=min(tiles, sms),
                      direct=direct, rows=rows, stages=stages,
                      slot_bytes=slot_bytes)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def library() -> BuiltLibrary:
    """The built and bound kernel library (built on the first call)."""
    if not _library:
        built = build("fl_aggregate")
        fn = built.lib.fl_aggregate_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _library.append(built)
    return _library[0]


def fl_aggregate_cuda(global_p: torch.Tensor, deltas: torch.Tensor,
                      weights: torch.Tensor, inv_k: float,
                      guard: bool = False,
                      subset: bool = False) -> torch.Tensor:
    """``global_p: [M]``, ``deltas: [R, M]`` (same dtype, float32 or
    bfloat16, contiguous, on one CUDA device), ``weights: [R]`` → ``[M]``
    in ``global_p``'s dtype."""
    if global_p.device.type != "cuda":
        raise ValueError(f"fl_aggregate_cuda needs CUDA tensors, got "
                         f"{global_p.device}")
    if deltas.device != global_p.device or weights.device != global_p.device:
        raise ValueError("global_p, deltas and weights must share a device")
    if global_p.dtype not in _DTYPES or deltas.dtype != global_p.dtype:
        raise TypeError(f"fl_aggregate_cuda takes float32 or bfloat16 "
                        f"global_p and deltas of the same dtype, got "
                        f"{global_p.dtype} and {deltas.dtype}")
    if global_p.dim() != 1 or deltas.dim() != 2 or weights.dim() != 1:
        raise ValueError("expected global_p [M], deltas [R, M], weights [R]")
    R, M = deltas.shape
    if global_p.shape[0] != M or weights.shape[0] != R:
        raise ValueError(f"shape mismatch: global_p {tuple(global_p.shape)}, "
                         f"deltas {(R, M)}, weights {tuple(weights.shape)}")
    if not (global_p.is_contiguous() and deltas.is_contiguous()):
        raise ValueError("global_p and deltas must be contiguous")
    if R >= 2 ** 31:
        raise ValueError(f"too many rows: {R}")
    out = torch.empty_like(global_p)
    if M == 0:
        return out
    w32 = weights.to(torch.float32).contiguous()
    plan = launch_plan(R, M, global_p.element_size(),
                       _sm_count(global_p.device.index))
    fn = library().lib.fl_aggregate_launch
    with torch.cuda.device(global_p.device):
        rc = fn(global_p.data_ptr(), deltas.data_ptr(), w32.data_ptr(),
                out.data_ptr(), R, M, float(inv_k), _DTYPES[global_p.dtype],
                int(bool(guard)), plan.tile, plan.tiles, plan.grid,
                plan.direct, plan.rows, plan.stages, plan.slot_bytes,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fl_aggregate kernel launch failed: CUDA error "
                           f"{rc}")
    fl_aggregate_cuda.launches += 1
    fl_aggregate_cuda.guarded_launches += bool(guard)
    fl_aggregate_cuda.subset_launches += bool(subset)
    fl_aggregate_cuda.shapes.add(
        ("guarded" if guard else "subset" if subset else "plain",
         str(global_p.dtype).removeprefix("torch."), R, M))
    return out


fl_aggregate_cuda.launches = 0
fl_aggregate_cuda.guarded_launches = 0
fl_aggregate_cuda.subset_launches = 0
fl_aggregate_cuda.shapes = set()
