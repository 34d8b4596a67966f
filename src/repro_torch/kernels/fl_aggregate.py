"""K1 on the card: the hand-written CUDA kernel for eq. (3)
(``csrc/fl_aggregate.cu``), replacing the Pallas TPU kernel
``repro.kernels.fl_aggregate``.

:func:`fl_aggregate_cuda` computes ``out = g + inv_k · Σ_r w_r · δ_r`` on
CUDA tensors; :mod:`.ops` folds its three modes into ``w``, ``inv_k`` and
``guard``.  It checks its inputs and raises on anything the kernel does not
take; it never falls back to the plain version.  The library is built and
loaded on the first call, never at import, so the module imports on a host
without CUDA.  ``fl_aggregate_cuda.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import BuiltLibrary, build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_library: list[BuiltLibrary] = []


def library() -> BuiltLibrary:
    """The built and bound kernel library (built on the first call)."""
    if not _library:
        built = build("fl_aggregate")
        fn = built.lib.fl_aggregate_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _library.append(built)
    return _library[0]


def fl_aggregate_cuda(global_p: torch.Tensor, deltas: torch.Tensor,
                      weights: torch.Tensor, inv_k: float,
                      guard: bool = False) -> torch.Tensor:
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
    # 16-byte vector path only when every row starts 16-byte aligned
    vec = (all(t.data_ptr() % 16 == 0 for t in (global_p, deltas, out))
           and (M * global_p.element_size()) % 16 == 0)
    fn = library().lib.fl_aggregate_launch
    with torch.cuda.device(global_p.device):
        rc = fn(global_p.data_ptr(), deltas.data_ptr(), w32.data_ptr(),
                out.data_ptr(), R, M, float(inv_k), _DTYPES[global_p.dtype],
                int(bool(guard)), int(vec),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fl_aggregate kernel launch failed: CUDA error "
                           f"{rc}")
    fl_aggregate_cuda.launches += 1
    return out


fl_aggregate_cuda.launches = 0
