"""K3 on the card: the hand-written CUDA kernel for the Mamba S6 selective
scan (``csrc/selective_scan.cu``), replacing the Pallas TPU kernel
``repro.kernels.selective_scan``.

:func:`selective_scan_cuda` takes ``xc``, ``dt [B,S,d]`` (float32 or
bfloat16, each on its own), ``Bm``, ``Cm [B,S,N]`` float32, ``A [d,N]`` and
``D [d]`` float32 on one CUDA device, with N in :data:`STATES`, and returns
``(y [B,S,d], h_last [B,d,N])`` in float32.  ``xc``, ``dt``, ``Bm`` and
``Cm`` are read through their (batch, seq) strides and must be contiguous in
their last dim.  It checks its inputs and raises on anything the kernel does
not take; it never falls back to the plain version.  The library is built and
loaded on the first call, never at import, so the module imports on a host
without CUDA.  ``selective_scan_cuda.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import BuiltLibrary, build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATES = (8, 16)    # Mamba's state sizes; ssm_state is 16 in every config
_library: list[BuiltLibrary] = []


def library() -> BuiltLibrary:
    """The built and bound kernel library (built on the first call)."""
    if not _library:
        built = build("selective_scan")
        fn = built.lib.selective_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _library.append(built)
    return _library[0]


def check_inputs(xc, dt, Bm, Cm, A, D) -> None:
    """Raise unless the kernel takes these inputs."""
    if xc.device.type != "cuda":
        raise ValueError(f"selective_scan_cuda needs CUDA tensors, got "
                         f"{xc.device}")
    if any(t.device != xc.device for t in (dt, Bm, Cm, A, D)):
        raise ValueError("xc, dt, Bm, Cm, A and D must share a device")
    if xc.dtype not in _DTYPES or dt.dtype not in _DTYPES:
        raise TypeError(f"selective_scan_cuda takes float32 or bfloat16 xc "
                        f"and dt, got {xc.dtype}, {dt.dtype}")
    if any(t.dtype != torch.float32 for t in (Bm, Cm, A, D)):
        raise TypeError(f"Bm, Cm, A and D must be float32, got "
                        f"{[t.dtype for t in (Bm, Cm, A, D)]}")
    if xc.dim() != 3 or dt.shape != xc.shape:
        raise ValueError(f"expected xc, dt [B,S,d], got {tuple(xc.shape)}, "
                         f"{tuple(dt.shape)}")
    B, S, d = xc.shape
    if Bm.dim() != 3 or Bm.shape[:2] != (B, S) or Cm.shape != Bm.shape:
        raise ValueError(f"expected Bm, Cm [B,S,N] with B, S of xc, got "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    N = Bm.shape[2]
    if N not in STATES:
        raise ValueError(f"state size {N} not in {STATES}")
    if A.shape != (d, N) or D.shape != (d,):
        raise ValueError(f"expected A [{d},{N}] and D [{d}], got "
                         f"{tuple(A.shape)}, {tuple(D.shape)}")
    for name, t in (("xc", xc), ("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    if B > 65535 or max(S, d) >= 2 ** 31:
        raise ValueError(f"B must be at most 65535 and S, d fit an int32: "
                         f"{tuple(xc.shape)}")


def selective_scan_cuda(xc: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                        Cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor):
    """The S6 recurrence ``h_t = exp(dt_t·A) ⊙ h_{t−1} + (dt_t·x_t) B_t``,
    ``y_t = h_t·C_t + D ⊙ x_t`` from ``h_0 = 0`` → ``(y [B,S,d], h_last
    [B,d,N])`` in float32."""
    check_inputs(xc, dt, Bm, Cm, A, D)
    B, S, d = xc.shape
    N = Bm.shape[2]
    A, D = A.contiguous(), D.contiguous()
    y = torch.empty(B, S, d, dtype=torch.float32, device=xc.device)
    if B == 0 or S == 0 or d == 0:
        return y, torch.zeros(B, d, N, dtype=torch.float32, device=xc.device)
    h_last = torch.empty(B, d, N, dtype=torch.float32, device=xc.device)
    strides = (ctypes.c_longlong * 8)(
        *(s for t in (xc, dt, Bm, Cm) for s in t.stride()[:2]))
    fn = library().lib.selective_scan_launch
    with torch.cuda.device(xc.device):
        rc = fn(xc.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                A.data_ptr(), D.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                B, S, d, N, strides, _DTYPES[xc.dtype], _DTYPES[dt.dtype],
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA "
                           f"error {rc}")
    selective_scan_cuda.launches += 1
    return y, h_last


selective_scan_cuda.launches = 0
