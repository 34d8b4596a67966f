"""K2 on the card: the hand-written CUDA kernel for causal / sliding-window
GQA attention (``csrc/flash_attention.cu``), replacing the Pallas TPU kernel
``repro.kernels.flash_attention``.

:func:`flash_attention_cuda` takes ``q [B,S,H,hd]``, ``k``/``v [B,S,KV,hd]``
on one CUDA device (float32 or bfloat16, hd 64 or 128, ``H % KV == 0``,
the last dim contiguous, rows 16-byte aligned) and returns ``o [B,S,H,hd]``
in ``q.dtype``.  It checks its inputs and raises on anything the kernel does
not take; it never falls back to the plain version.  The library is built
and loaded on the first call, never at import, so the module imports on a
host without CUDA.  ``flash_attention_cuda.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import BuiltLibrary, build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
_library: list[BuiltLibrary] = []


def library() -> BuiltLibrary:
    """The built and bound kernel library (built on the first call)."""
    if not _library:
        built = build("flash_attention")
        fn = built.lib.flash_attention_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _library.append(built)
    return _library[0]


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int | None) -> None:
    """Raise unless the kernel takes ``q``, ``k``, ``v`` and ``window``."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must share a device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda takes float32 or bfloat16 q, "
                        f"k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,S,H,hd] and k, v [B,S,KV,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV != 0:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive int, got {window}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError(f"{name}'s rows must be 16-byte aligned: "
                             f"strides {t.stride()}")
    if max(B, S, H) >= 2 ** 31:
        raise ValueError(f"B, S and H must fit an int32: {tuple(q.shape)}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         window: int | None = None) -> torch.Tensor:
    """Causal (``causal``) and/or windowed (``kpos > qpos - window``) GQA
    attention with the scale ``1/√hd`` → ``[B,S,H,hd]`` in ``q.dtype``."""
    check_inputs(q, k, v, window)
    B, S, H, hd = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if B == 0 or S == 0 or H == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = library().lib.flash_attention_launch
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                S, H, k.shape[2], hd, strides, int(bool(causal)),
                int(window or 0), _DTYPES[q.dtype],
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
