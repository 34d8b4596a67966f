"""Local SGD of an MLP's client rows on the card: the hand-written CUDA
kernel ``csrc/mlp_sgd.cu``, which replaces no Pallas kernel (the JAX
package leaves ``vmap(grad)`` of the loss to XLA).

:func:`mlp_local_sgd_cuda` runs all L local SGD steps of R client rows of a
one-hidden-layer ReLU MLP (the paper's 784-200-10, or other widths the
tiling takes) in one launch, each row read once and written once.  The
leaf offsets come from the :class:`~repro_torch.fl.state.ParamLayout`, in
JAX's sorted-key order (``b1``, ``w1``, ``b2``, ``w2``); :func:`widths`
reads them and refuses any other layout.  :func:`launch_plan` asks the
library for its cut of a row over a thread-block cluster;
:func:`refusal` says why the wrapper would not take some inputs (``None``
when it takes them).  The wrapper raises on anything the kernel does not
take, a batch past the largest tile (32) included; it never falls back to
the plain version (:func:`repro_torch.kernels.ref.mlp_local_sgd_ref`).
The library is built and loaded on the first call, never at import.
``mlp_local_sgd_cuda.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ._build import BuiltLibrary, build

_library: list[BuiltLibrary] = []


class LaunchPlan(NamedTuple):
    """How the kernel cuts a row: a cluster of ``cluster`` CTAs, each
    holding W1's columns of its share of the hidden units in ``smem`` bytes
    of shared memory."""
    cluster: int
    smem: int


@functools.lru_cache(maxsize=256)
def launch_plan(B: int, D: int, H: int, C: int, W: int) -> LaunchPlan | None:
    """The library's plan for batches of ``B`` rows of a ``D``-``H``-``C``
    MLP in rows of ``W`` floats (the fewest CTAs a cluster that hold a
    CTA's W1 columns with the step's batch), or ``None`` where the kernel
    takes no such shapes."""
    cl, smem = ctypes.c_int(0), ctypes.c_int(0)
    if library().lib.mlp_sgd_plan(B, D, H, C, W, ctypes.byref(cl),
                                  ctypes.byref(smem)):
        return None
    return LaunchPlan(cl.value, smem.value)


def widths(layout) -> tuple[int, int, int] | None:
    """``(D, H, C)`` of a layout that is one ReLU hidden layer in JAX's
    order — ``b1 [H]`` at 0, ``w1 [D, H]`` at H, ``b2 [C]`` at H + D·H,
    ``w2 [H, C]`` after it — else ``None``."""
    e = tuple(layout.entries)
    if len(e) != 4 or [(i, name) for i, name, _, _ in e] != [
            (0, "b"), (0, "w"), (1, "b"), (1, "w")]:
        return None
    (_, _, s_b1, o_b1), (_, _, s_w1, o_w1), (_, _, s_b2, o_b2), \
        (_, _, s_w2, o_w2) = e
    if len(s_b1) != 1 or len(s_w1) != 2 or len(s_b2) != 1 or len(s_w2) != 2:
        return None
    H, (D, H1), C, (H2, C2) = s_b1[0], s_w1, s_b2[0], s_w2
    if (H1, H2, C2) != (H, H, C) or (o_b1, o_w1, o_b2, o_w2) != (
            0, H, H + D * H, H + D * H + C):
        return None
    return D, H, C


def refusal(rows, xb, yb, layout) -> str | None:
    """Why :func:`mlp_local_sgd_cuda` would not take these inputs, or
    ``None`` (whether the kernel has a plan for the shapes only the library
    says, at the launch)."""
    dims = widths(layout)
    if dims is None:
        return f"not a one-hidden-layer MLP layout: {layout.entries}"
    D = dims[0]
    if not all(isinstance(t, torch.Tensor) for t in (rows, xb, yb)):
        return "rows, xb and yb must be tensors"
    if (rows.dtype, xb.dtype, yb.dtype) != (torch.float32, torch.float32,
                                            torch.int32):
        return (f"mlp_local_sgd_cuda takes float32 rows and xb and int32 "
                f"yb, got {rows.dtype}, {xb.dtype} and {yb.dtype}")
    if rows.dim() != 2 or rows.shape[1] != layout.width:
        return f"rows {tuple(rows.shape)} are not [R, {layout.width}]"
    if yb.dim() != 3 or yb.shape[0] != rows.shape[0]:
        return f"yb {tuple(yb.shape)} is not [R, L, B]"
    R, L, B = yb.shape
    if (xb.dim() < 4 or tuple(xb.shape[:3]) != (R, L, B)
            or math.prod(xb.shape[3:]) != D):
        return f"xb {tuple(xb.shape)} is not [{R}, {L}, {B}, {D}]"
    if not (rows.is_contiguous() and xb.is_contiguous()
            and yb.is_contiguous()):
        return "rows, xb and yb must be contiguous"
    if rows.data_ptr() % 16:
        return "rows must start on 16 bytes"
    if rows.device.type != "cuda":
        return "mlp_local_sgd_cuda needs CUDA tensors"
    if xb.device != rows.device or yb.device != rows.device:
        return "rows, xb and yb must share a device"
    return None


def library() -> BuiltLibrary:
    """The built and bound kernel library (built on the first call)."""
    if not _library:
        built = build("mlp_sgd")
        fn = built.lib.mlp_sgd_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong] + \
            [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        plan = built.lib.mlp_sgd_plan
        plan.argtypes = [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_int)] * 2
        plan.restype = ctypes.c_int
        occ = built.lib.mlp_sgd_max_clusters
        occ.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int
        _library.append(built)
    return _library[0]


@functools.lru_cache(maxsize=64)
def max_clusters(index: int, B: int, D: int, H: int, C: int, W: int) -> int:
    """How many of the plan's clusters card ``index`` runs at once."""
    p = launch_plan(B, D, H, C, W)
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = library().lib.mlp_sgd_max_clusters(
            B, D, H, C, W, p.cluster, ctypes.byref(out))
    if rc != 0 or out.value < 1:
        raise RuntimeError(f"mlp_sgd: no cluster of {p.cluster} CTAs with "
                           f"{p.smem} bytes fits (CUDA error {rc})")
    return out.value


def mlp_local_sgd_cuda(rows: torch.Tensor, xb: torch.Tensor,
                       yb: torch.Tensor, lr: float, layout) -> torch.Tensor:
    """``rows [R, W]`` float32, ``xb [R, L, B, D...]`` float32, ``yb [R, L,
    B]`` int32, all contiguous on one card → the rows after L steps of SGD
    at ``lr`` (a new ``[R, W]`` tensor; every element written, the padding
    copied)."""
    why = refusal(rows, xb, yb, layout)
    if why is not None:
        raise ValueError(why)
    D, H, C = widths(layout)
    R, L, B = yb.shape
    W = layout.width
    p = launch_plan(B, D, H, C, W)
    if p is None:
        raise ValueError(f"no launch plan for B {B} at {D}-{H}-{C} in rows "
                         f"of {W} floats")
    out = torch.empty_like(rows)
    if R == 0:
        return out
    index = rows.device.index if rows.device.index is not None \
        else torch.cuda.current_device()
    clusters = min(R, max_clusters(index, B, D, H, C, W))
    with torch.cuda.device(index):
        rc = library().lib.mlp_sgd_launch(
            rows.data_ptr(), out.data_ptr(), xb.data_ptr(), yb.data_ptr(), R,
            L, B, D, H, C, W, p.cluster, clusters,
            float(np.float32(-lr)), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mlp_sgd kernel launch failed: CUDA error {rc}")
    mlp_local_sgd_cuda.launches += 1
    return out


mlp_local_sgd_cuda.launches = 0
