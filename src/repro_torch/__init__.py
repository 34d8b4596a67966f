"""repro_torch — the PyTorch/CUDA port of the ``repro`` JAX package.

It mirrors ``repro``'s module layout (``core``, ``data``, ``models``,
``optim``, ``fl``, ``kernels``) and is held against it by the
``tests/test_torch_*.py`` parity tests.  It imports neither JAX nor
anything from ``repro``.  Entry points take ``device=None``, which means
``torch.device("cuda")``; pass ``device="cpu"`` to run on the host.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; no fallback to the CPU when there is none."""
    return torch.device("cuda" if device is None else device)
