"""Share the CPU's cores among pytest-xdist workers for PyTorch.

Each worker's PyTorch would otherwise start one OpenMP thread per core, so
six workers on eight cores run ~50 spinning threads and small tensor
operations slow down by one or two orders of magnitude.  Under xdist
(``PYTEST_XDIST_WORKER_COUNT`` set) each worker gets ``cores // workers``
threads; a single-process run keeps PyTorch's default.  Every
``tests/test_torch_*.py`` imports this module first.
"""
import os

import torch

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    _CORES = len(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else (os.cpu_count() or 1)
    torch.set_num_threads(max(1, _CORES // int(_WORKERS)))
