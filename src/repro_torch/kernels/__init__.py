"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version (``ref.py``) and the dispatch wrapper (``ops.py``): K1,
``fl_aggregate`` (the simulation's eq. 3), K2, ``flash_attention`` (the
LLM's full-sequence attention), K3, ``selective_scan`` (the Mamba
mixer's S6 scan), and ``mlp_local_sgd`` (the MLP clients' local SGD, which
the JAX package leaves to XLA).

As in ``repro.kernels``, the package exports the three kernels' entry
points under their modules' names: ``fl_aggregate``, ``flash_attention``
and ``selective_scan`` here are the dispatchers of :mod:`.ops` (the kernel
on a CUDA tensor, its plain version on a CPU tensor), so they shadow the
submodules as attributes; ``importlib.import_module`` (or ``from
.fl_aggregate import …``) reaches a submodule itself.
"""
from . import ops, ref
from .ops import fl_aggregate, flash_attention, mlp_local_sgd, selective_scan

__all__ = ["ops", "ref", "fl_aggregate", "flash_attention", "mlp_local_sgd",
           "selective_scan"]
