"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version (``ref.py``) and the dispatch wrapper (``ops.py``): K1,
``fl_aggregate`` (the simulation's eq. 3), K2, ``flash_attention`` (the
LLM's full-sequence attention), and K3, ``selective_scan`` (the Mamba
mixer's S6 scan)."""
from . import ops, ref

__all__ = ["ops", "ref"]
