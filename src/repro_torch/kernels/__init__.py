"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version (``ref.py``) and the dispatch wrapper (``ops.py``).  K1,
``fl_aggregate``, is the only TPU kernel on the simulation's path; K2
(flash attention) and K3 (selective scan) are not ported yet."""
from . import ops, ref

__all__ = ["ops", "ref"]
