"""Models: the paper's MNIST MLP and CNN (``small``) and the generic
decoder stack of the LLM configurations (``transformer``) with its mixers
(``attention``, ``mamba``, ``xlstm``), FFNs (``layers``, ``moe``) and entry
points — the names ``repro.models`` exports."""
from . import attention, layers, mamba, moe, small, transformer, xlstm
from .transformer import (decode_step, forward, init_caches, init_params,
                          loss, prefill)

__all__ = ["attention", "layers", "mamba", "moe", "small", "transformer",
           "xlstm", "init_params", "forward", "loss", "prefill",
           "decode_step", "init_caches"]
