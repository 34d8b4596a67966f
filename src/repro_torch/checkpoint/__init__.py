"""Checkpointing: nested tuples, lists and dicts of tensors ←→ ``.npz`` +
a JSON index (counterpart of ``repro.checkpoint``)."""
from .checkpoint import load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint"]
