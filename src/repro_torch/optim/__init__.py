"""Minimal optimizer library; the paper trains with plain SGD (lr 0.01)."""
from .optim import Optimizer, sgd

__all__ = ["Optimizer", "sgd"]
