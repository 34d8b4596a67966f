"""Minimal optimizer library; the paper trains with plain SGD (lr 0.01),
momentum and Adam serve the beyond-paper runs."""
from .optim import Optimizer, adam, apply_updates, momentum, sgd

__all__ = ["Optimizer", "sgd", "momentum", "adam", "apply_updates"]
