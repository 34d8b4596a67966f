"""Pure-function optimizers over tensors (counterpart of
``repro.optim.optim``; only ``sgd``, the paper's optimizer, is ported)."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (grads, state, params) -> (updates, state)
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params):
        return -lr * grads, state

    return Optimizer(init, update)
