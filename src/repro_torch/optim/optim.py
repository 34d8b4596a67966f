"""Pure-function optimizers over tensors (counterpart of
``repro.optim.optim``).

The engines hold every model as one flat float32 row (``[W]``, or ``[K, W]``
for the clients), so a state is a tensor like the row and an update one
elementwise pass.  Each step rounds as JAX's does in float32: a Python
scalar enters as float32, Adam's bias corrections ``1 − b^t`` are float32
powers, taken (with the ``sqrt``) in float64 and rounded once, so the card
and the CPU share their bits and JAX's are within a few ulp.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (grads, state, params) -> (updates, state)
    update: Callable[[Any, Any, Any], tuple[Any, Any]]
    # plain SGD's step size, so a loss's fused trainer can take its place;
    # None for every other optimizer
    lr: float | None = None


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params):
        return -lr * grads, state

    return Optimizer(init, update, lr)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    """Heavy ball: ``m ← β·m + g``, update ``−lr·m``."""

    def init(params):
        return torch.zeros_like(params)

    def update(grads, state, params):
        m = beta * state + grads
        return -lr * m, m

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam: the moments, their bias corrections ``1 − b^t`` and the update
    ``−lr·(m/bc1) / (sqrt(v/bc2) + eps)``; the state is ``(m, v, t)`` with
    ``t`` an int32 count."""
    b1_32, b2_32 = float(np.float32(b1)), float(np.float32(b2))

    def init(params):
        return (torch.zeros_like(params), torch.zeros_like(params),
                torch.zeros((), dtype=torch.int32, device=params.device))

    def correction(b: float, t: torch.Tensor) -> torch.Tensor:
        tf = t.to(torch.float32).to(torch.float64)
        return 1.0 - torch.pow(torch.tensor(b, dtype=torch.float64,
                                            device=t.device),
                               tf).to(torch.float32)

    def update(grads, state, params):
        m, v, t = state
        t = t + 1
        m = b1 * m + (1 - b1) * grads
        v = b2 * v + (1 - b2) * grads * grads
        bc1 = correction(b1_32, t)
        bc2 = correction(b2_32, t)
        root = torch.sqrt((v / bc2).to(torch.float64)).to(torch.float32)
        upd = -lr * (m / bc1) / (root + eps)
        return upd, (m, v, t)

    return Optimizer(init, update)


def apply_updates(params, upd):
    """``params + upd`` in ``params``' dtype."""
    return params + upd.to(params.dtype)
