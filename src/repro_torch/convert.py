"""Param trees between the JAX package and the port, through numpy.

``params_from_jax`` takes the JAX MLP's param list as numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, params)``) and returns the
port's params; ``params_to_numpy`` goes back.  Both keep JAX's layout
(``{"w": [n_in, n_out], "b": [n_out]}`` per layer), so the two packages can
train from the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def params_from_jax(tree, device=None):
    """A list of ``{name: array}`` layers → the same of float32 tensors on
    ``device`` (``None`` means the card)."""
    device = resolve_device(device)
    return [{name: torch.tensor(np.asarray(a), dtype=torch.float32,
                                device=device)
             for name, a in layer.items()} for layer in tree]


def params_to_numpy(params):
    """The port's params → a list of ``{name: np.ndarray}`` layers."""
    return [{name: t.detach().cpu().numpy() for name, t in layer.items()}
            for layer in params]
