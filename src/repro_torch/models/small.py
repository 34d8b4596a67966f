"""The paper's MNIST classifier (§V-A), counterpart of
``repro.models.small``: one hidden layer of 200 units, 784·200+200+200·10+10
= 159,010 float32 parameters (the JAX docstring's 199,210 is a slip; the
cell's model size S = 6.37e6 bits is the paper's figure and is kept).

Params are a list of ``{"w": [n_in, n_out], "b": [n_out]}`` layers — JAX's
layout.  Every function also takes params stacked over K clients (a leading
axis on every leaf, inputs ``[K, B, ...]``): the products are then batched
matrix products, one per client, and the loss and accuracy come back per
client (``[K]``).  The gradient of the sum of those per-client losses with
respect to the stacked params is each client's own gradient, exactly what
``vmap(grad(loss))`` gives in JAX.
"""
from __future__ import annotations

import torch

from .. import random as jr
from .. import resolve_device


def _dense_init(key, n_in, n_out, device):
    k1, _ = jr.split(key)
    scale = torch.sqrt(torch.tensor(2.0 / n_in, dtype=torch.float32))
    return {"w": jr.normal(k1, (n_in, n_out), device=device) * scale.item(),
            "b": torch.zeros(n_out, dtype=torch.float32, device=device)}


def init_mlp(key: torch.Tensor, dims=(784, 200, 10), device=None):
    """He-normal weights, zero biases, on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    keys = jr.split(key, len(dims) - 1)
    return [_dense_init(k, i, o, device)
            for k, i, o in zip(keys, dims[:-1], dims[1:])]


def mlp_logits(params, x: torch.Tensor) -> torch.Tensor:
    lead = params[0]["w"].dim() - 2          # 1 when stacked over clients
    x = x.reshape(*x.shape[:lead + 1], -1)
    for layer in params[:-1]:
        x = torch.relu(x @ layer["w"] + layer["b"].unsqueeze(-2))
    last = params[-1]
    return x @ last["w"] + last["b"].unsqueeze(-2)


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the batch axis (the last one)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, y.long().unsqueeze(-1)).squeeze(-1) \
        .mean(-1)


def mlp_loss(params, x, y):
    return cross_entropy(mlp_logits(params, x), y)


def mlp_accuracy(params, x, y):
    return (torch.argmax(mlp_logits(params, x), -1) == y).to(
        torch.float32).mean(-1)
