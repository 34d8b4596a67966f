"""The paper's small models (§V-A), counterpart of ``repro.models.small``.

* ``mlp``: the MNIST classifier, one hidden layer of 200 units,
  784·200+200+200·10+10 = 159,010 float32 parameters (the JAX docstring's
  199,210 is a slip; the cell's model size S = 6.37e6 bits is the paper's
  figure and is kept).  Params are a list of ``{"w": [n_in, n_out], "b":
  [n_out]}`` layers — JAX's layout.  ``mlp_loss.fused_sgd`` is its own
  local-SGD trainer (:class:`FusedSGD`): the engine asks a loss for it and
  runs plain SGD of the MLP's flat client rows through the hand-written
  kernel where it takes them (:mod:`repro_torch.kernels.mlp_sgd`).
* ``cnn``: the AlexNet stand-in for the CIFAR-like data: 3×3 "SAME"
  convolutions of widths (32, 64, 128), each with ReLU and 2×2 max pooling,
  then fc 256 and 10 logits; 620,362 parameters.  Params are the list
  ``[conv_0, …, conv_{n-1}, fc1, fc2]`` of ``{"w", "b"}`` layers, which
  flattens in the order of JAX's ``{"convs": [...], "fc1", "fc2"}`` tree;
  the conv weights keep JAX's HWIO shape ``[3, 3, c_in, c_out]`` and the
  inputs its NHWC layout (:mod:`repro_torch.convert` carries the tree).

Every function also takes params stacked over R clients (a leading axis on
every leaf, inputs ``[R, B, ...]``) and then returns per-client losses and
accuracies (``[R]``): the MLP's products are batched matrix products, the
CNN's convolutions one grouped convolution with the clients folded into the
channels.  The gradient of the sum of those per-client losses with respect
to the stacked params is each client's own gradient, exactly what
``vmap(grad(loss))`` gives in JAX.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from .. import random as jr
from .. import resolve_device
from ..kernels import mlp_sgd, ops


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


def mlp_size_bits(params) -> int:
    """The model's size in bits: its elements at 32 bits each (JAX's sum
    over the tree's leaves; ``params`` a list of layer dicts)."""
    return sum(t.numel() for layer in params for t in layer.values()) * 32


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the batch axis (the last one)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, y.long().unsqueeze(-1)).squeeze(-1) \
        .mean(-1)


def mlp_loss(params, x, y):
    return cross_entropy(mlp_logits(params, x), y)


class FusedSGD(NamedTuple):
    """A loss's own trainer for plain SGD over flat client rows:
    ``takes(layout)`` says whether ``run(rows, xb, yb, lr, layout)`` trains
    rows of that layout; it gives what ``L`` steps of ``sgd(lr)`` through
    autograd give, to rounding."""
    takes: Callable[..., bool]
    run: Callable[..., torch.Tensor]


mlp_loss.fused_sgd = FusedSGD(lambda layout: mlp_sgd.widths(layout)
                              is not None, ops.mlp_local_sgd)


def mlp_accuracy(params, x, y):
    return (torch.argmax(mlp_logits(params, x), -1) == y).to(
        torch.float32).mean(-1)


# ---------------------------------------------------------------------------
# CNN (AlexNet stand-in for CIFAR-like data)
# ---------------------------------------------------------------------------

def _conv_init(key, k, c_in, c_out, device):
    scale = torch.sqrt(torch.tensor(2.0 / (k * k * c_in), dtype=torch.float32))
    return {"w": jr.normal(key, (k, k, c_in, c_out), device=device)
            * scale.item(),
            "b": torch.zeros(c_out, dtype=torch.float32, device=device)}


def init_cnn(key: torch.Tensor, widths=(32, 64, 128), fc=256, num_classes=10,
             device=None):
    """JAX's ``init_cnn`` draws as the list ``[conv_0, …, fc1, fc2]`` on
    ``device`` (``None``: the card)."""
    device = resolve_device(device)
    keys = jr.split(key, len(widths) + 2)
    params, c_in = [], 3
    for i, w in enumerate(widths):
        params.append(_conv_init(keys[i], 3, c_in, w, device))
        c_in = w
    spatial = 32 // (2 ** len(widths))
    params.append(_dense_init(keys[-2], spatial * spatial * c_in, fc, device))
    params.append(_dense_init(keys[-1], fc, num_classes, device))
    return params


# cuDNN convolves float32 in TF32 unless torch.backends.cudnn.allow_tf32 is
# off, and that flag is process-global: each convolution (forward and
# backward) clears it under this lock and puts it back, whoever calls.
_CONV_FLAG_LOCK = threading.Lock()


@contextlib.contextmanager
def _full_fp32():
    with _CONV_FLAG_LOCK:
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev


class _GroupedConv(torch.autograd.Function):
    """3×3 stride-1 ``padding=1`` (JAX's "SAME") convolution of ``[B, G·Ci,
    H, W]`` by ``[G·Co, Ci, 3, 3]`` in ``G`` groups, forward and backward
    in full float32."""

    @staticmethod
    def forward(ctx, x, w, groups: int):
        ctx.save_for_backward(x, w)
        ctx.groups = groups
        with _full_fp32():
            return F.conv2d(x, w, padding=1, groups=groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        with _full_fp32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
                ctx.groups, [ctx.needs_input_grad[0],
                             ctx.needs_input_grad[1], False])
        return gx, gw, None


def cnn_logits(params, x: torch.Tensor) -> torch.Tensor:
    """Logits ``[B, classes]`` of NHWC inputs ``[B, 32, 32, 3]``, or
    ``[R, B, classes]`` of ``[R, B, 32, 32, 3]`` under params stacked over
    R clients."""
    stacked = params[0]["w"].dim() == 5
    if not stacked:
        params = [{k: v.unsqueeze(0) for k, v in layer.items()}
                  for layer in params]
        x = x.unsqueeze(0)
    R, B = x.shape[:2]
    # NHWC per client -> NCHW with the clients folded into the channels
    h = x.permute(1, 0, 4, 2, 3).reshape(B, R * x.shape[-1], *x.shape[2:4])
    for conv in params[:-2]:
        w = conv["w"]                      # [R, 3, 3, c_in, c_out] (HWIO)
        c_in, c_out = w.shape[3], w.shape[4]
        w = w.permute(0, 4, 3, 1, 2).reshape(R * c_out, c_in, 3, 3)
        h = _GroupedConv.apply(h, w, R) + conv["b"].reshape(-1, 1, 1)
        h = F.max_pool2d(torch.relu(h), 2)
    # back to NHWC before flattening, the row order of fc1's weights
    c, hh, ww = h.shape[1] // R, h.shape[2], h.shape[3]
    h = h.reshape(B, R, c, hh, ww).permute(1, 0, 3, 4, 2).reshape(R, B, -1)
    fc1, fc2 = params[-2], params[-1]
    h = torch.relu(h @ fc1["w"] + fc1["b"].unsqueeze(-2))
    out = h @ fc2["w"] + fc2["b"].unsqueeze(-2)
    return out if stacked else out[0]


def cnn_loss(params, x, y):
    return cross_entropy(cnn_logits(params, x), y)


def cnn_accuracy(params, x, y):
    return (torch.argmax(cnn_logits(params, x), -1) == y).to(
        torch.float32).mean(-1)
