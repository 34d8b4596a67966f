"""Plain reference of ``mlp_784_200_10``: the 784-200-10 MLP in plain
PyTorch, float32, over leaves stacked along a leading client axis."""
import math

import torch


def forward(layers, x):
    """Logits ``[R, B, 10]`` of ``x [R, B, 784]`` under ``layers``: a list
    of ``{"w": [R, n_in, n_out], "b": [R, n_out]}``."""
    h = x.reshape(x.shape[0], x.shape[1], -1)
    for i, layer in enumerate(layers):
        h = torch.baddbmm(layer["b"][:, None, :], h, layer["w"])
        if i + 1 < len(layers):
            h = torch.relu(h)
    return h


def forward_flops(config) -> int:
    """Operations of one sample's forward pass: a multiply and an add per
    weight of each product (biases and activations not counted)."""
    return sum(2 * math.prod(layer["w"]) for layer in config["layers"])
