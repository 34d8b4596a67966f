"""A frozen copy of the random-stream arithmetic the simulation is defined
on: JAX's threefry2x32 (``jax_threefry_partitionable=True``) as int64
tensor operations, ``PRNGKey``, ``fold_in`` and ``uniform`` in float32.

The benchmark's reference draws its participation masks and minibatch
indices from these functions, so it realises the same random streams as
the program without importing any of the program's code.  A key is an
int64 tensor ``[..., 2]`` holding two uint32 words.
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3F800000        # the bits of 1.0f
DATA_STREAM = 0x0DA7A         # fold_in tag of the minibatch stream


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """Threefry-2x32, 20 rounds, on uint32 values held in int64."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``PRNGKey(seed)`` with 32-bit ints: ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``fold_in``: keys ``[..., 2]`` and data broadcast together."""
    if isinstance(data, torch.Tensor):
        d = data.to(device=key.device, dtype=torch.int64) & MASK
    else:
        d = torch.tensor(int(data) & MASK, dtype=torch.int64,
                         device=key.device)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits a counter of an iota over ``shape``, ``[..., *shape]``
    for keys ``[..., 2]``: the xor of the two output words."""
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return (b1 ^ b2).reshape(key.shape[:-1] + tuple(shape))


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """float32 uniforms on [0, 1): 23 random mantissa bits under the
    exponent of 1.0, minus 1."""
    bits = random_bits(key, tuple(shape))
    f = (((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32)
         - 1.0)
    return torch.clamp(f, min=0.0)


def uniform_index(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """An example index uniform over ``[0, n)`` from float32 uniforms:
    ``min(floor(u·n), n - 1)`` with the product taken in float32."""
    nf = torch.clamp(n, min=1).to(torch.float32)
    while nf.dim() < u.dim():
        nf = nf[..., None]
    idx = torch.floor(u * nf).to(torch.int64)
    return torch.minimum(idx, (nf - 1.0).to(torch.int64))
