"""A cell's inputs, made from ``--seed`` on the card with one
``torch.Generator`` in a few large calls: the clients' examples (a
class-conditional Gaussian mixture, each client holding
``labels_per_client`` labels: the pathological non-IID split), the test
set, the initial weights, the channel gains and the seed lanes of the runs.

The same seed gives the same inputs; the program and the reference are
handed these same tensors.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

#: the most bytes one generator call makes while the store is filled
CHUNK_BYTES = 1 << 30


@dataclasses.dataclass
class World:
    x: torch.Tensor        # [K, N, *input_shape] float32
    y: torch.Tensor        # [K, N] int32
    lengths: torch.Tensor  # [K] int32
    test_x: torch.Tensor   # [n_test, *input_shape] float32
    test_y: torch.Tensor   # [n_test] int32
    params: list           # the port's tree: a list of {"w", "b"} layers
    h: torch.Tensor        # [K, T] float32 channel power gains
    data_seed: int         # the simulation's minibatch-stream seed
    seed: int

    def lane(self, i: int) -> int:
        """The participation seed of run ``i`` (0 is the warm-up run)."""
        return lane_seed(self.seed, i)


def lane_seed(seed: int, i: int) -> int:
    ss = np.random.SeedSequence([int(seed) & (2**63 - 1), 1, int(i)])
    return int(ss.generate_state(1)[0]) & 0x7FFFFFFF


def fan_in(shape) -> int:
    return math.prod(shape[:-1]) if len(shape) > 1 else 1


def make_params(layers: list, gen: torch.Generator, device) -> list:
    """He-normal weights (std sqrt(2 / fan_in), fan_in the product of all
    but the last axis) from one draw, zero biases, in the tree the port
    takes: a list of ``{name: tensor}`` layers."""
    shapes = [(i, n, tuple(s)) for i, layer in enumerate(layers)
              for n, s in layer.items()]
    weights = [(i, n, s) for i, n, s in shapes if n == "w"]
    flat = torch.randn(sum(math.prod(s) for _, _, s in weights),
                       generator=gen, device=device)
    out = [dict() for _ in layers]
    off = 0
    for i, n, s in shapes:
        if n == "w":
            k = math.prod(s)
            out[i][n] = (flat[off:off + k].view(s)
                         * math.sqrt(2.0 / fan_in(s))).clone()
            off += k
        else:
            out[i][n] = torch.zeros(s, dtype=torch.float32, device=device)
    return out


def channel_gains(gen: torch.Generator, K: int, T: int, cell: dict,
                  device) -> torch.Tensor:
    """``[K, T]``: the 3GPP path gain of a position uniform in the cell's
    annulus (by area) times Rayleigh block fading, exponential(1) a round
    (paper Table II).  The fading's uniform draw is kept off 0 (at least
    2⁻³²; ``torch.rand`` gives an exact 0 about once in 2²⁴ draws), so no
    gain is 0 and no transmitter's eq.-5 Joules are infinite."""
    r0, r1 = float(cell["min_radius_m"]), float(cell["cell_radius_m"])
    u = torch.rand(K, generator=gen, device=device)
    dist = torch.sqrt(u * (r1 ** 2 - r0 ** 2) + r0 ** 2)
    pl_db = 128.1 + 37.6 * torch.log10(torch.clamp(dist, min=1.0) / 1000.0)
    gain = torch.pow(10.0, -pl_db / 10.0)
    u = torch.rand(K, T, generator=gen, device=device).clamp_(min=2.0**-32)
    fading = -torch.log1p(-u)
    return (fading * gain[:, None]).contiguous()


def make_world(cell, seed: int, device, store_device=None) -> World:
    """The cell's inputs on ``device``; the store on ``store_device``
    (``device`` by default; the host for a run placed over cards, which
    splits it from there)."""
    cfg, tr = cell.config, cell.traffic
    store_device = torch.device(device if store_device is None
                                else store_device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2**63 - 1))
    K, N = int(tr["clients"]), int(tr["examples_per_client"])
    shape = tuple(cfg["input_shape"])
    D = math.prod(shape)
    C = int(cfg["num_classes"])
    lpc = int(cfg["labels_per_client"])
    data = cfg["data"]
    protos = torch.randn(C, D, generator=gen, device=device) \
        * float(data["proto_scale"])
    # each client's labels: the first lpc of a random permutation of the
    # classes, example i taking label i mod lpc of them
    perm = torch.argsort(torch.rand(K, C, generator=gen, device=device),
                         dim=1)[:, :lpc]
    y = perm[:, torch.arange(N, device=device) % lpc].to(torch.int32)
    x = torch.empty((K, N) + shape, dtype=torch.float32,
                    device=store_device)
    step = max(1, CHUNK_BYTES // (N * D * 4))
    for k0 in range(0, K, step):
        k1 = min(K, k0 + step)
        chunk = torch.randn(k1 - k0, N, D, generator=gen, device=device)
        chunk.mul_(float(data["noise"])).add_(protos[y[k0:k1].long()])
        x[k0:k1].copy_(chunk.view((k1 - k0, N) + shape))
        del chunk
    n_test = int(tr["eval_batch"])
    test_y = (torch.arange(n_test, device=device) % C).to(torch.int32)
    test_x = (torch.randn(n_test, D, generator=gen, device=device)
              * float(data["noise"]) + protos[test_y.long()]).view(
                  (n_test,) + shape)
    params = make_params(cfg["layers"], gen, device)
    h = channel_gains(gen, K, int(tr["rounds"]), tr["cell"], device)
    lengths = torch.full((K,), N, dtype=torch.int32, device=store_device)
    data_seed = int(np.random.SeedSequence(
        [int(seed) & (2**63 - 1), 2]).generate_state(1)[0]) & 0x7FFFFFFF
    return World(x=x, y=y.to(store_device), lengths=lengths, test_x=test_x,
                 test_y=test_y, params=params, h=h, data_seed=data_seed,
                 seed=int(seed))
