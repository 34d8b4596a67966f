"""How sensitive the port's CNN training is, and how precise its
convolutions are: the numbers behind ``chip_smoke.py`` phase 3g (b)'s
limit on the CNN's 12-round model.

    PYTHONPATH=src python tools/cnn_sensitivity.py --device cpu
    PYTHONPATH=src python tools/cnn_sensitivity.py --precision   # a card

The default mode runs the phase's federated CNN training (K 10, d 5,
RandomScheme(0.1), T 12 × L 5 × B 10, ``init_cnn``'s default widths) on
5,000 of ``make_cifar_like``'s training examples and 2,048 test ones, and
prints the relative L2 distance of the final model from the unperturbed
run's after: the initial weights nudged one ulp up and down; planted
faults of 0.1 % and 1 % in the learning rate and 0.1 % in one layer's
gradient; and the flatten before ``fc1`` taken in NCHW order.
``--precision`` compares one local-SGD gradient of 10 clients × 10 images
on the card (cuDNN) and on the CPU with a float64 CPU reference.
"""
import argparse
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import random as jr
from repro_torch.core import CellConfig
from repro_torch.core.channel import channel_gains, sample_positions
from repro_torch.core.selection import RandomScheme
from repro_torch.data import make_cifar_like, shard_noniid
from repro_torch.fl import SimConfig, run_simulation
from repro_torch.fl.state import ParamLayout
from repro_torch.models import small

K, T = 10, 12


def nchw_logits(params, x):
    """``cnn_logits`` with the planted fault: the flatten in NCHW order."""
    stacked = params[0]["w"].dim() == 5
    if not stacked:
        params = [{k: v.unsqueeze(0) for k, v in layer.items()}
                  for layer in params]
        x = x.unsqueeze(0)
    R, B = x.shape[:2]
    h = x.permute(1, 0, 4, 2, 3).reshape(B, R * x.shape[-1], *x.shape[2:4])
    for conv in params[:-2]:
        w = conv["w"]
        w = w.permute(0, 4, 3, 1, 2).reshape(R * w.shape[4], w.shape[3], 3, 3)
        h = small._GroupedConv.apply(h, w, R) + conv["b"].reshape(-1, 1, 1)
        h = F.max_pool2d(torch.relu(h), 2)
    h = h.reshape(B, R, -1).permute(1, 0, 2)
    fc1, fc2 = params[-2], params[-1]
    h = torch.relu(h @ fc1["w"] + fc1["b"].unsqueeze(-2))
    out = h @ fc2["w"] + fc2["b"].unsqueeze(-2)
    return out if stacked else out[0]


def sensitivity(device) -> None:
    tr, te = make_cifar_like(jr.PRNGKey(0), n_train=5000, n_test=2048,
                             device=device)
    clients = shard_noniid(jr.PRNGKey(1), tr, K, d=5)
    cell = CellConfig(num_clients=K)
    h = channel_gains(jr.PRNGKey(3, device=device),
                      sample_positions(jr.PRNGKey(2, device=device), cell),
                      T).T
    params = small.init_cnn(jr.PRNGKey(4), device=device)
    cfg = SimConfig(rounds=T, local_iters=5, batch_size=10, eval_every=4)

    def run(p=params, c=cfg, loss=small.cnn_loss):
        return run_simulation(p, loss, small.cnn_accuracy, clients, te,
                              RandomScheme(0.1, K), h, cell, c,
                              device=device).state.global_params

    base = run()

    def gap(row):
        return float((row - base).norm() / base.norm())

    for sign in (1, -1):
        nudged = [{k: torch.nextafter(v, torch.full_like(v, sign * 1e30))
                   for k, v in layer.items()} for layer in params]
        print(f"initial weights nudged one ulp {'up' if sign > 0 else 'down'}"
              f": {gap(run(p=nudged)):.3e}")
    for lr in (0.01001, 0.0101):
        print(f"lr {lr} for 0.01: "
              f"{gap(run(c=dataclasses.replace(cfg, lr=lr))):.3e}")

    def conv1_grad_off(p, x, y):       # the forward unchanged
        q = list(p)
        q[1] = {k: v + (v - v.detach()) * 1e-3 for k, v in p[1].items()}
        return small.cnn_loss(q, x, y)

    print(f"conv1's gradient x 1.001: {gap(run(loss=conv1_grad_off)):.3e}")
    print(f"the flatten in NCHW order: "
          f"{gap(run(loss=lambda p, x, y: small.cross_entropy(nchw_logits(p, x), y))):.3e}")


def precision() -> None:
    R, B = 10, 10
    params = small.init_cnn(jr.PRNGKey(4), device="cpu")
    layout = ParamLayout.of(params)
    gen = torch.Generator().manual_seed(0)
    x = torch.tanh(torch.randn((R, B, 32, 32, 3), generator=gen) * 3)
    y = torch.randint(0, 10, (R, B), generator=gen)
    flat = torch.stack([layout.flatten(params) * (1 + 0.05 * r)
                        for r in range(R)])

    def grads(device, dtype=torch.float32):
        f = flat.to(device, dtype).requires_grad_(True)
        p = layout.unflatten(f)
        logits = small.cnn_logits(p, x.to(device, dtype))
        (g,) = torch.autograd.grad(
            small.cnn_loss(p, x.to(device, dtype), y.to(device)).sum(), f)
        return logits.detach().cpu().double(), g.cpu().double()

    ref = grads("cpu", torch.float64)
    for name, device in (("cpu", "cpu"), ("card", "cuda")):
        lg, g = grads(device)
        print(f"{name} float32 against float64: logits "
              f"{float((lg - ref[0]).norm() / ref[0].norm()):.3e}, "
              f"gradients {float((g - ref[1]).norm() / ref[1].norm()):.3e} "
              f"(relative L2)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    ap.add_argument("--precision", action="store_true",
                    help="the convolutions against float64 (needs a card)")
    args = ap.parse_args(argv)
    if args.precision:
        if not torch.cuda.is_available():
            raise SystemExit("--precision needs an NVIDIA card")
        print(torch.cuda.get_device_name(0))
        precision()
    else:
        from repro_torch import resolve_device
        sensitivity(resolve_device(args.device))


if __name__ == "__main__":
    main()
