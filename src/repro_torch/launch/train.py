"""The training driver's paper mode, counterpart of ``repro.launch.train``:
the paper's wireless async-FL experiment — MNIST-like data, non-IID
shards, the 784-200-10 MLP, probabilistic client selection with bandwidth
allocation, the energy ledger and an optional checkpoint.

    PYTHONPATH=src python -m repro_torch.launch.train --scheme proposed \
        --rounds 30 --clients 10 --noniid-d 5 --rho 0.05      # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --rounds 4 \
        --train-examples 1000 --local-iters 1 --device cpu

The JAX driver's flags and defaults plus ``--device`` (the card unless told
otherwise), its keys (``PRNGKey(seed)`` for the data, ``+1`` the shards,
``+2`` the positions, ``+3`` the gains, ``+4`` the model) and its printed
``[train] …`` line, so on the same flags it realizes the JAX driver's
participation masks.  ``--ckpt PATH`` writes ``PATH.npz``/``PATH.json``
in the JAX checkpoint format (the global model as its per-layer tree).
Arch mode (``--arch``) trains an LLM through ``fl/distributed.py``, which
the port does not have yet: the flag is refused.
"""
from __future__ import annotations

import argparse
import time

from .. import random as jr
from .. import resolve_device
from ..checkpoint import save_checkpoint
from ..core import CellConfig, ProblemSpec
from ..core.channel import channel_gains, sample_positions
from ..core.selection import (AgeBasedScheme, GreedyScheme, ProposedOnline,
                              RandomScheme)
from ..data import make_mnist_like, shard_noniid
from ..fl import SimConfig, SimResult, run_simulation
from ..models.small import init_mlp, mlp_accuracy, mlp_loss


def paper_mode(args) -> SimResult:
    device = resolve_device(args.device)
    K = args.clients
    tr, te = make_mnist_like(jr.PRNGKey(args.seed),
                             n_train=args.train_examples, n_test=1000,
                             device=device)
    clients = shard_noniid(jr.PRNGKey(args.seed + 1), tr, K, d=args.noniid_d)
    cell = CellConfig(num_clients=K)
    spec = ProblemSpec(cell=cell, rho=args.rho, lam=args.lam,
                       num_rounds=args.rounds)
    pos = sample_positions(jr.PRNGKey(args.seed + 2, device=device), cell)
    h = channel_gains(jr.PRNGKey(args.seed + 3, device=device), pos,
                      args.rounds).T
    policy = {
        "proposed": lambda: ProposedOnline(spec),
        "random": lambda: RandomScheme(0.1, K),
        "greedy": lambda: GreedyScheme(max(1, K // 10), K),
        "age": lambda: AgeBasedScheme(max(1, K // 10), K),
    }[args.scheme]()
    params = init_mlp(jr.PRNGKey(args.seed + 4), device=device)
    cfg = SimConfig(rounds=args.rounds, local_iters=args.local_iters,
                    batch_size=args.batch_size, lr=args.lr,
                    eval_every=max(args.rounds // 10, 1), seed=args.seed,
                    max_staleness=args.max_staleness)
    t0 = time.time()
    res = run_simulation(params, mlp_loss, mlp_accuracy, clients, te,
                         policy, h, cell, cfg, device=device)
    print(f"[train] scheme={args.scheme} rounds={args.rounds} "
          f"final_acc={res.test_acc[-1]:.4f} "
          f"total_energy_j={res.energy_per_client.sum():.2f} "
          f"({time.time() - t0:.1f}s)")
    if args.ckpt:
        save_checkpoint(args.ckpt,
                        res.state.layout.unflatten(res.state.global_params),
                        {"rounds": args.rounds, "scheme": args.scheme,
                         "acc": float(res.test_acc[-1])})
        print(f"[train] checkpoint → {args.ckpt}.npz")
    return res


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="assigned architecture id "
                    "(arch mode; not in the port yet)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--scheme", default="proposed",
                    choices=["proposed", "random", "greedy", "age"])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--noniid-d", type=int, default=5)
    ap.add_argument("--rho", type=float, default=0.05)
    ap.add_argument("--lam", type=float, default=0.01)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--local-iters", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=10)
    ap.add_argument("--train-examples", type=int, default=5000)
    ap.add_argument("--max-staleness", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--per-client-batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    return ap


def main(argv=None) -> SimResult:
    """Parse the flags and run paper mode; returns its ``SimResult``."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.arch:
        ap.error(f"--arch {args.arch}: arch mode needs fl/distributed.py and "
                 "the LLM training path, which the port does not have yet "
                 "(ROADMAP.md Queue 1 item 4)")
    return paper_mode(args)


if __name__ == "__main__":
    main()
