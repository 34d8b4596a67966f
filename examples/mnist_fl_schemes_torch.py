"""End-to-end driver on the PyTorch port: train the paper's MNIST-MLP
federated system under all four schemes and print the accuracy-per-Joule
comparison (paper Fig. 6), as ``examples/mnist_fl_schemes.py`` does.

    PYTHONPATH=src python examples/mnist_fl_schemes_torch.py [--rounds 200]
    PYTHONPATH=src python examples/mnist_fl_schemes_torch.py --rounds 8 \
        --train-examples 2000 --device cpu
"""
import argparse

import numpy as np

from repro_torch import random as jr
from repro_torch import resolve_device
from repro_torch.core import CellConfig, ProblemSpec
from repro_torch.core.channel import channel_gains, sample_positions
from repro_torch.core.selection import (AgeBasedScheme, GreedyScheme,
                                        ProposedOnline, RandomScheme,
                                        average_participants)
from repro_torch.data import make_mnist_like, shard_noniid
from repro_torch.fl import SimConfig, run_simulation
from repro_torch.models.small import init_mlp, mlp_accuracy, mlp_loss


def main(argv=None) -> dict:
    """Run the four schemes; returns the matched participation (``avg``,
    ``k``) and ``rows``: per scheme its name, final accuracy, energy (J),
    accuracy per Joule, the energy Gini index and its ``SimResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--noniid-d", type=int, default=5)
    ap.add_argument("--train-examples", type=int, default=20000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    K = args.clients
    tr, te = make_mnist_like(jr.PRNGKey(0), n_train=args.train_examples,
                             n_test=2000, device=device)
    clients = shard_noniid(jr.PRNGKey(1), tr, K, d=args.noniid_d)
    cell = CellConfig(num_clients=K)
    spec = ProblemSpec(cell=cell, rho=0.05, num_rounds=args.rounds)
    pos = sample_positions(jr.PRNGKey(2, device=device), cell)
    h = channel_gains(jr.PRNGKey(3, device=device), pos, args.rounds).T
    params = init_mlp(jr.PRNGKey(4), device=device)
    cfg = SimConfig(rounds=args.rounds, local_iters=5, batch_size=10,
                    eval_every=max(args.rounds // 20, 1))

    proposed = ProposedOnline(spec)
    avg = average_participants(proposed, h)
    k = max(1, round(avg))
    schemes = [proposed, RandomScheme(min(avg / K, 1.0), K),
               GreedyScheme(k, K), AgeBasedScheme(k, K)]
    print(f"matched participation: avg={avg:.2f} clients/round (k={k})")
    print(f"{'scheme':12s} {'final_acc':>9s} {'energy_J':>9s} "
          f"{'acc/J':>9s} {'gini':>6s}")
    rows = []
    for s in schemes:
        res = run_simulation(params, mlp_loss, mlp_accuracy, clients, te,
                             s, h, cell, cfg, device=device)
        e = res.energy_per_client
        gini = float(np.abs(e[:, None] - e[None, :]).sum()
                     / (2 * K * max(e.sum(), 1e-9)))
        acc = float(res.test_acc[-1])
        per_j = acc / max(e.sum(), 1e-9)
        print(f"{s.name:12s} {acc:9.3f} {e.sum():9.2f} {per_j:9.4f} "
              f"{gini:6.3f}")
        rows.append({"scheme": s.name, "final_acc": acc,
                     "energy_j": float(e.sum()), "acc_per_j": per_j,
                     "gini": gini, "result": res})
    return {"avg": avg, "k": k, "rows": rows}


if __name__ == "__main__":
    main()
