"""Quickstart on the PyTorch port: the paper's full pipeline in ~60 lines.

1. build a wireless cell (Table II),
2. solve the joint probabilistic-selection + bandwidth problem (Algorithm 1,
   online variant) for one round's channel state,
3. run a short asynchronous-FL training with the optimized policy and
   compare against the random baseline.

    PYTHONPATH=src python examples/quickstart_torch.py             # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The steps, keys and printed lines of ``examples/quickstart.py``.
"""
import argparse

import numpy as np

from repro_torch import random as jr
from repro_torch import resolve_device
from repro_torch.core import CellConfig, ProblemSpec, solve_online
from repro_torch.core.channel import channel_gains, sample_positions
from repro_torch.core.selection import ProposedOnline, RandomScheme
from repro_torch.data import make_mnist_like, shard_noniid
from repro_torch.fl import SimConfig, run_simulation
from repro_torch.models.small import init_mlp, mlp_accuracy, mlp_loss

K, ROUNDS = 10, 12


def main(argv=None) -> dict:
    """Run the quickstart; returns the one-round solve (``p``, ``w``,
    ``residual``) and ``runs``, each policy's ``SimResult`` by name."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    device = resolve_device(ap.parse_args(argv).device)

    # --- 1. wireless cell ----------------------------------------------------
    cell = CellConfig(num_clients=K)
    spec = ProblemSpec(cell=cell, rho=0.05, lam=0.01, num_rounds=ROUNDS)
    pos = sample_positions(jr.PRNGKey(2, device=device), cell)
    h = channel_gains(jr.PRNGKey(3, device=device), pos, ROUNDS).T  # [K, T]

    # --- 2. one-round joint optimization (P1', eqs. 31/46) -------------------
    res = solve_online(h[:, 0], spec)
    print("selection probabilities p*:", res.p.cpu().numpy().round(3))
    print("bandwidth ratios       w*:", res.w.cpu().numpy().round(3),
          "(sum=%.3f)" % float(res.w.sum()))
    print("KKT residual: %.2e  (globally optimal by Thm 2 + Jong's algorithm)"
          % float(res.residual))

    # --- 3. async FL: proposed vs random -------------------------------------
    train, test = make_mnist_like(jr.PRNGKey(0), n_train=4000, n_test=800,
                                  device=device)
    clients = shard_noniid(jr.PRNGKey(1), train, K, d=5)          # non-IID
    params = init_mlp(jr.PRNGKey(4), device=device)
    cfg = SimConfig(rounds=ROUNDS, local_iters=5, batch_size=10, eval_every=4)

    runs = {}
    for policy in (ProposedOnline(spec),
                   RandomScheme(p_bar=0.1, num_clients=K)):
        out = run_simulation(params, mlp_loss, mlp_accuracy, clients, test,
                             policy, h, cell, cfg, device=device)
        e = out.energy_per_client
        print(f"{policy.name:10s} final_acc={out.test_acc[-1]:.3f} "
              f"energy={e.sum():.2f} J "
              f"(per-client max/min={e.max() / max(e.min(), 1e-9):.1f})")
        runs[policy.name] = out
    return {"p": res.p.cpu().numpy(), "w": res.w.cpu().numpy(),
            "residual": float(res.residual), "runs": runs}


if __name__ == "__main__":
    np.set_printoptions(linewidth=120)
    main()
