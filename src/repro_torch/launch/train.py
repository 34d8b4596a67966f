"""End-to-end training driver, counterpart of ``repro.launch.train``.

Two modes:

* paper mode (default): the paper's wireless async-FL experiment —
  MNIST-like data, non-IID shards, the 784-200-10 MLP, probabilistic client
  selection with bandwidth allocation, the energy ledger and an optional
  checkpoint.

    PYTHONPATH=src python -m repro_torch.launch.train --scheme proposed \
        --rounds 30 --clients 10 --noniid-d 5 --rho 0.05      # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --rounds 4 \
        --train-examples 1000 --local-iters 1 --device cpu

* arch mode (``--arch``): FL training of an assigned architecture on
  synthetic token streams through the same probabilistic-selection round
  loop (``fl/distributed.py``'s replica mode; K1 aggregates each round).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --reduced --rounds 10 --clients 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --rounds 3 --clients 4                  # full width, on the card

The JAX driver's flags and defaults plus ``--device`` (the card unless told
otherwise), its keys (``PRNGKey(seed)`` for the data, ``+1`` the shards,
``+2`` the positions, ``+3`` the gains, ``+4`` the model) and its printed
``[train] …`` lines, so on the same flags it realizes the JAX driver's
participation masks.  Arch mode keeps JAX's keys too (``PRNGKey(seed)``
the positions, ``+1`` the gains, ``+2`` the token stream, ``+3`` the
model, ``+4`` the masks) and prints its ``[train] round t: loss=…
participants=… energy_j=…`` line a round.  ``--ckpt PATH`` writes
``PATH.npz``/``PATH.json`` in the JAX checkpoint format (the global model
as its per-layer tree).
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import configs
from .. import random as jr
from .. import resolve_device
from ..checkpoint import save_checkpoint
from ..convert import transformer_to_numpy
from ..core import CellConfig, ProblemSpec
from ..core.channel import channel_gains, rate_nats, sample_positions
from ..core.selection import (AgeBasedScheme, GreedyScheme, ProposedOnline,
                              RandomScheme, realize)
from ..data import make_mnist_like, make_token_stream, shard_noniid
from ..fl import SimConfig, SimResult, run_simulation
from ..fl.distributed import (DistFLState, fl_train_step, init_dist_state,
                              row_layout)
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


def arch_mode(args) -> tuple[DistFLState, list[dict]]:
    """FL rounds of ``args.arch`` under the online (P1') policy; returns the
    final state and each round's ``{"loss", "participants",
    "energy_j"}``."""
    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    K = args.clients
    spec_cell = CellConfig(num_clients=K)
    spec = ProblemSpec(cell=spec_cell, rho=args.rho, num_rounds=args.rounds)
    pos = sample_positions(jr.PRNGKey(args.seed, device=device), spec_cell)
    h = channel_gains(jr.PRNGKey(args.seed + 1, device=device), pos,
                      args.rounds).T
    policy = ProposedOnline(spec)

    S, B = args.seq_len, args.per_client_batch
    ds = make_token_stream(jr.PRNGKey(args.seed + 2), n_seqs=K * B * 4,
                           vocab=cfg.vocab, seq_len=S, device=device)
    toks = ds.x.reshape(-1, K, B, S)
    state = init_dist_state(jr.PRNGKey(args.seed + 3), cfg, K, device=device)
    key = jr.PRNGKey(args.seed + 4, device=device)
    rounds = []
    for t in range(args.rounds):
        dec = policy.decide(t, h[:, t])
        key, sub = jr.split(key)
        mask = realize(sub, dec)
        batch = {"tokens": toks[t % toks.shape[0]]}
        state, metrics = fl_train_step(state, cfg, batch, mask, args.lr)
        R = rate_nats(dec.w, h[:, t], spec_cell.tx_power_w,
                      spec_cell.bandwidth_hz, spec_cell.noise_w_per_hz)
        e = float(torch.sum(mask * spec_cell.tx_power_w
                            * spec_cell.model_size_nats
                            / torch.clamp(R, min=1e-30)))
        rounds.append({"loss": float(metrics["loss"]),
                       "participants": int(metrics["participants"]),
                       "energy_j": e})
        print(f"[train] round {t}: loss={rounds[-1]['loss']:.4f} "
              f"participants={rounds[-1]['participants']} energy_j={e:.3f}")
    if args.ckpt:
        model = row_layout(cfg).module(cfg, state.global_params)
        save_checkpoint(args.ckpt, transformer_to_numpy(model),
                        {"arch": cfg.name, "rounds": args.rounds})
        print(f"[train] checkpoint → {args.ckpt}.npz")
    return state, rounds


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="assigned architecture id "
                    "(arch mode: FL training of an LLM)")
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


def main(argv=None):
    """Parse the flags and run arch mode (``--arch``; returns the final
    :class:`DistFLState` and the rounds' metrics) or paper mode (returns
    its ``SimResult``)."""
    args = parser().parse_args(argv)
    if args.arch:
        return arch_mode(args)
    return paper_mode(args)


if __name__ == "__main__":
    main()
