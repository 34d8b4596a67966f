"""FL-train a (reduced) assigned LLM architecture with probabilistic client
selection on the PyTorch port — the mega-arch integration path.

    PYTHONPATH=src python examples/llm_federated_torch.py        # the card
    PYTHONPATH=src python examples/llm_federated_torch.py \
        --arch qwen3-moe-30b-a3b --device cpu

The steps, keys and printed lines of ``examples/llm_federated.py``: each
client owns a fixed corpus shard in a device-resident store, and every
round samples its ``[K, B, S]`` batch on the device from
``fold_in(data_key, t)`` (``fl.distributed.fl_train_step_from_store``),
so the horizon needs no pre-stacked data.
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch import random as jr
from repro_torch import resolve_device
from repro_torch.core import CellConfig, ProblemSpec
from repro_torch.core.channel import channel_gains, sample_positions
from repro_torch.core.selection import ProposedOnline, realize
from repro_torch.data import (Dataset, data_stream_key, from_client_datasets,
                              make_token_stream)
from repro_torch.fl.distributed import (fl_train_step_from_store,
                                        init_dist_state)


def main(argv=None) -> list[dict]:
    """Run the example; returns each round's ``{"loss", "probs", "tx"}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=configs.names())
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = configs.get(args.arch).reduced()
    K, B, S = args.clients, 2, args.seq_len
    cell = CellConfig(num_clients=K)
    spec = ProblemSpec(cell=cell, rho=0.05, num_rounds=args.rounds)
    pos = sample_positions(jr.PRNGKey(0, device=device), cell)
    h = channel_gains(jr.PRNGKey(1, device=device), pos, args.rounds).T
    policy = ProposedOnline(spec)

    ds = make_token_stream(jr.PRNGKey(2), n_seqs=K * 4 * B, vocab=cfg.vocab,
                           seq_len=S, device=device)
    per_client = ds.x.reshape(K, 4 * B, S)
    store = from_client_datasets(
        [Dataset(per_client[k], torch.zeros(4 * B, dtype=torch.int32),
                 cfg.vocab) for k in range(K)], device=device)
    data_key = data_stream_key(2, device=device)
    state = init_dist_state(jr.PRNGKey(3), cfg, K, device=device)
    key = jr.PRNGKey(4, device=device)
    print(f"[llm-fl] {cfg.name}: K={K} clients, probabilistic selection")
    rounds = []
    for t in range(args.rounds):
        dec = policy.decide(t, h[:, t])
        key, sub = jr.split(key)
        mask = realize(sub, dec)
        state, m = fl_train_step_from_store(state, cfg, store, data_key, t,
                                            mask, 0.05, B)
        probs = np.round(dec.probs.cpu().numpy(), 3)
        rounds.append({"loss": float(m["loss"]), "probs": probs,
                       "tx": int(m["participants"])})
        print(f"  round {t}: loss={rounds[-1]['loss']:.4f} p*={probs} "
              f"tx={rounds[-1]['tx']}")
    first, last = rounds[0]["loss"], rounds[-1]["loss"]
    print(f"[llm-fl] loss {first:.4f} → {last:.4f} "
          f"({'improved' if last < first else 'no improvement'})")
    return rounds


if __name__ == "__main__":
    main()
