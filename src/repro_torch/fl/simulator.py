"""Paper-faithful asynchronous-FL simulator (§II protocol, Fig. 1),
counterpart of ``repro.fl.simulator``.

Per round t:
  1. every client runs ``local_iters`` SGD steps on its own shard
     (``local_mode="participants"``: only the transmitting clients' steps
     are kept);
  2. the server computes the round's policy (p_{k,t}, w_{k,t});
  3. each client independently draws Bernoulli(p_{k,t}) — forced when its
     staleness reaches its Δ_k bound;
  4. participants upload δ_k = x_k − y_k on their sub-channel (energy
     ledger: P_k · S / R_{k,t});
  5. the server applies x ← x + (1/K)Σδ_k and broadcasts x to participants.

``cfg.participation`` chooses the engine as in :func:`make_runner`: the
dense one, or the participant-centric sparse one
(:mod:`repro_torch.fl.sparse`).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.channel import CellConfig
from ..data.synthetic import Dataset
from ..optim import Optimizer
from .engine import SimConfig, SimResult, make_runner

__all__ = ["SimConfig", "SimResult", "run_simulation"]


def run_simulation(init_params,
                   loss_fn: Callable,
                   acc_fn: Callable,
                   client_data: list[Dataset],
                   test_ds: Dataset,
                   policy,
                   h_all: torch.Tensor,        # [K, rounds] channel gains
                   cell: CellConfig,
                   cfg: SimConfig,
                   opt: Optimizer | None = None,
                   device=None) -> SimResult:
    """Run all rounds on ``device`` (``None`` means the card)."""
    return make_runner(loss_fn, acc_fn, client_data, test_ds, policy, cell,
                       cfg, opt, device=device)(init_params, h_all)
