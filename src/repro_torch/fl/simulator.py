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

:func:`run_simulation` runs the engine :func:`make_runner` picks: the dense
one, or the participant-centric sparse one (:mod:`repro_torch.fl.sparse`).
:func:`run_simulation_legacy` is JAX's host-side round loop, kept as its
own code path: each round decides on the host's side of the loop, syncs
the mask and energy to numpy, and dispatches the round transition that
:func:`make_round_fn` builds.  It shares the per-round pieces and the
``fold_in`` streams of the engines (``apply_round_decision``, the fault
processes, the data paths' draws), so it realizes their masks bit for bit:
it is the witness the engines are held against, and their wall-clock
baseline.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import random as jr
from .. import resolve_device
from ..core.channel import CellConfig
from ..core.selection import as_policy_fn
from ..data.device import (StreamingSampler, data_stream_key,
                           from_client_datasets, sample_round,
                           sample_round_client_stream)
from ..data.pipeline import BatchIterator, client_batches
from ..data.synthetic import Dataset
from ..obs.taps import (MetricsSpec, init_metrics, merge_metrics,
                        metrics_active, metrics_numpy, update_ledger_taps,
                        update_train_taps)
from ..optim import Optimizer, sgd
from .engine import (SimConfig, SimResult, _shards, apply_round_decision,
                     check_modes, empty_client_batches, make_local_train,
                     make_runner, resolve_data_path)
from .faults import apply_faults, corrupt_deltas, init_fault_state
from .state import (broadcast_to_participants, guarded_aggregate,
                    init_fl_state, masked_aggregate, pseudo_gradients,
                    scheme_aggregate)

__all__ = ["SimConfig", "SimResult", "run_simulation",
           "run_simulation_legacy", "make_round_fn"]


def make_round_fn(loss_fn: Callable, opt: Optimizer, local_iters: int,
                  num_clients: int, local_mode: str = "continuous",
                  faults=None, guards=None, aggregator=None,
                  metrics: MetricsSpec | None = None, device=None):
    """The per-round transition over the stacked client rows:
    ``fl_round(state, mask, xb, yb, delivered=None, corrupt=None,
    probs=None, mstate=None) -> state``.

    Local training (``xb [K, L, B, ...]``; ``local_iters`` is its L), the
    participants-mode keep, :func:`~repro_torch.fl.faults.corrupt_deltas`
    on the ``corrupt`` rows, then the engines' aggregation on K1:
    ``aggregator`` set → scheme weights (guards fold in) over the nominal
    ``probs``, else active ``guards`` → guarded, else plain eq. 3; then the
    broadcast to the ``delivered`` set (default: ``mask``).  When
    ``metrics`` enables a train tap the transition also takes the running
    :class:`~repro_torch.obs.taps.MetricsState` and returns ``(state,
    metrics_state)``.  The faults' and aggregator's parameters live on
    ``device`` (``None`` means the card)."""
    del local_iters
    device = resolve_device(device)
    local_train = make_local_train(loss_fn, opt)
    fparams = faults.params(device) if faults is not None else None
    aparams = aggregator.params(device) if aggregator is not None else None
    active = guards if guards is not None and guards.active else None
    ttap = metrics_active(metrics, active, parts="train")

    @torch.no_grad()
    def fl_round(state, mask, xb, yb, delivered=None, corrupt=None,
                 probs=None, mstate=None):
        landed = mask if delivered is None else delivered
        client = local_train(state.client_params, xb, yb, state.layout)
        if local_mode == "participants":
            client = torch.where(landed.bool()[:, None], client,
                                 state.client_params)
        state = state._replace(client_params=client)
        deltas = pseudo_gradients(state)
        if faults is not None and corrupt is not None:
            deltas = corrupt_deltas(deltas, corrupt, fparams, faults)
        staleness = state.round - state.last_tx
        if probs is None:
            probs = torch.zeros(num_clients, dtype=torch.float32,
                                device=landed.device)
        if aggregator is not None:
            new_global = scheme_aggregate(state.global_params, deltas,
                                          landed, num_clients, staleness,
                                          probs, aparams, guards=active)
        elif active is not None:
            new_global = guarded_aggregate(state.global_params, deltas,
                                           landed, num_clients, staleness,
                                           active)
        else:
            new_global = masked_aggregate(state.global_params, deltas,
                                          landed, num_clients)
        state = broadcast_to_participants(state, new_global, landed)
        if not ttap:
            return state
        return state, update_train_taps(
            mstate, metrics, deltas=deltas, delivered=landed,
            staleness=staleness, probs=probs, num_clients=num_clients,
            guards=active, agg_params=aparams)

    return fl_round


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
    """Run all rounds on ``device`` (``None`` means the card), the client
    axis never placed over several cards, as JAX's ``run_simulation``."""
    return make_runner(loss_fn, acc_fn, client_data, test_ds, policy, cell,
                       cfg, opt, device=device,
                       shard_clients=False)(init_params, h_all)


@torch.no_grad()
def run_simulation_legacy(init_params,
                          loss_fn: Callable,
                          acc_fn: Callable,
                          client_data: list[Dataset],
                          test_ds: Dataset,
                          policy,
                          h_all: torch.Tensor,
                          cell: CellConfig,
                          cfg: SimConfig,
                          opt: Optimizer | None = None,
                          device=None) -> SimResult:
    """The host-side round loop on ``device`` (``None`` means the card).

    Each round: the policy on the current state, the decision on
    ``fold_in(seed, t)`` (:func:`~repro_torch.fl.engine.
    apply_round_decision`), the fault pipeline on its salted streams, the
    mask, energy and deliveries read back to numpy (the energy ledger
    accumulates there, in float32, as JAX's does), the ledger taps, then
    the :func:`make_round_fn` transition (which carries the train taps) and
    the strided eval (every ``eval_every`` rounds and the last, whatever
    ``eval_mode``).  The minibatches come from the path
    :func:`~repro_torch.fl.engine.resolve_data_path` resolves:
    ``"prestack"`` draws each round from per-client ``BatchIterator``\\ s
    (seeds ``cfg.seed + 17k``), ``"device"`` from the store on
    ``fold_in(data_key, t)`` (the per-client stream with
    ``data_stream="client"``), ``"stream"`` one-round chunks of a
    :class:`~repro_torch.data.device.StreamingSampler`."""
    check_modes(cfg)
    device = resolve_device(device)
    K = len(client_data)
    opt = opt or sgd(cfg.lr)
    policy_fn = as_policy_fn(policy)
    state = init_fl_state(init_params, K, device=device)
    round_fn = make_round_fn(loss_fn, opt, cfg.local_iters, K,
                             local_mode=cfg.local_mode, faults=cfg.faults,
                             guards=cfg.guards, aggregator=cfg.aggregator,
                             metrics=cfg.metrics, device=device)
    base_key = jr.PRNGKey(cfg.seed, device=device)
    h_rounds = torch.as_tensor(h_all, dtype=torch.float32).to(device).T

    # the ledger taps accumulate here, round by round, on the engines' [K]
    # vectors; the train taps ride through round_fn
    ltap = metrics_active(cfg.metrics, None, parts="ledger")
    ttap = metrics_active(cfg.metrics, cfg.guards, parts="train")
    ms_l = init_metrics(cfg.metrics, K, None, parts="ledger", device=device)
    ms_t = init_metrics(cfg.metrics, K, cfg.guards, parts="train",
                        device=device)

    if cfg.faults is not None:
        fstate = init_fault_state(K, device)
        fparams = cfg.faults.params(device)

    data_path = resolve_data_path(client_data, cfg, device=device)
    L, B = cfg.local_iters, cfg.batch_size
    if data_path == "prestack":
        shards = _shards(client_data, data_path)
        if L == 0:
            empty = tuple(a.to(device)
                          for a in empty_client_batches(shards, cfg))
        iters = [BatchIterator(ds, B, seed=cfg.seed + 17 * k)
                 for k, ds in enumerate(shards)]

        def sample(t):
            if L == 0:
                return empty
            step = [client_batches(iters) for _ in range(L)]
            return (torch.stack([x for x, _ in step], dim=1).to(device),
                    torch.stack([y for _, y in step], dim=1).to(device))
    elif data_path == "device":
        store = from_client_datasets(client_data, device=device)
        data_key = data_stream_key(cfg.seed, device=device)
        draw = (sample_round_client_stream if cfg.data_stream == "client"
                else sample_round)

        def sample(t):
            return draw(store, data_key, t, L, B)
    else:   # the shards stay on the host: one-round chunks of the stream
        sampler = StreamingSampler(_shards(client_data, data_path),
                                   data_stream_key(cfg.seed), L, B,
                                   device=device)

        def sample(t):
            return tuple(c[0] for c in sampler.chunk(t, t + 1))

    energy = np.zeros((K,), np.float32)
    energy_tl = np.zeros((cfg.rounds,))
    parts = np.zeros((cfg.rounds, K), np.float32)
    delivered_tl = np.zeros((cfg.rounds, K), np.float32)
    corrupt_tl = np.zeros((cfg.rounds, K), np.float32)
    accs, losses, eval_rounds = [], [], []
    test_x = test_ds.x[: cfg.eval_batch].to(device)
    test_y = test_ds.y[: cfg.eval_batch].to(device)

    for t in range(cfg.rounds):
        xb, yb = sample(t)
        h_t = h_rounds[t]
        # the policy's nominal probs (before the aging boost) feed the
        # scheme weights; the decision is the engines'
        probs, w = policy_fn(t, h_t, state)
        mask, forced, w, e_round = apply_round_decision(
            probs, w, jr.fold_in(base_key, t), h_t, state, cfg, cell, K)
        e_base = e_round
        delivered = corrupt = None
        if cfg.faults is not None:
            out, fstate = apply_faults(t, base_key, mask, e_round, fstate,
                                       fparams, cfg.faults)
            delivered, corrupt, e_round = (out.delivered, out.corrupt,
                                           out.e_round)
            delivered_tl[t] = delivered.cpu().numpy()
            corrupt_tl[t] = corrupt.cpu().numpy()
        energy += e_round.cpu().numpy()
        energy_tl[t] = energy.sum()
        parts[t] = mask.cpu().numpy()
        if ltap:
            ms_l = update_ledger_taps(
                ms_l, cfg.metrics, mask=mask, forced=forced, e_base=e_base,
                e_round=e_round, staleness=state.round - state.last_tx,
                delivered=mask if delivered is None else delivered)
        if ttap:
            state, ms_t = round_fn(state, mask, xb, yb, delivered, corrupt,
                                   probs, ms_t)
        else:
            state = round_fn(state, mask, xb, yb, delivered, corrupt, probs)
        if t % cfg.eval_every == 0 or t == cfg.rounds - 1:
            g = state.layout.unflatten(state.global_params)
            accs.append(float(acc_fn(g, test_x, test_y)))
            losses.append(float(loss_fn(g, test_x, test_y)))
            eval_rounds.append(t)

    faulty = cfg.faults is not None
    return SimResult(np.asarray(accs), np.asarray(losses),
                     np.asarray(eval_rounds), energy, energy_tl, parts, state,
                     delivered=delivered_tl if faulty else None,
                     corrupted=corrupt_tl if faulty else None,
                     metrics=metrics_numpy(merge_metrics(ms_l, ms_t)))
