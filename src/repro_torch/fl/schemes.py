"""Head-to-head async-FL scheme matrix (counterpart of ``repro.fl.schemes``).

The paper's claim is comparative — probabilistic client selection against
the traditional async-FL designs — so every competing scheme runs under the
same channel realizations, PRNG streams and energy accounting.  A scheme
is a pair:

* a **selection policy** (:mod:`repro_torch.core.selection`): the paper's
  online solve, random/greedy/age heuristics, CSMA-style contention, or
  age-aware scheduling (a *ledger* policy);
* an **aggregator** (:class:`repro_torch.fl.state.AggregatorConfig`): the
  paper's 1/K average, FedAsync-style ``s(Δτ)`` mixing, CSMAAFL importance
  weighting, or age-aware amplification.

:func:`run_scheme_matrix` runs severities × schemes × seed lanes.  JAX
``vmap``s them in one program, each lane blending the whole policy panel
with a one-hot row (exact for finite policies) and carrying its
aggregator's parameters as traced :class:`~repro_torch.fl.state.AggParams`.
PyTorch is eager, so here each lane is one run of the single-run engine —
the dense runner, or the sparse one — with its own policy and its scheme's
``AggParams``: the same lane.  Two things are shared across lanes: a
state-free policy is solved once per seed lane (every severity reads the
same gains), and the sparse path builds one phase-B program for the whole
matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core.selection import (age_aware_policy, as_policy_fn, csma_policy,
                              online_policy, participant_bucket,
                              policy_ledger_ok, random_policy)
from ..data.device import DeviceDataStore
from ..obs.taps import stack_metrics
from ..obs.telemetry import emit_run_manifest
from ..optim import Optimizer, sgd
from .engine import _as_store, _dense_runner, check_modes, solve_once
from .sparse import build_sparse_train_program, make_sparse_runner
from .state import AggregatorConfig

__all__ = ["SchemeSpec", "SchemeMatrixResult", "default_scheme_panel",
           "run_scheme_matrix", "stack_stores"]


@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """One lane of the comparison: a named (policy, aggregator) pair."""

    name: str
    policy: Any                       # a PolicyFn or a scheme object
    aggregator: AggregatorConfig

    def policy_fn(self):
        return as_policy_fn(self.policy)


def default_scheme_panel(spec, num_clients: int, rhos: Sequence[float] = (),
                         p_bar: float = 0.25) -> list[SchemeSpec]:
    """The Fig. 6-7 panel: the paper's scheme against the three baseline
    families.  ``rhos`` adds one paper lane per tradeoff coefficient (empty
    keeps a single ``rho=None`` lane); ``p_bar`` sets the baselines'
    expected participation fraction."""
    K = num_clients
    k = max(1, int(round(p_bar * K)))
    panel = []
    if rhos:
        for rho in rhos:
            panel.append(SchemeSpec(
                f"paper-rho{rho:g}", online_policy(spec, rho=float(rho)),
                AggregatorConfig(kind="paper")))
    else:
        panel.append(SchemeSpec("paper", online_policy(spec),
                                AggregatorConfig(kind="paper")))
    panel += [
        SchemeSpec("fedasync-poly", random_policy(p_bar, K),
                   AggregatorConfig(kind="fedasync", staleness_fn="poly")),
        SchemeSpec("fedasync-hinge", random_policy(p_bar, K),
                   AggregatorConfig(kind="fedasync", staleness_fn="hinge")),
        SchemeSpec("csmaafl", csma_policy(k, K),
                   AggregatorConfig(kind="csmaafl")),
        SchemeSpec("age-aware", age_aware_policy(k, K),
                   AggregatorConfig(kind="age")),
    ]
    return panel


class SchemeMatrixResult(NamedTuple):
    """Stacked lane results, leading axes ``[V, L, S]`` = severities ×
    schemes × seed lanes."""

    schemes: tuple                 # L lane names
    acc: np.ndarray                # [V, L, S, n_evals]
    loss: np.ndarray               # [V, L, S, n_evals]
    eval_rounds: np.ndarray        # [n_evals]
    energy: np.ndarray             # [V, L, S, K] cumulative Joules
    energy_timeline: np.ndarray    # [V, L, S, T] cumulative total Joules
    participation: np.ndarray      # [V, L, S, T, K]
    # each lane's MetricsState, stacked on [V, L, S], when cfg.metrics
    # enables taps; None otherwise
    metrics: Any = None


def stack_stores(stores: Sequence[DeviceDataStore]) -> DeviceDataStore:
    """Stack same-shaped severity stores on a leading axis.  Build them
    with a shared ``pad_to`` (severity changes the per-client distribution,
    not the padded shapes)."""
    def sig(s):
        return [(tuple(t.shape), t.dtype) for t in s]

    first = sig(stores[0])
    for s in stores[1:]:
        if sig(s) != first:
            raise ValueError(
                "severity stores must share shapes and dtypes to stack — "
                "build them with a common pad_to cap")
    return DeviceDataStore(*(torch.stack(ts) for ts in zip(*stores)))


def _severity_stores(stores, device) -> list[DeviceDataStore]:
    """One store, or a sequence of stores / shard lists (one a severity),
    as a list of same-shaped stores on ``device``."""
    if isinstance(stores, DeviceDataStore):
        return [_as_store(stores, device)]
    stack = stack_stores([_as_store(s, device) for s in stores])
    return [DeviceDataStore(*(t[v] for t in stack))
            for v in range(stack.x.shape[0])]


def _shared_bucket(fns, lane0: list, h_rounds: torch.Tensor,
                   num_clients: int) -> int:
    """The panel's largest expected transmitting mass on seed lane 0, with
    Poisson headroom: state-free policies from their solve, ledger policies
    round by round at zero staleness (``state=None``)."""
    expected = 0.0
    for fn, pol in zip(fns, lane0):
        T = h_rounds.shape[0]
        if getattr(fn, "state_free", False):
            ts = torch.arange(T, device=h_rounds.device)
            probs = pol(ts, h_rounds, None)[0]
        else:
            probs = torch.stack([fn(t, h_rounds[t], None)[0]
                                 for t in range(T)])
        expected = max(expected, float(torch.max(
            torch.sum(probs.to(torch.float32), dim=-1))))
    return participant_bucket(expected, cap=num_clients)


def run_scheme_matrix(init_params, loss_fn: Callable, acc_fn: Callable,
                      stores, test_ds, schemes: Sequence[SchemeSpec],
                      h_stack, cell, cfg, seeds: Sequence[int],
                      opt: Optimizer | None = None,
                      participation: str = "dense",
                      device=None) -> SchemeMatrixResult:
    """Every severity × scheme × seed lane, on ``device`` (``None`` means
    the card).

    ``stores``: one :class:`DeviceDataStore`, or a sequence of stores or
    shard lists, one per non-IID severity (same shapes: see
    :func:`stack_stores`).  ``h_stack: [S, K, T]`` pairs channel
    realizations with ``seeds`` as in
    :func:`~repro_torch.fl.engine.run_seed_matrix`.  ``participation``
    picks the dense engine or the sparse two-phase one (its preconditions
    on ``cfg`` and state-free or ledger policies; one shared bucket, from
    the panel's largest expected mass unless ``cfg.participant_bucket`` is
    set, and one phase-B build for the matrix).  ``cfg.aggregator`` is
    replaced by each scheme's; ``cfg.faults`` and ``cfg.guards`` apply to
    every lane.
    """
    if not schemes:
        raise ValueError("run_scheme_matrix needs at least one SchemeSpec")
    if participation not in ("dense", "sparse"):
        raise ValueError(f"unknown participation {participation!r} "
                         "(expected dense|sparse)")
    device = resolve_device(device)
    h = torch.as_tensor(h_stack, dtype=torch.float32).to(device)
    S, K, T = (int(n) for n in h.shape)
    L = len(schemes)
    if S != len(seeds):
        raise ValueError(f"h_stack has {S} lanes for {len(seeds)} seeds")
    opt = opt or sgd(cfg.lr)
    fns = [s.policy_fn() for s in schemes]
    # every lane takes the scheme path; its AggParams pick the weights
    run_cfg = dataclasses.replace(cfg, rounds=T,
                                  aggregator=schemes[0].aggregator)
    check_modes(run_cfg)
    severity = _severity_stores(stores, device)
    V = len(severity)
    if severity[0].num_clients != K:
        raise ValueError(f"store client axis {severity[0].num_clients} != "
                         f"channel stack K {K}")
    aps = [s.aggregator.params(device) for s in schemes]
    emit_run_manifest("run_scheme_matrix", run_cfg,
                      extra={"path": participation, "schemes": L,
                             "lanes": S, "severities": V, "num_clients": K})

    if participation == "sparse":
        for s, fn in zip(schemes, fns):
            if not policy_ledger_ok(fn):
                raise ValueError(
                    f"scheme {s.name!r}: the sparse path needs a state_free "
                    "or ledger policy")
        if run_cfg.local_mode != "participants":
            raise ValueError("sparse scheme matrix requires "
                             "SimConfig(local_mode='participants')")
        if run_cfg.data_stream != "client":
            raise ValueError("sparse scheme matrix requires "
                             "SimConfig(data_stream='client')")

    # [l][s]: a state-free policy solved once per seed lane, shared by
    # every severity
    pols = [[solve_once(fn, h[s]) for s in range(S)] for fn in fns]
    if participation == "dense":
        def make(store, pol):
            return _dense_runner(loss_fn, acc_fn, store, test_ds, pol,
                                 cell, run_cfg, opt, device=device)
    else:
        bucket = run_cfg.participant_bucket or _shared_bucket(
            fns, [p[0] for p in pols], h[0].T, K)
        lane_cfg = dataclasses.replace(run_cfg, participant_bucket=bucket,
                                       overflow="error")
        train = build_sparse_train_program(loss_fn, acc_fn, opt,
                                           lane_cfg)

        def make(store, pol):
            return make_sparse_runner(loss_fn, acc_fn, store, test_ds,
                                      pol, cell, lane_cfg, opt,
                                      device=device, train_program=train)

    lanes = [make(severity[v], pols[l][s])(
        init_params, h[s], seed=int(seeds[s]), agg_params=aps[l])
        for v in range(V) for l in range(L) for s in range(S)]

    def stack(field):
        a = np.stack([getattr(r, field) for r in lanes])
        return a.reshape((V, L, S) + a.shape[1:])

    return SchemeMatrixResult(
        schemes=tuple(s.name for s in schemes), acc=stack("test_acc"),
        loss=stack("test_loss"), eval_rounds=lanes[0].eval_rounds,
        energy=stack("energy_per_client"),
        energy_timeline=stack("energy_timeline"),
        participation=stack("participation"),
        metrics=stack_metrics([r.metrics for r in lanes], (V, L, S)))
