"""Client-selection policies (counterpart of ``repro.core.selection``): the
paper's proposed online scheme and its random benchmark.

A ``PolicyFn`` maps ``(t, h_t, sim_state) -> (probs, w)``.  Policies tagged
``state_free`` ignore ``sim_state`` and accept channel gains with leading
lane axes (``h_t: [..., K]``), so the engine solves every round of a horizon
in one call.  ``ProposedOnline`` and ``RandomScheme`` are the named shims the
examples use.  Greedy, age-based, CSMA, age-aware and the offline policy are
not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from .algorithm1 import ProblemSpec
from .online import solve_online

#: (t, h_t, sim_state) -> (probs [..., K], w [..., K])
PolicyFn = Callable[[Any, torch.Tensor, Optional[Any]],
                    Tuple[torch.Tensor, torch.Tensor]]


def _state_free(fn: PolicyFn) -> PolicyFn:
    """Tag a policy as independent of the simulation state: the engine then
    calls it once for all rounds, with ``h_t`` of shape ``[T, K]``."""
    fn.state_free = True
    return fn


def random_policy(p_bar: float, num_clients: int) -> PolicyFn:
    """Uniform probability p̄, equal reserved bandwidth (paper benchmark 1)."""

    def fn(t, h_t, state=None):
        del t, state
        shape = h_t.shape[:-1] + (num_clients,)
        probs = torch.full(shape, p_bar, dtype=h_t.dtype, device=h_t.device)
        w = torch.full(shape, 1.0 / num_clients, dtype=h_t.dtype,
                       device=h_t.device)
        return probs, w

    return _state_free(fn)


def online_policy(spec: ProblemSpec, rho=None) -> PolicyFn:
    """Paper's scheme, online variant (§IV-D): solve (P1') each round."""

    def fn(t, h_t, state=None):
        del t, state
        res = solve_online(h_t, spec, rho=rho)
        return res.p, res.w

    return _state_free(fn)


def as_policy_fn(policy) -> PolicyFn:
    """Coerce a shim (anything with ``.policy_fn``) or a bare ``PolicyFn``."""
    if hasattr(policy, "policy_fn"):
        return policy.policy_fn
    if callable(policy):
        return policy
    raise TypeError(f"not a policy: {policy!r}")


@dataclasses.dataclass
class ProposedOnline:
    """Paper's scheme, online variant (§IV-D): solve (P1') each round."""

    spec: ProblemSpec
    name: str = "proposed"

    def __post_init__(self):
        self.policy_fn = online_policy(self.spec)


@dataclasses.dataclass
class RandomScheme:
    """All clients transmit with the same probability p̄ (paper benchmark 1),
    with an equal bandwidth reservation w = 1/K."""

    p_bar: float
    num_clients: int
    name: str = "random"

    def __post_init__(self):
        self.policy_fn = random_policy(self.p_bar, self.num_clients)
