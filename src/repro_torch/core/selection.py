"""Client-selection policies (counterpart of ``repro.core.selection``): the
paper's proposed scheme (online and offline), its three §V-A benchmarks
(Random, Greedy top-k gain, Age-based round-robin), and the related-work
baselines of the scheme matrix — CSMAAFL-style channel-aware contention
(:func:`csma_policy`, arXiv:2306.01207) and Hu–Chen–Larsson max-age
scheduling (:func:`age_aware_policy`, arXiv:2212.07356; a *ledger* policy).
Their aggregation counterparts are :class:`repro_torch.fl.state.
AggregatorConfig`.

A ``PolicyFn`` maps ``(t, h_t, sim_state) -> (probs, w)``.  Policies tagged
``state_free`` ignore ``sim_state`` and take channel gains with leading lane
axes (``h_t: [..., K]``) and ``t`` as an int or a tensor of rounds that
broadcasts against the lanes, so the engine solves every round of a horizon
in one call (``t = arange(T)``, ``h_t: [T, K]``) where JAX ``vmap``s a
one-round function.  Other policies are called one round at a time, with
``h_t: [K]``.  Every policy answers on ``h_t``'s device.

The dataclass shims (``ProposedOnline``, ``GreedyScheme``, …) wrap a
policy as ``.policy_fn`` and keep the legacy ``decide(t, h_t)``.
:func:`realize` draws the Bernoulli participation for any policy, from the
threefry stream of :mod:`repro_torch.random`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Protocol, Tuple

import torch

from .. import random as jr
from .algorithm1 import ProblemSpec, solve as solve_offline
from .online import solve_online

#: (t, h_t, sim_state) -> (probs [..., K], w [..., K])
PolicyFn = Callable[[Any, torch.Tensor, Optional[Any]],
                    Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class RoundDecision:
    probs: torch.Tensor   # [K] transmit probabilities (deterministic ⇒ 0/1)
    w: torch.Tensor       # [K] bandwidth ratios allocated by the server


class Policy(Protocol):
    name: str

    def decide(self, t: int, h_t: torch.Tensor) -> RoundDecision: ...


def realize(key: torch.Tensor, decision: RoundDecision) -> torch.Tensor:
    """Bernoulli draw of the participation mask C_t (protocol Step 3):
    ``uniform(key, probs.shape) < probs`` as float32."""
    u = jr.uniform(key, tuple(decision.probs.shape),
                   device=decision.probs.device)
    return (u < decision.probs).to(torch.float32)


def participants_from_mask(mask: torch.Tensor, bucket: int):
    """Compact a realized ``[..., K]`` mask into padded transmitting index
    sets, one per leading index (a round, or every round of a horizon).

    Returns ``(idx [..., bucket] int32, valid [..., bucket] bool,
    n_tx [...] int32)``: ``idx`` holds the transmitting client ids in
    ascending order, padded with the out-of-range sentinel ``K``.  When more
    than ``bucket`` clients transmit the overflow is truncated; callers
    check ``n_tx <= bucket``.  A running count places each transmitter and
    one scatter writes them, so the host never waits for the device (no
    ``nonzero``).
    """
    K = mask.shape[-1]
    on = mask > 0
    pos = torch.cumsum(on, dim=-1)           # 1-based rank of a transmitter
    # lane `bucket` takes the non-transmitters and the overflow; it is cut
    slot = torch.where(on & (pos <= bucket), pos - 1, bucket)
    ids = torch.arange(K, device=mask.device).expand_as(slot)
    idx = torch.full(mask.shape[:-1] + (bucket + 1,), K, dtype=torch.int64,
                     device=mask.device).scatter_(-1, slot, ids)
    idx = idx[..., :bucket].to(torch.int32)
    return idx, idx < K, on.sum(dim=-1).to(torch.int32)


def realize_participants(key: torch.Tensor, decision: RoundDecision,
                         bucket: int):
    """Step 3 in index-set form: :func:`realize`, then
    :func:`participants_from_mask`."""
    return participants_from_mask(realize(key, decision), bucket)


def participant_bucket(expected: float, cap: int, floor: int = 8) -> int:
    """A padded participant-bucket size for an expected transmitting count:
    mean + 6·sqrt(mean) Poisson-tail headroom, rounded up to a power of two,
    clamped to ``[floor, cap]`` (the cap wins over the floor)."""
    m = max(float(expected), 1.0)
    need = int(m + 6.0 * m ** 0.5 + 4.0)
    b = 1 << max(int(need) - 1, 1).bit_length()
    return max(min(b, int(cap)), min(floor, int(cap)))


# ---------------------------------------------------------------------------
# policy functions
# ---------------------------------------------------------------------------


def _state_free(fn: PolicyFn) -> PolicyFn:
    """Tag a policy as independent of the simulation state: the engine then
    calls it once for all rounds, with ``h_t`` of shape ``[T, K]``."""
    fn.state_free = True
    return fn


def _ledger(fn: PolicyFn) -> PolicyFn:
    """Tag a policy as reading only the *ledger* of the simulation state,
    ``sim_state.round`` and ``sim_state.last_tx``, never the model.  It must
    take ``sim_state=None`` (the zero-staleness view)."""
    fn.ledger = True
    return fn


def policy_ledger_ok(fn: PolicyFn) -> bool:
    """True when ``fn`` can run from the ledger alone: it is either fully
    state-free or tagged :func:`_ledger`."""
    return getattr(fn, "state_free", False) or getattr(fn, "ledger", False)


def _one_hot_sets(idx: torch.Tensor, h_t: torch.Tensor, k: int):
    """``probs`` 1 and ``w`` 1/k on the clients ``idx: [..., k']`` of each
    lane, 0 elsewhere, in ``h_t``'s dtype and shape."""
    idx = idx.expand(h_t.shape[:-1] + idx.shape[-1:])
    probs = torch.zeros_like(h_t).scatter_(-1, idx, 1.0)
    w = torch.zeros_like(h_t).scatter_(-1, idx, 1.0 / k)
    return probs, w


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis (kept), adding the elements one after another in
    float32.  That is XLA's order on the CPU for rows of up to 32 elements;
    ``torch.sum`` rounds differently, by an ulp."""
    acc = x[..., :1]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j:j + 1]
    return acc


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


def greedy_policy(k: int, num_clients: int) -> PolicyFn:
    """Top-k clients by instantaneous gain [36], [38]; equal split.  Ties go
    to the lower index (a stable sort, as ``jnp.argsort``)."""
    del num_clients

    def fn(t, h_t, state=None):
        del t, state
        idx = torch.argsort(-h_t, dim=-1, stable=True)[..., :k]
        return _one_hot_sets(idx, h_t, k)

    return _state_free(fn)


def age_policy(k: int, num_clients: int) -> PolicyFn:
    """Round-robin k clients per round [33] (Lemma 3's equal-Δ′ optimum):
    clients ``(t·k + j) mod K``, j < k."""
    K = num_clients

    def fn(t, h_t, state=None):
        del state
        t = torch.as_tensor(t, device=h_t.device)
        start = (t * k) % K
        offs = torch.arange(k, device=h_t.device)
        idx = (start.unsqueeze(-1) + offs) % K
        return _one_hot_sets(idx, h_t, k)

    return _state_free(fn)


def csma_policy(k: int, num_clients: int, beta: float = 1.0) -> PolicyFn:
    """CSMAAFL-style channel-aware contention (arXiv:2306.01207): client k's
    contention share is ``c_k = h_k^β / Σ_j h_j^β``; it transmits with
    probability ``p_k = min(k·c_k, 1)`` and reserves ``w_k = p_k / Σ p``.
    β = 0 is uniform random access; large β approaches greedy."""
    del num_clients

    def fn(t, h_t, state=None):
        del t, state
        # the power in float64, rounded once: torch's float32 pow can round
        # an element differently by its position in the tensor
        hp = torch.pow(torch.clamp(h_t.to(torch.float32), min=1e-30)
                       .double(), beta).float()
        share = hp / torch.clamp(_seq_sum(hp), min=1e-30)
        probs = torch.clamp(k * share, 0.0, 1.0)
        w = probs / torch.clamp(_seq_sum(probs), min=1e-30)
        return probs.to(h_t.dtype), w.to(h_t.dtype)

    return _state_free(fn)


def age_aware_policy(k: int, num_clients: int,
                     gamma: float = 1e-3) -> PolicyFn:
    """Hu–Chen–Larsson age-aware scheduling (arXiv:2212.07356): the ``k``
    clients with the largest age Δτ_k = t − last_tx_k, ties broken toward
    the better channel (``gamma`` × the mean-normalized gain, clipped to
    [0, 1e3]); deterministic probs, equal bandwidth.

    A *ledger* policy for one round (``h_t: [K]``).  With ``state=None`` the
    ages are zero and the schedule is channel-greedy.
    """
    K = num_clients

    def fn(t, h_t, state=None):
        del t
        hf = h_t.to(torch.float32)
        if state is None:
            stale = torch.zeros(K, dtype=torch.float32, device=h_t.device)
        else:
            stale = (state.round - state.last_tx).to(torch.float32)
        tie = hf / torch.clamp(_seq_sum(hf) / K, min=1e-30)
        score = stale + gamma * torch.clamp(tie, 0.0, 1e3)
        idx = torch.argsort(-score, dim=-1, stable=True)[..., :k]
        return _one_hot_sets(idx, h_t, k)

    return _ledger(fn)


def policy_blend(policy_fns, sel: torch.Tensor) -> PolicyFn:
    """One-hot blend of a static policy panel: ``(probs, w) = Σ_i sel_i ·
    policy_i(t, h, state)`` (0/1 blending is exact).  State-free only if
    every member is; a ledger policy if every member can run from the
    ledger."""
    fns = list(policy_fns)

    def fn(t, h_t, state=None):
        outs = [p(t, h_t, state) for p in fns]
        probs = sum(sel[i] * o[0] for i, o in enumerate(outs))
        w = sum(sel[i] * o[1] for i, o in enumerate(outs))
        return probs, w

    if all(getattr(p, "state_free", False) for p in fns):
        return _state_free(fn)
    if all(policy_ledger_ok(p) for p in fns):
        return _ledger(fn)
    return fn


def online_policy(spec: ProblemSpec, rho=None) -> PolicyFn:
    """Paper's scheme, online variant (§IV-D): solve (P1') each round."""

    def fn(t, h_t, state=None):
        del t, state
        res = solve_online(h_t, spec, rho=rho)
        return res.p, res.w

    return _state_free(fn)


def _schedule_policy(res) -> PolicyFn:
    """The state-free policy that replays a solved offline schedule
    ``res.p, res.w: [K, T]``: round ``t`` (an int, or a tensor of rounds)
    reads column ``t``, ``[K]`` for an int and ``[..., K]`` for a tensor,
    on ``h_t``'s device."""
    p_all, w_all = res.p, res.w

    def fn(t, h_t, state=None):
        del state
        t = torch.as_tensor(t, device=p_all.device)
        return (p_all[:, t].movedim(0, -1).to(h_t.device),
                w_all[:, t].movedim(0, -1).to(h_t.device))

    return _state_free(fn)


def offline_policy(spec: ProblemSpec, h_all: torch.Tensor,
                   device=None) -> PolicyFn:
    """Paper's scheme, offline Algorithm 1 solved once on the full horizon
    ``h_all: [K, T]`` on ``device`` (``None`` means the card)."""
    return _schedule_policy(solve_offline(h_all, spec, device=device))


def as_policy_fn(policy) -> PolicyFn:
    """Coerce a shim (anything with ``.policy_fn``), an object with a
    ``decide(t, h_t) -> RoundDecision``, or a bare ``PolicyFn``."""
    if hasattr(policy, "policy_fn"):
        return policy.policy_fn
    if hasattr(policy, "decide"):
        def fn(t, h_t, state=None):
            del state
            dec = policy.decide(t, h_t)
            return dec.probs, dec.w

        return fn
    if callable(policy):
        return policy
    raise TypeError(f"not a policy: {policy!r}")


# ---------------------------------------------------------------------------
# Policy shims
# ---------------------------------------------------------------------------


class _FnPolicy:
    """Mixin: ``decide`` delegates to the wrapped ``policy_fn``."""

    def decide(self, t: int, h_t: torch.Tensor) -> RoundDecision:
        probs, w = self.policy_fn(t, h_t, None)
        return RoundDecision(probs=probs, w=w)


@dataclasses.dataclass
class ProposedOnline(_FnPolicy):
    """Paper's scheme, online variant (§IV-D): solve (P1') each round."""

    spec: ProblemSpec
    name: str = "proposed"

    def __post_init__(self):
        self.policy_fn = online_policy(self.spec)


@dataclasses.dataclass
class ProposedOffline(_FnPolicy):
    """Paper's scheme, offline Algorithm 1 on the full horizon of gains,
    solved once at construction on ``device`` (``None`` means the card);
    ``result`` keeps the solve's :class:`~.algorithm1.Algorithm1Result`."""

    spec: ProblemSpec
    h_all: torch.Tensor  # [K, T]
    name: str = "proposed-offline"
    device: Any = None

    def __post_init__(self):
        self.result = solve_offline(self.h_all, self.spec,
                                    device=self.device)
        self.policy_fn = _schedule_policy(self.result)


@dataclasses.dataclass
class RandomScheme(_FnPolicy):
    """All clients transmit with the same probability p̄ (paper benchmark 1),
    with an equal bandwidth reservation w = 1/K."""

    p_bar: float
    num_clients: int
    name: str = "random"

    def __post_init__(self):
        self.policy_fn = random_policy(self.p_bar, self.num_clients)


@dataclasses.dataclass
class GreedyScheme(_FnPolicy):
    """Top-k clients by instantaneous channel gain [36], [38]; equal split."""

    k: int
    num_clients: int
    name: str = "greedy"

    def __post_init__(self):
        self.policy_fn = greedy_policy(self.k, self.num_clients)


@dataclasses.dataclass
class AgeBasedScheme(_FnPolicy):
    """Round-robin k clients per round [33] — the optimum of Lemma 3's
    equal-Δ′ fairness argument."""

    k: int
    num_clients: int
    name: str = "age"

    def __post_init__(self):
        self.policy_fn = age_policy(self.k, self.num_clients)


@dataclasses.dataclass
class CsmaScheme(_FnPolicy):
    """Channel-aware contention à la CSMAAFL (arXiv:2306.01207)."""

    k: int
    num_clients: int
    beta: float = 1.0
    name: str = "csma"

    def __post_init__(self):
        self.policy_fn = csma_policy(self.k, self.num_clients, self.beta)


@dataclasses.dataclass
class AgeAwareScheme(_FnPolicy):
    """Max-age scheduling à la Hu–Chen–Larsson (arXiv:2212.07356).  The
    legacy ``decide(t, h_t)`` has no ledger, so it reports the
    zero-staleness schedule; the engine feeds the live ledger through
    ``policy_fn``."""

    k: int
    num_clients: int
    gamma: float = 1e-3
    name: str = "age-aware"

    def __post_init__(self):
        self.policy_fn = age_aware_policy(self.k, self.num_clients,
                                          self.gamma)


def average_participants(policy, h_all: torch.Tensor) -> float:
    """Expected number of transmitting clients per round under a policy
    (``h_all: [K, T]``), used to match k across schemes (paper §V-A): all
    rounds in one call for a state-free policy, else round by round with
    ``sim_state=None``."""
    fn = as_policy_fn(policy)
    T = h_all.shape[1]
    if getattr(fn, "state_free", False):
        probs = fn(torch.arange(T, device=h_all.device), h_all.T, None)[0]
    else:
        probs = torch.stack([fn(t, h_all[:, t], None)[0] for t in range(T)])
    return float(torch.sum(probs) / T)
