"""The parts of Algorithm 1 (paper §IV) that the online solve needs:
``ProblemSpec`` and the (P4) bandwidth step — the Lambert-W closed form (31)
with a dual search on v (33).  Counterpart of ``repro.core.algorithm1``;
the offline solve (``solve``, ``solve_p3``) is not ported yet.

Every function here takes an optional leading lane axis: ``ab`` and ``h``
are ``[..., K]``, and each lane is solved independently.  Data-dependent
loops freeze finished lanes with ``torch.where(active, new, old)``, as a
vmapped JAX ``while_loop`` does, so each lane gives what the unbatched solve
gives.
"""
from __future__ import annotations

import dataclasses

import torch

from .channel import CellConfig
from .lambertw import lambertw


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """Instance of (P1): channel realizations + scalarization knobs."""

    cell: CellConfig
    rho: float = 0.05            # tradeoff coefficient ρ
    lam: float = 0.01            # fairness floor λ (eq. 14)
    num_rounds: int = 50         # T

    @property
    def T(self) -> int:
        return self.num_rounds

    @property
    def K(self) -> int:
        return self.cell.num_clients


def _w_of_v_fn(ab: torch.Tensor, h: torch.Tensor, cell: CellConfig):
    """Eq. (31) as a function of v alone, with the v-free terms computed
    once (the same float32 operations as :func:`w_of_v`)."""
    W, N0, P = cell.bandwidth_hz, cell.noise_w_per_hz, cell.tx_power_w
    a = torch.clamp(ab * W, min=1e-30)
    Ph = P * h

    def w(v):
        A = 1.0 + v / a
        inner = lambertw(-torch.exp(-A)) + A
        denom = W * N0 * torch.expm1(inner)
        return torch.clamp(Ph / torch.clamp(denom, min=1e-30), 0.0, 1.0)

    return w


def w_of_v(v: torch.Tensor, ab: torch.Tensor, h: torch.Tensor,
           cell: CellConfig) -> torch.Tensor:
    """Eq. (31): w*(v) for the dual variable v ≥ 0 (broadcast against
    ``ab = α·β`` and ``h``), clipped to [0, 1].

    ``A = 1 + v/(αβW)``;  ``w = P h / (W N0 (exp[W0(−e^{−A}) + A] − 1))``.
    """
    return _w_of_v_fn(ab, h, cell)(v)


def solve_p4(ab: torch.Tensor, h: torch.Tensor, cell: CellConfig,
             iters: int = 60, w_floor: float = 1e-4,
             active: torch.Tensor | None = None) -> torch.Tensor:
    """Per-round bandwidth allocation: the v ≥ 0 with Σ_k w(v) = 1, or v = 0
    when the unconstrained optimum already fits (complementary slackness).
    Σ_k w(v) decreases in v, so an exponential bracket search and up to
    ``iters`` bisection steps find it.

    ``ab, h: [..., K]``; returns ``w*: [..., K]`` floored at ``w_floor``.
    ``active`` (``[...]`` bool) limits the loops to the lanes whose result
    the caller keeps; the other lanes' output is unspecified.

    The bisection stops early once a step leaves every active lane's
    bracket unchanged: from then on each step recomputes the same midpoint
    and the same decision, so the result is the one all ``iters`` steps
    give.  In float32 that happens after some 30 steps.
    """
    w_fn = _w_of_v_fn(ab, h, cell)

    def total(v):
        return w_fn(v.unsqueeze(-1)).sum(-1)

    if active is None:
        active = torch.ones(h.shape[:-1], dtype=torch.bool, device=h.device)
    hi = torch.clamp(ab.amax(-1) * cell.bandwidth_hz, min=1.0)
    lo = torch.zeros_like(hi)
    grow = (total(hi) > 1.0) & active
    while bool(grow.any()):
        hi = torch.where(grow, hi * 4.0, hi)
        grow = grow & (total(hi) > 1.0)

    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        over = total(mid) > 1.0
        lo_n, hi_n = torch.where(over, mid, lo), torch.where(over, hi, mid)
        moved = ((lo_n != lo) | (hi_n != hi)) & active
        lo, hi = lo_n, hi_n
        if not bool(moved.any()):
            break
    w = w_fn((0.5 * (lo + hi)).unsqueeze(-1))
    w0 = w_fn(torch.zeros_like(lo).unsqueeze(-1))
    w = torch.where((w0.sum(-1) <= 1.0).unsqueeze(-1), w0, w)
    return torch.clamp(w, w_floor, 1.0)
