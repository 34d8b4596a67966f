"""Algorithm 1: globally-optimal joint probabilistic client selection and
bandwidth allocation (paper §IV), counterpart of ``repro.core.algorithm1``.

Layers:
  inner  (P3)  closed-form BCD for the selection probabilities  (eq. 26)
  inner  (P4)  Lambert-W closed form for bandwidth + dual search on v (eqs. 31/33)
  outer        modified-Newton updates of (α, β, γ)             (eqs. 37-40)

:func:`solve` is the offline solve on ``h: [K, T]``; the online (P1') solve
(:mod:`.online`) uses :func:`solve_p4` alone.  :func:`solve_p4` and
:func:`w_of_v` take an optional leading lane axis: ``ab`` and ``h`` are
``[..., K]``, and each lane is solved independently.  Data-dependent loops
freeze finished lanes with ``torch.where(active, new, old)``, as a vmapped
JAX ``while_loop`` does, so each lane gives what the unbatched solve gives.
The loops run on the host, one small operation at a time, so on the card
the offline solve is bound by launches, not by the card.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import resolve_device
from .channel import CellConfig, rate_nats
from .fractional import newton_targets, newton_update, residuals
from .lambertw import lambertw

#: 1/3 rounded to float32, the exponent JAX's float32 ``** (1.0 / 3.0)`` uses
_THIRD = float(torch.tensor(1.0 / 3.0, dtype=torch.float32))


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


class Algorithm1Result(NamedTuple):
    p: torch.Tensor          # [K, T] optimal selection probabilities
    w: torch.Tensor          # [K, T] optimal bandwidth ratios
    objective: torch.Tensor  # value of (11)
    residual: torch.Tensor   # final sq-norm of (19)
    iters: torch.Tensor      # outer iterations used (int32)


def objective_p1(p: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                 spec: ProblemSpec) -> torch.Tensor:
    """Eq. (11) for ``p, w, h: [K, T]``."""
    c = spec.cell
    R = rate_nats(w, h, c.tx_power_w, c.bandwidth_hz, c.noise_w_per_hz)
    conv = spec.rho * spec.T**2 / spec.K * torch.sum(torch.sum(p, 1) ** -2)
    energy = (1.0 - spec.rho) * torch.sum(
        p * c.tx_power_w * c.model_size_nats / torch.clamp(R, min=1e-30))
    return conv + energy


def solve_p3(alpha: torch.Tensor, spec: ProblemSpec, p0: torch.Tensor,
             sweeps: int = 60) -> torch.Tensor:
    """(P3): block-coordinate descent over t for every client k (vectorized
    over k, Gauss–Seidel in t, so the loop over t stays).

    Stationarity (25) gives the target row-sum  s_{k,t} = (2ρT² / (K α_{k,t}
    P_k S (1−ρ)))^{1/3}; each coordinate update is
    p_{k,t} ← clip(s_{k,t} − Σ_{j≠t} p_{k,j}, λ, 1), with the row sum
    recomputed at every step, as JAX does (no running sum).  The power is
    taken in float64 and rounded once, so an element's bits do not depend on
    its position in the tensor.
    """
    c = spec.cell
    denom = spec.K * alpha * c.tx_power_w * c.model_size_nats * (1 - spec.rho)
    s = torch.pow((2.0 * spec.rho * spec.T**2 / denom).double(),
                  _THIRD).float()
    # round-major copies: row t is round t's coordinate of every client
    pt = p0.T.clone(memory_format=torch.contiguous_format)
    st = s.T.contiguous()
    for _ in range(sweeps):
        for t in range(spec.T):
            rest = pt.sum(0) - pt[t]
            torch.clamp(st[t] - rest, spec.lam, 1.0, out=pt[t])
    return pt.T


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


def solve_p4_subgradient(ab: torch.Tensor, h: torch.Tensor, cell: CellConfig,
                         iters: int = 400, step0: float = 1.0) -> torch.Tensor:
    """The paper's subgradient dual loop (33) for one round (``ab, h: [K]``),
    kept to hold :func:`solve_p4` against."""
    w_fn = _w_of_v_fn(ab, h, cell)
    f32 = dict(dtype=torch.float32, device=h.device)
    scale = torch.clamp(ab.max(), min=1e-12)
    steps = step0 / torch.sqrt(1.0 + torch.arange(iters, **f32))
    v = torch.zeros((), **f32)
    for i in range(iters):
        g = 1.0 - w_fn(v).sum()
        v = torch.clamp(v - steps[i] * g * scale * cell.bandwidth_hz,
                        min=0.0)
    return w_fn(v)


def solve(h: torch.Tensor, spec: ProblemSpec, max_outer: int = 400,
          tol: float = 1e-9, zeta: float = 0.1,
          device=None) -> Algorithm1Result:
    """Run Algorithm 1 on channel gains ``h: [K, T]`` on ``device``
    (``None`` means the card).

    Each outer iteration solves (P3), then (P4) for all T rounds at once
    (rounds as lanes), then takes the damped Newton step; it stops once
    ``iters == max_outer`` or the residual's float32 square norm is at most
    ``tol``.  That check is read on the host once an iteration.  ζ = 0.1 is
    JAX's: larger steps let the α = 1/R feedback oscillate on channels with
    more than 4 orders of magnitude of gain spread.
    """
    device = resolve_device(device)
    h = torch.as_tensor(h, dtype=torch.float32).to(device)
    c = spec.cell
    K, T = spec.K, spec.T
    PkS1r = c.tx_power_w * c.model_size_nats * (1.0 - spec.rho)
    f32 = dict(dtype=torch.float32, device=device)

    def rate(w):
        return rate_nats(w, h, c.tx_power_w, c.bandwidth_hz,
                         c.noise_w_per_hz)

    # initialization: equal bandwidth, mid probabilities
    w = torch.full((K, T), 1.0 / K, **f32)
    p = torch.full((K, T), min(max(0.5, spec.lam), 1.0), **f32)
    aux = newton_targets(p, rate(w), PkS1r, spec.rho, T, K)
    res = torch.tensor(float("inf"), **f32)
    it = 0
    while it < max_outer and bool(res > tol):
        p = solve_p3(aux.alpha, spec, p)
        w = solve_p4((aux.alpha * aux.beta).T, h.T, c).T
        R = rate(w)
        target = newton_targets(p, R, PkS1r, spec.rho, T, K)
        aux, _ = newton_update(aux, target, p, R, PkS1r, spec.rho, T, K,
                               zeta=zeta)
        res = residuals(aux, p, R, PkS1r, spec.rho, T, K).sq_norm
        it += 1
    return Algorithm1Result(
        p=p, w=w, objective=objective_p1(p, w, h, spec), residual=res,
        iters=torch.tensor(it, dtype=torch.int32, device=device))
