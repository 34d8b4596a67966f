"""Online variant of Algorithm 1 (paper §IV-D, problem (P1')), counterpart of
``repro.core.online``.

With round-invariant probabilities the solver needs only the current round's
channel state: alternate the Lambert-W bandwidth step (31) with the
closed-form probability (46)

    p_k* = clip( (2ρ / (K α_k P_k S T (1−ρ)))^{1/3}, λ, 1 ),

updating (α, β) by a damped-Newton rule until the residuals vanish.

``h`` may carry leading lane axes (``[..., K]``): all lanes solve at once,
which is how the engine solves every round of a horizon in one call (the JAX
engine's hoisted ``vmap``).  JAX's batched ``while_loop`` keeps a finished
lane frozen while others iterate; here each loop does the same with
``torch.where(active, new, old)``, so every lane gives what the unbatched
solve gives.  The loop conditions are read on the host once per iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .algorithm1 import ProblemSpec, solve_p4
from .channel import rate_nats

_ZETA, _EPS = 0.1, 0.01   # damping base and sufficient-decrease constant


class OnlineResult(NamedTuple):
    p: torch.Tensor          # [..., K]
    w: torch.Tensor          # [..., K]
    objective: torch.Tensor  # [...]
    residual: torch.Tensor   # [...]
    iters: torch.Tensor      # [...] int32


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root of a float32 tensor, correctly rounded (through float64).

    ``torch.pow`` on the CPU takes a vector path for full SIMD vectors and a
    scalar one for the tail, so its float32 result depends on an element's
    position and a batched solve would not equal the per-lane one.  JAX's
    float32 ``pow`` is within 2 ulp of this.
    """
    return torch.exp(torch.log(x.double()) / 3.0).float()


def _rho_terms(spec: ProblemSpec, rho, device):
    """``(2ρ, P·S·T·max(1−ρ, 1e-7))`` as float32 tensors.  A Python ρ is
    combined in double first, as JAX folds a static ρ before rounding."""
    c = spec.cell
    PST = c.tx_power_w * c.model_size_nats * spec.T
    f32 = dict(dtype=torch.float32, device=device)
    if isinstance(rho, torch.Tensor):
        rho = rho.to(**f32)
        return 2 * rho, PST * torch.clamp(1.0 - rho, min=1e-7)
    return (torch.tensor(2 * rho, **f32),
            PST * torch.tensor(max(1.0 - rho, 1e-7), **f32))


def objective_p1_prime(p, w, h, spec: ProblemSpec, rho=None):
    """Eq. (41), per lane."""
    c = spec.cell
    rho = spec.rho if rho is None else rho
    R = rate_nats(w, h, c.tx_power_w, c.bandwidth_hz, c.noise_w_per_hz)
    conv = rho / spec.K * torch.sum(p ** -2, -1)
    energy = (1 - rho) * spec.T * torch.sum(
        p * c.tx_power_w * c.model_size_nats / torch.clamp(R, min=1e-30), -1)
    return conv + energy


def solve_online(h: torch.Tensor, spec: ProblemSpec, max_outer: int = 200,
                 tol: float = 1e-10, rho=None) -> OnlineResult:
    """Solve (P1') for channel gains ``h: [..., K]`` (one problem per lane).

    ``rho=None`` uses ``spec.rho``; a float32 tensor broadcastable to the
    lane shape gives each lane its own ρ.  ρ → 1 is clamped to one fp32 ulp
    of energy weight so that every intermediate stays finite.
    """
    c = spec.cell
    K = spec.K
    rho = spec.rho if rho is None else rho
    two_rho, PkST1r = _rho_terms(spec, rho, h.device)
    tiny = 1e-30

    def rate(w):
        return rate_nats(w, h, c.tx_power_w, c.bandwidth_hz,
                         c.noise_w_per_hz)

    def probs(x):
        # (46); the clamp keeps α → 0 with ρ = 0 finite, landing on λ
        x = torch.clamp(x * PkST1r.unsqueeze(-1), min=tiny)
        return torch.clamp(_cbrt(two_rho.unsqueeze(-1) / x), spec.lam, 1.0)

    def res_sq(alpha, beta, p, R):
        psi = alpha * R - 1.0
        kappa = beta * R / torch.clamp(p * PkST1r.unsqueeze(-1),
                                       min=tiny) - 1.0
        return torch.sum(psi ** 2, -1) + torch.sum(kappa ** 2, -1)

    lanes = h.shape[:-1]
    two_rho = two_rho.expand(lanes)
    PkST1r = PkST1r.expand(lanes)
    w = torch.full_like(h, 1.0 / K)
    R = rate(w)
    p = probs(K * (1.0 / R))
    alpha, beta = 1.0 / R, p * PkST1r.unsqueeze(-1) / R
    it = torch.zeros(lanes, dtype=torch.int32, device=h.device)
    res = torch.full(lanes, torch.inf, dtype=h.dtype, device=h.device)
    zeta = torch.tensor(_ZETA, dtype=torch.float32, device=h.device)
    # ζ^l for the line-search levels l = 0..31, looked up per lane (float32
    # pow(0.1, l), as JAX computes it)
    zeta_pow = torch.pow(zeta, torch.arange(32, dtype=torch.float32,
                                            device=h.device))

    active = (it < max_outer) & (res > tol)
    while bool(active.any()):
        p_n = probs(K * alpha)
        w_n = solve_p4(alpha * beta, h, c, active=active)
        R = rate(w_n)
        base = res_sq(alpha, beta, p_n, R)
        ta, tb = 1.0 / R, p_n * PkST1r.unsqueeze(-1) / R

        def cand(step):
            s = step.unsqueeze(-1)
            return (1 - s) * alpha + s * ta, (1 - s) * beta + s * tb

        # backtracking line search on the (40)-style step rule
        level = torch.ones(lanes, dtype=torch.int32, device=h.device)
        ok = torch.zeros(lanes, dtype=torch.bool, device=h.device)
        step = zeta.expand(lanes)
        searching = active.clone()
        while bool(searching.any()):
            s_try = zeta_pow[level]
            a2, b2 = cand(s_try)
            ok_try = res_sq(a2, b2, p_n, R) <= (1 - _EPS * s_try) * base
            ok = torch.where(searching, ok_try, ok)
            step = torch.where(searching, s_try, step)
            level = torch.where(searching, level + 1, level)
            searching = ~ok & (level <= 30) & active
        step = torch.where(ok, step, zeta)
        a_n, b_n = cand(step)
        res_n = res_sq(a_n, b_n, p_n, R)

        keep = active.unsqueeze(-1)
        alpha = torch.where(keep, a_n, alpha)
        beta = torch.where(keep, b_n, beta)
        p = torch.where(keep, p_n, p)
        w = torch.where(keep, w_n, w)
        res = torch.where(active, res_n, res)
        it = torch.where(active, it + 1, it)
        active = (it < max_outer) & (res > tol)

    return OnlineResult(p=p, w=w,
                        objective=objective_p1_prime(p, w, h, spec, rho=rho),
                        residual=res, iters=it)
