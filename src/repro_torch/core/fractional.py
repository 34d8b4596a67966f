"""Sum-of-ratios fractional-programming machinery (paper Theorem 2, eqs.
19/34-40), counterpart of ``repro.core.fractional``.

Jong's transform turns (P1) into the subtractive problem (P2) with auxiliary
variables (α, β, γ).  The optimum of (P1) is where the inner problem (P2) is
solved *and* the residual system (19) vanishes:

    ψ_{k,t} = α_{k,t}·R*_{k,t} − 1
    κ_{k,t} = β_{k,t}·R*_{k,t} − p*_{k,t}·P_k·S·(1−ρ)
    χ_k     = γ_k − ρT²/(K·(Σ_t p*_{k,t})²)

The outer update is the damped (modified-Newton) step (37)-(39) with the
Armijo condition (40).  The search over l is a host loop that reads one flag
a level; l = 1 almost always accepts.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AuxVars(NamedTuple):
    alpha: torch.Tensor  # [K, T]
    beta: torch.Tensor   # [K, T]
    gamma: torch.Tensor  # [K]


class Residuals(NamedTuple):
    psi: torch.Tensor    # [K, T]
    kappa: torch.Tensor  # [K, T]
    chi: torch.Tensor    # [K]

    @property
    def sq_norm(self) -> torch.Tensor:
        return (torch.sum(self.psi**2) + torch.sum(self.kappa**2)
                + torch.sum(self.chi**2))


def residuals(aux: AuxVars, p: torch.Tensor, R: torch.Tensor, PkS1r,
              rho: float, T: int, K: int) -> Residuals:
    """Evaluate (34)-(36) at the inner solution (p, R) for given aux vars.

    ``PkS1r`` is the per-client constant ``P_k · S · (1−ρ)``.  The residuals
    are *relative* (each equation over its natural scale), so one tolerance
    means the same for α (~1/R), β (~p·P·S/R) and γ (~ρT²/K); the zero set
    and the Newton targets are the paper's.
    """
    psi = aux.alpha * R - 1.0
    kappa = aux.beta * R / (p * PkS1r) - 1.0
    sum_p = torch.sum(p, dim=1)
    chi = aux.gamma * (K * sum_p**2) / (rho * T**2) - 1.0
    return Residuals(psi, kappa, chi)


def newton_targets(p: torch.Tensor, R: torch.Tensor, PkS1r, rho: float,
                   T: int, K: int) -> AuxVars:
    """The values that zero each residual exactly (RHS of eqs. 37-39)."""
    alpha_t = 1.0 / R
    beta_t = p * PkS1r / R
    gamma_t = rho * T**2 / (K * torch.sum(p, dim=1) ** 2)
    return AuxVars(alpha_t, beta_t, gamma_t)


def newton_update(aux: AuxVars, target: AuxVars, p, R, PkS1r, rho, T, K,
                  zeta: float = 0.5, eps: float = 0.01,
                  max_l: int = 30) -> tuple[AuxVars, torch.Tensor]:
    """Damped Newton step (37)-(39) with step-size rule (40): the smallest
    l ≥ 1 (up to ``max_l``) whose step ζ^l passes the Armijo-type decrease,
    else the step ζ.  Returns the new aux vars and the step (float32)."""
    base = residuals(aux, p, R, PkS1r, rho, T, K).sq_norm
    f32 = dict(dtype=torch.float32, device=p.device)

    def cand(step):
        return AuxVars(
            alpha=(1 - step) * aux.alpha + step * target.alpha,
            beta=(1 - step) * aux.beta + step * target.beta,
            gamma=(1 - step) * aux.gamma + step * target.gamma,
        )

    zeta_t = torch.tensor(zeta, **f32)
    # float32 pow(ζ, l) for every level, as JAX raises its float32 ζ to the
    # int32 l (the table of repro_torch.core.online)
    zeta_pow = torch.pow(zeta_t, torch.arange(max_l + 1, **f32))
    for level in range(1, max_l + 1):
        step = zeta_pow[level]
        val = residuals(cand(step), p, R, PkS1r, rho, T, K).sq_norm
        if bool(val <= (1.0 - eps * step) * base):
            return cand(step), step
    return cand(zeta_t), zeta_t   # the search exhausted: fall back to ζ¹
