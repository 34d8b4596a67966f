"""Convergence-rate expressions (paper §III), counterpart of
``repro.core.convergence``: Lemma 1, eqs. (7)/(8), Theorem 1 and the
metric (10) that Algorithm 1 optimizes.  ``p`` is ``[K, T]``.
"""
from __future__ import annotations

import torch


def lemma1_bound(eta: float, L: float, g_max: float, sigma: float,
                 f_max: float, T: int, delta: torch.Tensor) -> torch.Tensor:
    """Eq. (6): bound on (1/T)Σ E‖∇f(x_t)‖² given max intervals Δ_k."""
    K = delta.shape[0]
    return (8.0 * f_max / (eta * T)
            + 92.0 * eta**2 * L**2 * g_max**2 * torch.sum(delta**2) / K
            + 9.0 * sigma**2)


def expected_delta(p: torch.Tensor) -> torch.Tensor:
    """Eq. (7): E[Δ_k] = Σ_t p_{k,t} Π_{τ<t}(1−p_{k,τ}) · t."""
    one_minus = torch.cat(
        [torch.ones_like(p[:, :1]), torch.cumprod(1.0 - p[:, :-1], dim=1)],
        dim=1)
    t = torch.arange(p.shape[1], dtype=p.dtype, device=p.device)
    return torch.sum(p * one_minus * t[None, :], dim=1)


def delta_prime(p: torch.Tensor) -> torch.Tensor:
    """Eq. (8): periodic approximation Δ'_k = T / Σ_t p_{k,t}."""
    T = p.shape[1]
    return T / torch.clamp(torch.sum(p, dim=1), min=1e-12)


def theorem1_bound(eta: float, L: float, g_max: float, sigma: float,
                   f_max: float, p: torch.Tensor) -> torch.Tensor:
    """Eq. (9): Lemma 1 with Δ_k ← Δ'_k(p)."""
    T = p.shape[1]
    return lemma1_bound(eta, L, g_max, sigma, f_max, T, delta_prime(p))


def convergence_metric(p: torch.Tensor) -> torch.Tensor:
    """Eq. (10): (T²/K) Σ_k (Σ_t p_{k,t})^{-2}."""
    K, T = p.shape
    return T**2 / K * torch.sum(torch.sum(p, dim=1) ** -2)
