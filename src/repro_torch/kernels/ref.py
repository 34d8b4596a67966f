"""Plain PyTorch versions of the port's kernels (the allclose references).

Counterparts of ``repro.kernels.ref``.  The CPU path of :mod:`.ops` runs
these; ``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch


def fl_aggregate_ref(global_p: torch.Tensor, deltas: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Eq. (3): ``out = global + (1/K) Σ_k mask_k · δ_k``, accumulated in
    float32 and cast to ``global_p``'s dtype.

    global_p: [M]; deltas: [K, M]; mask: [K].
    """
    K = deltas.shape[0]
    agg = torch.sum(deltas.float() * mask.float()[:, None], dim=0) / K
    return (global_p.float() + agg).to(global_p.dtype)


def fl_aggregate_subset_ref(global_p: torch.Tensor, deltas: torch.Tensor,
                            valid: torch.Tensor, num_clients) -> torch.Tensor:
    """Participant-subset eq. (3): ``out = global + (1/K) Σ_p valid_p · δ_p``
    over a padded participant bucket ``deltas: [P, M]``; ``num_clients`` is
    the population K (a number or a 0-dim tensor)."""
    agg = torch.sum(deltas.float() * valid.float()[:, None], dim=0)
    k = torch.as_tensor(num_clients, dtype=torch.float32, device=agg.device)
    return (global_p.float() + agg / k).to(global_p.dtype)


def fl_aggregate_guarded_ref(global_p: torch.Tensor, deltas: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """Defensively-weighted eq. (3): ``out = global + Σ_r w_r · δ'_r`` with
    ``δ' = δ`` where finite, else 0.  ``weights`` folds the participation
    mask, guard weights and 1/K."""
    d = deltas.float()
    d = torch.where(torch.isfinite(d), d, 0.0)
    agg = torch.sum(d * weights.float()[:, None], dim=0)
    return (global_p.float() + agg).to(global_p.dtype)
