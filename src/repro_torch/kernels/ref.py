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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention, float32 softmax.

    q: [B, S, H, hd]; k, v: [B, S, KV, hd]; H % KV == 0; query head h reads
    KV head ``h // (H / KV)``.  A key is kept where ``kpos <= qpos`` (causal)
    and ``kpos > qpos - window`` (window).  Returns ``q.dtype``.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    scores = scores / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)
