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


def selective_scan_ref(xc: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                       Cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor):
    """Mamba S6 recurrence in float32, one timestep at a time:

        h_t = exp(dt_t·A) ⊙ h_{t−1} + (dt_t·B_t)·x_t,   h_0 = 0
        y_t = h_t·C_t + D ⊙ x_t

    xc, dt: [B, S, d]; Bm, Cm: [B, S, N]; A: [d, N]; D: [d] →
    ``(y [B, S, d], h_last [B, d, N])``, both float32.  The state is the
    only ``[B, d, N]`` tensor kept: the ``[B, S, d, N]`` one of the
    associative form is never built.
    """
    xc, dt, Bm, Cm = xc.float(), dt.float(), Bm.float(), Cm.float()
    A, D = A.float(), D.float()
    B, S, d = xc.shape
    h = torch.zeros(B, d, A.shape[1], dtype=torch.float32, device=xc.device)
    y = torch.empty(B, S, d, dtype=torch.float32, device=xc.device)
    for t in range(S):
        dt_t = dt[:, t, :, None]                                 # [B,d,1]
        h = torch.exp(dt_t * A) * h \
            + (dt_t * Bm[:, t, None, :]) * xc[:, t, :, None]
        y[:, t] = (h * Cm[:, t, None, :]).sum(-1) + D * xc[:, t]
    return y, h


def mlp_local_sgd_ref(rows: torch.Tensor, xb: torch.Tensor, yb: torch.Tensor,
                      lr: float, layout) -> torch.Tensor:
    """L steps of plain SGD of R one-hidden-layer ReLU MLPs, each its own
    row of ``rows [R, W]`` (the leaves where ``layout`` puts them), on
    ``xb [R, L, B, ...]`` and ``yb [R, L, B]``: the forward and backward
    written out, no autograd.  Each gradient is autograd's of the summed
    per-client mean cross-entropy (``dh`` from the step's W2, relu's
    gradient where ``!(h <= 0)``, log_softmax's backward ``g - p·Σg``), and
    each leaf moves by ``leaf + (-lr)·g`` as ``opt.sgd`` and the flat row
    do.  Returns new rows; the padding is copied."""
    out = rows.clone()
    (l1, l2) = layout.unflatten(out)
    R, L, B = yb.shape
    x_all = xb.reshape(R, L, B, l1["w"].shape[-2])
    for s in range(L):
        x, y = x_all[:, s], yb[:, s].long()
        h = torch.relu(x @ l1["w"] + l1["b"].unsqueeze(-2))
        logits = h @ l2["w"] + l2["b"].unsqueeze(-2)
        p = torch.exp(torch.log_softmax(logits, dim=-1))
        g = torch.zeros_like(logits).scatter_(-1, y.unsqueeze(-1), -1.0 / B)
        dl = g - p * g.sum(-1, keepdim=True)
        dh = torch.where(h <= 0, 0.0, dl @ l2["w"].transpose(-1, -2))
        grads = ((l2["w"], h.transpose(-1, -2) @ dl), (l2["b"], dl.sum(-2)),
                 (l1["w"], x.transpose(-1, -2) @ dh), (l1["b"], dh.sum(-2)))
        for leaf, grad in grads:
            leaf.add_(-lr * grad)
    return out
