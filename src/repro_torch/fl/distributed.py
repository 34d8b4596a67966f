"""Mega-scale FL train steps for the assigned architectures.  Counterpart of
``repro.fl.distributed``.

Two modes, as in JAX:

* **replica** (paper-faithful): each client k keeps its own divergent
  parameters x_k and its anchor y_k.  JAX stacks them on a leading K axis
  of every leaf and ``vmap``\\ s the clients; the port holds them as flat
  ``[K, P]`` rows (one row per parameter dtype, see :class:`RowLayout`) and
  trains the clients one after another, each through per-layer views of
  its row.  Eq. 3 is K1's plain mode over the rows:
  ``ops.fl_aggregate(global_row, client_rows − anchor_rows, mask)``, with
  R = K and M = P — deltas in the parameter dtype, the sum in float32,
  ``g + s/K`` cast to ``g``'s dtype (``kernels/ref.py``; on the card the
  sum is scaled by ``inv_k``).
* **masked-dp** (the scalable adaptation for the 398B/400B models): one
  global model; each round's gradient is that of the importance-weighted
  loss ``(1/K) Σ_k (m_k / max(p_k, 1e-6)) · loss_k``, one backward pass.

Gradients come from ``torch.func.functional_call`` over views of the rows
that require gradients, with ``torch.autograd.grad`` on those views; the
model's own parameters stay ``requires_grad=False``, so inference is
untouched.  **The round updates the state's rows in place** (the clients'
local steps, the broadcast to participants, masked-dp's global step) and
returns a :class:`DistFLState` over the same client and anchor tensors;
JAX returns new arrays.  A caller that needs the old state clones it.  This
keeps a full-width Llama-3.2-1B round at K 4 near 35 GB on one card.

A non-finite delta of a non-participant still reaches the global model, as
in JAX: its mask 0 multiplies it, and 0 · NaN is NaN, on the CPU and on
the card (K1 does not skip rows of weight 0).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..data.device import DeviceDataStore, sample_batch
from ..kernels import ops
from ..models import transformer as T


class DistFLState(NamedTuple):
    """Rows of the global model (``[P_g]`` each), and in replica mode the
    clients' and anchors' rows (``[K, P_g]`` each), one per parameter dtype
    of :func:`row_layout`; ``None`` in masked-dp mode."""
    global_params: tuple
    client_params: Any
    anchor_params: Any


def mode_for(cfg: ArchConfig, hbm_budget_bytes: float = 3.2e12) -> str:
    """replica if 2·K·P fits comfortably in pod HBM, else masked-dp."""
    n = param_count(cfg)
    bytes_needed = 2 * 16 * n * 2  # 2 copies × K=16 × bf16
    return "replica" if bytes_needed < hbm_budget_bytes else "masked_dp"


def param_count(cfg: ArchConfig) -> int:
    """Analytic parameter count (matches init_params leaf sum)."""
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    total = V * d + d  # embed + final norm
    if not cfg.tie_embeddings:
        total += d * V
    di = cfg.ssm_expand * d
    dtr = max(1, math.ceil(d / 16))
    N, k = cfg.ssm_state, cfg.ssm_conv
    for li in range(cfg.n_layers):
        mixer = cfg.mixer_pattern[li % len(cfg.mixer_pattern)]
        total += d  # ln1
        if mixer == "attn":
            total += d * H * hd + 2 * d * KV * hd + H * hd * d
            if cfg.qk_norm:
                total += 2 * hd
        elif mixer == "mamba":
            total += (d * 2 * di + k * di + di + di * (dtr + 2 * N)
                      + dtr * di + di + di * N + di + di * d)
        elif mixer == "mlstm":
            total += 5 * d * d + 2 * d * H  # q,k,v,o-gate,out + i/f gates
        elif mixer == "slstm":
            total += 4 * d * d + 4 * (d // H) * d + 4 * d + d * d
        kind = cfg.ffn_kind(li)
        if kind != "none":
            total += d  # ln2
        if kind == "dense":
            total += 3 * d * ff
        elif kind == "moe":
            m = cfg.moe
            total += d * m.num_experts + 3 * m.num_experts * d * m.d_ff_expert
    return int(total)


# ---------------------------------------------------------------------------
# flat rows
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Where each parameter of ``cfg``'s :class:`~models.transformer.
    Transformer` lies in the flat rows: the parameters, in
    ``named_parameters`` order, grouped by dtype (group g holds the
    ``dtypes[g]`` ones, ``sizes[g]`` elements; a bf16 xLSTM has a bf16 and
    a float32 row, as its leaves have both dtypes)."""
    names: tuple
    shapes: tuple
    groups: tuple
    offsets: tuple
    dtypes: tuple
    sizes: tuple

    def views(self, rows) -> dict:
        """``{name: view}`` of ``rows`` (one tensor a group, ``[..., P_g]``):
        each view ``[..., *shape]`` shares the row's storage."""
        out = {}
        for name, shape, g, off in zip(self.names, self.shapes, self.groups,
                                       self.offsets):
            r = rows[g]
            n = math.prod(shape)
            out[name] = r[..., off:off + n].view(*r.shape[:-1], *shape)
        return out

    @torch.no_grad()
    def flatten(self, model: nn.Module) -> tuple:
        """A copy of ``model``'s parameters as rows on its device."""
        params = dict(model.named_parameters())
        device = params[self.names[0]].device
        rows = tuple(torch.empty(n, dtype=dt, device=device)
                     for dt, n in zip(self.dtypes, self.sizes))
        for name, view in self.views(rows).items():
            view.copy_(params[name])
        return rows

    def module(self, cfg: ArchConfig, rows) -> T.Transformer:
        """A :class:`~models.transformer.Transformer` whose parameters are
        views of ``rows`` (``[P_g]`` each): no copy."""
        model = T.Transformer(cfg, device="meta")
        for name, view in self.views(rows).items():
            owner, _, leaf = name.rpartition(".")
            sub = model.get_submodule(owner) if owner else model
            sub._parameters[leaf] = nn.Parameter(view, requires_grad=False)
        return model


@functools.lru_cache(maxsize=None)
def row_layout(cfg: ArchConfig) -> RowLayout:
    """The :class:`RowLayout` of ``cfg``'s model (built on the meta
    device: nothing is allocated)."""
    named = list(_skeleton(cfg).model.named_parameters())
    dtypes = tuple(dict.fromkeys(p.dtype for _, p in named))
    sizes = [0] * len(dtypes)
    groups, offsets = [], []
    for _, p in named:
        g = dtypes.index(p.dtype)
        groups.append(g)
        offsets.append(sizes[g])
        sizes[g] += p.numel()
    return RowLayout(names=tuple(n for n, _ in named),
                     shapes=tuple(tuple(p.shape) for _, p in named),
                     groups=tuple(groups), offsets=tuple(offsets),
                     dtypes=dtypes, sizes=tuple(sizes))


class _Loss(nn.Module):
    """``T.loss`` of ``model`` as a module's forward, so that
    ``functional_call`` can swap the model's parameters."""

    def __init__(self, model: T.Transformer):
        super().__init__()
        self.model = model

    def forward(self, batch):
        return T.loss(self.model, batch)


@functools.lru_cache(maxsize=None)
def _skeleton(cfg: ArchConfig) -> _Loss:
    return _Loss(T.Transformer(cfg, device="meta"))


def _differentiable(cfg: ArchConfig, rows):
    """Leaves that require gradients over the per-parameter views of
    ``rows`` (sharing their storage), and ``T.loss`` of a batch with the
    model's parameters swapped for them."""
    layout = row_layout(cfg)
    leaves = [v.detach().requires_grad_() for v in layout.views(rows).values()]
    params = {"model." + n: t for n, t in zip(layout.names, leaves)}
    return leaves, lambda batch: torch.func.functional_call(
        _skeleton(cfg), params, (batch,))


def loss_and_grads(cfg: ArchConfig, rows, batch):
    """``T.loss`` of the model whose parameters are ``rows`` (``[P_g]``
    each) on ``batch``, and its gradient with respect to each parameter
    (a list in :func:`row_layout` order, each in its parameter's dtype; an
    unused parameter gets zeros, as JAX's ``grad`` gives)."""
    leaves, loss = _differentiable(cfg, rows)
    with torch.enable_grad():
        value = loss(batch)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    return value.detach(), [torch.zeros_like(t) if g is None else g
                            for t, g in zip(leaves, grads)]


def init_dist_state(key, cfg: ArchConfig, num_clients: int,
                    mode: str = "replica", device=None) -> DistFLState:
    """``T.init_params(key, cfg)`` as rows; in replica mode every client's
    and anchor's row starts as a copy of them."""
    model = T.init_params(key, cfg, device=device)
    rows = row_layout(cfg).flatten(model)
    del model
    if mode == "masked_dp":
        return DistFLState(global_params=rows, client_params=None,
                           anchor_params=None)
    return DistFLState(
        global_params=rows,
        client_params=tuple(r[None].repeat(num_clients, 1) for r in rows),
        anchor_params=tuple(r[None].repeat(num_clients, 1) for r in rows))


# ---------------------------------------------------------------------------
# replica mode
# ---------------------------------------------------------------------------

def _grad_accum(cfg: ArchConfig, rows, batch: dict, micro_batches: int):
    """``value_and_grad`` of the loss, or with ``micro_batches > 1`` the
    mean over that many sequential slices of the batch, gradients summed in
    float32 (JAX's ``lax.scan`` of ``one_micro``)."""
    if micro_batches == 1:
        return loss_and_grads(cfg, rows, batch)
    l_sum = None
    g_sum = None
    for i in range(micro_batches):
        part = {name: x.reshape(micro_batches, x.shape[0] // micro_batches,
                                *x.shape[1:])[i] for name, x in batch.items()}
        value, grads = loss_and_grads(cfg, rows, part)
        if g_sum is None:
            l_sum = torch.zeros((), dtype=torch.float32, device=value.device)
            g_sum = [torch.zeros(g.shape, dtype=torch.float32,
                                 device=g.device) for g in grads]
        l_sum = l_sum + value
        g_sum = [a + g.float() for a, g in zip(g_sum, grads)]
    inv = 1.0 / micro_batches
    return l_sum * inv, [g * inv for g in g_sum]


@torch.no_grad()
def _sgd(views, grads, lr: float) -> None:
    """``p − lr · g`` in the parameter dtype, in place: ``lr`` is taken in
    that dtype (JAX's weakly typed scalar), the product rounded, then the
    difference."""
    lrs = {}
    for v, g in zip(views, grads):
        lr_t = lrs.setdefault(v.dtype, torch.tensor(lr, dtype=v.dtype,
                                                    device=v.device))
        v.sub_(g.to(v.dtype) * lr_t)


def _local(cfg: ArchConfig, rows, batch: dict, lr: float, local_iters: int,
           micro_batches: int) -> torch.Tensor:
    """One client's ``local_iters`` SGD steps on its rows (in place);
    returns the mean of the steps' losses."""
    views = list(row_layout(cfg).views(rows).values())
    losses = []
    for _ in range(local_iters):
        value, grads = _grad_accum(cfg, rows, batch, micro_batches)
        _sgd(views, grads, lr)
        losses.append(value)
    return torch.stack(losses).mean()


def _aggregate_and_broadcast(state: DistFLState,
                             mask: torch.Tensor) -> DistFLState:
    """Eq. 2/3 through K1's plain mode, one launch a row group, then the
    new global model copied into the participants' client and anchor rows
    (protocol step 5), in place."""
    new_global = tuple(
        ops.fl_aggregate(g, c - a, mask.to(torch.float32))
        for g, c, a in zip(state.global_params, state.client_params,
                           state.anchor_params))
    sel = mask.to(torch.bool)[:, None]
    for g, c, a in zip(new_global, state.client_params, state.anchor_params):
        torch.where(sel, g[None], c, out=c)
        torch.where(sel, g[None], a, out=a)
    return DistFLState(new_global, state.client_params, state.anchor_params)


def fl_train_step(state: DistFLState, cfg: ArchConfig, batch: dict,
                  mask: torch.Tensor, lr: float, local_iters: int = 1,
                  micro_batches: int = 1) -> tuple[DistFLState, dict]:
    """One paper round in replica mode.

    batch: ``{name: [K, B, ...]}``; mask: ``[K]`` 0/1 Bernoulli draws of
    the server-optimized probabilities.  Every client runs ``local_iters``
    SGD steps on its own rows, one client after another (JAX ``vmap``\\ s
    them); ``micro_batches`` splits each client's batch into sequential
    gradient-accumulation chunks.  Then eq. 3 and the broadcast.  The
    state's client and anchor rows are updated in place.  Returns the new
    state and ``{"loss", "participants"}`` (0-dim tensors)."""
    K = mask.shape[0]
    losses = torch.stack([
        _local(cfg, tuple(c[k] for c in state.client_params),
               {name: x[k] for name, x in batch.items()}, lr, local_iters,
               micro_batches)
        for k in range(K)])
    new = _aggregate_and_broadcast(state, mask)
    return new, {"loss": losses.mean(), "participants": mask.sum()}


def fl_train_step_from_store(state: DistFLState, cfg: ArchConfig,
                             store: DeviceDataStore, data_key: torch.Tensor,
                             t, mask: torch.Tensor, lr: float,
                             batch_size: int, local_iters: int = 1,
                             micro_batches: int = 1) -> tuple[DistFLState,
                                                              dict]:
    """Replica-mode round fed from a :class:`DeviceDataStore`: the round's
    ``[K, B, S]`` token batch is gathered on the store's device from the
    ``fold_in(data_key, t)`` stream (``data.device.sample_batch``), the
    same draw as JAX's."""
    toks, _ = sample_batch(store, data_key, t, batch_size)
    return fl_train_step(state, cfg, {"tokens": toks}, mask, lr,
                         local_iters=local_iters,
                         micro_batches=micro_batches)


# ---------------------------------------------------------------------------
# masked-dp mode
# ---------------------------------------------------------------------------

def fl_train_step_masked_dp(state: DistFLState, cfg: ArchConfig,
                            batch: dict, mask: torch.Tensor,
                            probs: torch.Tensor,
                            lr: float) -> tuple[DistFLState, dict]:
    """One round in masked-DP mode: unbiased inverse-probability weighting,
    ``E[(1/K) Σ (m_k/p_k) g_k] = (1/K) Σ g_k``.

    One backward pass of ``L = (1/K) Σ_k (m_k / max(p_k, 1e-6)) · loss_k``
    over the global rows, so per-client gradients are never materialized;
    then ``g − lr · ∇L`` in float32, cast to each parameter's dtype and
    written into the global rows in place."""
    K = mask.shape[0]
    rows = state.global_params
    wgt = (mask / torch.clamp(probs, min=1e-6)).to(torch.float32)
    leaves, loss = _differentiable(cfg, rows)
    with torch.enable_grad():
        losses = torch.stack([loss({n: x[k] for n, x in batch.items()})
                              for k in range(K)])
        total = torch.sum(losses * wgt) / K
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    with torch.no_grad():
        for v, g in zip(leaves, grads):
            if g is not None:
                v.copy_((v.float() - lr * g.float()).to(v.dtype))
    return (DistFLState(rows, None, None),
            {"loss": losses.detach().mean(), "participants": mask.sum()})
