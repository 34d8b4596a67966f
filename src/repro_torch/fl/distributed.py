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
from ..models.pshard import settle


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
    a float32 row, as its leaves have both dtypes).

    A placed layout (:meth:`placed`) describes rows of one rank's shards:
    ``shapes`` are the local shapes, and the views of a ``[P_g]`` row are
    DTensors over ``mesh`` with each parameter's ``placements``."""
    names: tuple
    shapes: tuple
    groups: tuple
    offsets: tuple
    dtypes: tuple
    sizes: tuple
    mesh: Any = None
    placements: tuple = ()
    global_shapes: tuple = ()

    def views(self, rows) -> dict:
        """``{name: view}`` of ``rows`` (one tensor a group, ``[..., P_g]``):
        each view ``[..., *shape]`` shares the row's storage; in a placed
        layout each view of a ``[P_g]`` row is a DTensor over it."""
        out = {}
        for i, (name, shape, g, off) in enumerate(zip(
                self.names, self.shapes, self.groups, self.offsets)):
            r = rows[g]
            n = math.prod(shape)
            out[name] = r[..., off:off + n].view(*r.shape[:-1], *shape)
            if self.mesh is not None:
                from torch.distributed.tensor import DTensor
                gshape = self.global_shapes[i]
                out[name] = DTensor.from_local(
                    out[name], self.mesh, self.placements[i],
                    run_check=False, shape=torch.Size(gshape),
                    stride=_contiguous_stride(gshape))
        return out

    def placed(self, mesh, placements: dict, local_shape) -> "RowLayout":
        """This layout for rows of one rank's shards on ``mesh``:
        ``placements`` ``{name: placements}``, ``local_shape(shape,
        placements)`` the rank's shard shape."""
        shapes = tuple(tuple(local_shape(s, placements[n]))
                       for n, s in zip(self.names, self.shapes))
        sizes = [0] * len(self.dtypes)
        offsets = []
        for g, shape in zip(self.groups, shapes):
            offsets.append(sizes[g])
            sizes[g] += math.prod(shape)
        return dataclasses.replace(
            self, shapes=shapes, offsets=tuple(offsets), sizes=tuple(sizes),
            mesh=mesh, placements=tuple(tuple(placements[n])
                                        for n in self.names),
            global_shapes=self.shapes)

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


def _contiguous_stride(shape: tuple) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


@dataclasses.dataclass(frozen=True)
class RowPlacement:
    """Where a replica round's rows lie on a device mesh (the dry run's
    train programs, ``launch/specs.py``): each row holds this rank's
    shards (``layout``, placed on the mesh dims a client's parameters
    live on), and K is split over the dims ``k_dims`` of ``mesh`` (none
    when they are of one rank): the rows hold this rank's share of the
    clients, ``[K / n, P_g]``."""
    layout: RowLayout
    mesh: Any
    k_dims: tuple

    def client_offset(self, n_local: int) -> int:
        """The index of this rank's first client (K's shards run over the
        k dims in the mesh's order, the first outermost)."""
        coord = self.mesh.get_coordinate()
        index = 0
        for i in self.k_dims:
            index = index * self.mesh.shape[i] + coord[i]
        return index * n_local

    def sum_over_k(self, t: torch.Tensor):
        """The sum of each rank's ``t`` over the k dims (one all-reduce),
        a DTensor replicated on the mesh."""
        from torch.distributed.tensor import DTensor, Partial, Replicate
        mesh = self.mesh
        partial = [Partial() if i in self.k_dims else Replicate()
                   for i in range(mesh.ndim)]
        return DTensor.from_local(t, mesh, partial, run_check=False
                                  ).redistribute(mesh,
                                                 [Replicate()] * mesh.ndim)


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


def _loss_of(cfg: ArchConfig, leaves: list):
    """``T.loss`` of a batch with the model's parameters swapped for
    ``leaves`` (in :func:`row_layout` order)."""
    params = {"model." + n: t for n, t in zip(row_layout(cfg).names, leaves)}
    return lambda batch: torch.func.functional_call(
        _skeleton(cfg), params, (batch,))


def _differentiable(cfg: ArchConfig, rows, layout: RowLayout | None = None):
    """Leaves that require gradients over the per-parameter views of
    ``rows`` (sharing their storage; ``layout``, by default
    :func:`row_layout`), and ``T.loss`` of a batch with the model's
    parameters swapped for them."""
    layout = layout or row_layout(cfg)
    leaves = [v.detach().requires_grad_() for v in layout.views(rows).values()]
    return leaves, _loss_of(cfg, leaves)


def _value_and_grads(leaves: list, loss, batch):
    with torch.enable_grad():
        value = loss(batch)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    return value.detach(), [torch.zeros_like(t) if g is None else g
                            for t, g in zip(leaves, grads)]


def loss_and_grads(cfg: ArchConfig, rows, batch,
                   layout: RowLayout | None = None):
    """``T.loss`` of the model whose parameters are ``rows`` (``[P_g]``
    each) on ``batch``, and its gradient with respect to each parameter
    (a list in :func:`row_layout` order, each in its parameter's dtype; an
    unused parameter gets zeros, as JAX's ``grad`` gives)."""
    leaves, loss = _differentiable(cfg, rows, layout)
    return _value_and_grads(leaves, loss, batch)


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

def _grad_accum(cfg: ArchConfig, rows, batch: dict, micro_batches: int,
                layout: RowLayout | None = None):
    """``value_and_grad`` of the loss, or with ``micro_batches > 1`` the
    mean over that many sequential slices of the batch, gradients summed in
    float32 (JAX's ``lax.scan`` of ``one_micro``)."""
    if micro_batches == 1:
        return loss_and_grads(cfg, rows, batch, layout)
    l_sum = None
    g_sum = None
    for i in range(micro_batches):
        part = {name: x.reshape(micro_batches, x.shape[0] // micro_batches,
                                *x.shape[1:])[i] for name, x in batch.items()}
        value, grads = loss_and_grads(cfg, rows, part, layout)
        if g_sum is None:
            l_sum = torch.zeros_like(value, dtype=torch.float32)
            g_sum = [torch.zeros_like(g, dtype=torch.float32) for g in grads]
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
           micro_batches: int, layout: RowLayout) -> torch.Tensor:
    """One client's ``local_iters`` SGD steps on its rows (in place);
    returns the mean of the steps' losses."""
    views = list(layout.views(rows).values())
    losses = []
    for _ in range(local_iters):
        value, grads = _grad_accum(cfg, rows, batch, micro_batches, layout)
        _sgd(views, grads, lr)
        losses.append(value)
    return torch.stack(losses).mean()


def _aggregate_and_broadcast(state: DistFLState, mask: torch.Tensor,
                             placement: RowPlacement | None = None
                             ) -> DistFLState:
    """Eq. 2/3 through K1's plain mode, one launch a row group, then the
    new global model copied into the participants' client and anchor rows
    (protocol step 5), in place.  Where K is split over mesh dims, each
    rank's K1 sums its own clients' deltas, weighted ``m_k · n / K`` so that
    its ``1/n`` makes them ``m_k / K``, into float32 zeros; one all-reduce
    over the k dims adds the ranks' sums, and ``g + s`` is cast to ``g``'s
    dtype, as ``ref.fl_aggregate_ref`` rounds."""
    m = mask.to_local() if hasattr(mask, "to_local") else mask
    m = m.to(torch.float32)
    if placement is not None and placement.k_dims:
        n = state.client_params[0].shape[0]
        off = placement.client_offset(n)
        m, K = m[off:off + n], m.shape[0]
        new_global = tuple(
            (g.float() + placement.sum_over_k(ops.fl_aggregate(
                torch.zeros_like(g, dtype=torch.float32), (c - a).float(),
                m * (n / K))).to_local()).to(g.dtype)
            for g, c, a in zip(state.global_params, state.client_params,
                               state.anchor_params))
    else:
        new_global = tuple(
            ops.fl_aggregate(g, c - a, m)
            for g, c, a in zip(state.global_params, state.client_params,
                               state.anchor_params))
    sel = m.to(torch.bool)[:, None]
    for g, c, a in zip(new_global, state.client_params, state.anchor_params):
        torch.where(sel, g[None], c, out=c)
        torch.where(sel, g[None], a, out=a)
    return DistFLState(new_global, state.client_params, state.anchor_params)


def fl_train_step(state: DistFLState, cfg: ArchConfig, batch: dict,
                  mask: torch.Tensor, lr: float, local_iters: int = 1,
                  micro_batches: int = 1,
                  placement: RowPlacement | None = None
                  ) -> tuple[DistFLState, dict]:
    """One paper round in replica mode.

    batch: ``{name: [K, B, ...]}``; mask: ``[K]`` 0/1 Bernoulli draws of
    the server-optimized probabilities.  Every client runs ``local_iters``
    SGD steps on its own rows, one client after another (JAX ``vmap``\\ s
    them); ``micro_batches`` splits each client's batch into sequential
    gradient-accumulation chunks.  Then eq. 3 and the broadcast.  The
    state's client and anchor rows are updated in place.  Returns the new
    state and ``{"loss", "participants"}`` (0-dim tensors).

    With a ``placement`` (the dry run), the rows hold this rank's shards
    and share of the clients, a client's parameters are DTensor views of
    its row, the batch and mask are DTensors ([K] over the k dims, as
    JAX's ``vmap`` over a dp-sharded K axis runs each client on its own
    devices), and the loss is the mean over all K clients."""
    layout = placement.layout if placement is not None else row_layout(cfg)
    losses = torch.stack([
        _local(cfg, tuple(c[k] for c in state.client_params),
               {name: _client_tensor(x, k) for name, x in batch.items()},
               lr, local_iters, micro_batches, layout)
        for k in range(state.client_params[0].shape[0])])
    new = _aggregate_and_broadcast(state, mask, placement)
    if placement is not None and placement.k_dims:
        n_k = math.prod(placement.mesh.shape[i] for i in placement.k_dims)
        loss = placement.sum_over_k(_plain(losses.mean()) / n_k)
    else:
        loss = losses.mean()
    return new, {"loss": loss, "participants": mask.sum()}


def _plain(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _client_tensor(t, k: int):
    """Client ``k`` of a ``[K, ...]`` batch leaf: ``t[k]``; for a DTensor
    whose K is split over the dp mesh dims, the local client ``k`` of this
    rank as a DTensor over the remaining mesh dims (a view of the leaf's
    local storage)."""
    from ..models.pshard import is_dtensor
    if not is_dtensor(t):
        return t[k]
    from torch.distributed.tensor import DTensor, Shard
    mesh = t.device_mesh
    names = mesh.mesh_dim_names
    rest = [i for i, p in enumerate(t.placements) if p != Shard(0)]
    sub = mesh[tuple(names[i] for i in rest)] if len(rest) > 1 else \
        mesh[names[rest[0]]]
    placements = [t.placements[i] for i in rest]
    placements = [Shard(p.dim - 1) if isinstance(p, Shard) else p
                  for p in placements]
    return DTensor.from_local(t.to_local()[k], sub, placements,
                              run_check=False, shape=t.shape[1:],
                              stride=t.stride()[1:])


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


# ---------------------------------------------------------------------------
# masked-dp on per-parameter tensors (the dry run's masked-dp programs)
# ---------------------------------------------------------------------------

class _TokenLosses(nn.Module):
    """Per-token cross-entropy (``logsumexp − logits[target]``, as
    ``T.loss`` takes it) and the MoE aux sum of ``model`` on a batch."""

    def __init__(self, model: T.Transformer):
        super().__init__()
        self.model = model

    def forward(self, batch):
        if "embeds" in batch:
            x, aux = T.forward_hidden(self.model, embeds=batch["embeds"])
            targets = batch["labels"]
        else:
            tokens = batch["tokens"]
            x, aux = T.forward_hidden(self.model, tokens=tokens)
            x, targets = x[:, :-1], tokens[:, 1:]
        logits = T._logits(self.model, x)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = settle(torch.gather(logits, -1,
                                  targets.long()[..., None]))[..., 0]
        return lse - tgt, aux


def client_losses(cfg: ArchConfig, params: list, batch: dict,
                  K: int) -> torch.Tensor:
    """Each client's loss from one forward of the merged ``[K·B, ...]``
    batch → ``[K]``: its tokens' mean cross-entropy, plus the MoE aux term
    of the merged batch."""
    merged = {n: x.reshape(-1, *x.shape[2:]) for n, x in batch.items()}
    names = row_layout(cfg).names
    per_token, aux = torch.func.functional_call(
        _TokenLosses(_skeleton(cfg).model),
        {"model." + n: t for n, t in zip(names, params)}, (merged,))
    ce = per_token.reshape(K, -1).mean(-1)
    moe_cfg = cfg.moe
    return ce + (moe_cfg.aux_loss_weight if moe_cfg is not None else 0.0) \
        * aux


def fl_train_step_masked_dp_stacked(state: DistFLState, cfg: ArchConfig,
                                    batch: dict, mask: torch.Tensor,
                                    probs: torch.Tensor, lr: float
                                    ) -> tuple[DistFLState, dict]:
    """:func:`fl_train_step_masked_dp` over per-parameter global tensors
    (``{name: tensor}``; DTensors in the dry run).  The K clients' losses
    come from one forward of the merged batch (:func:`client_losses`;
    the MoE aux term of the merged batch, where JAX takes each client's),
    then one backward of the weighted loss and ``g − lr · ∇L`` in float32,
    in place."""
    names = row_layout(cfg).names
    K = mask.shape[0]
    wgt = (mask / torch.clamp(probs, min=1e-6)).to(torch.float32)
    leaves = [state.global_params[n].detach().requires_grad_()
              for n in names]
    with torch.enable_grad():
        losses = client_losses(cfg, leaves, batch, K)
        total = torch.sum(losses * wgt) / K
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    with torch.no_grad():
        for v, g in zip(leaves, grads):
            if g is not None:
                v.copy_((v.float() - lr * g.float()).to(v.dtype))
    return (DistFLState({n: state.global_params[n] for n in names}, None,
                        None),
            {"loss": losses.detach().mean(), "participants": mask.sum()})
