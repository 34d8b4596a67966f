"""input_specs(): stand-in arguments and placements for every
(architecture × input-shape) program.  Counterpart of
``repro.launch.specs``.

JAX's stand-ins are ``ShapeDtypeStruct``\\ s; the port's are fake tensors
made under a ``FakeTensorMode`` (nothing is allocated), each wrapped as a
DTensor with its placements on the mesh (``DTensor.from_local`` of this
rank's shard).  The dry run runs a program's ``fn`` on its ``args`` under
that mode (``meta["fake_mode"]``).  ``input_specs(..., make=...)`` builds
real local shards instead (``chip_smoke.py`` runs the same programs on the
card so).

Programs, as JAX's:

* train, replica mode: ``fl.distributed.fl_train_step`` itself, over flat
  rows of this rank's shards (``[K / n, P_g]`` clients and anchors,
  ``[P_g]`` global, one a dtype), whose per-parameter views are the
  DTensors of JAX's client stacks ``[K, …]`` (``fl.distributed.
  RowPlacement``; a flat row as a DTensor could not carry a
  tensor-parallel placement per parameter).  The argument tree that
  ``abstract=True`` gives and ``in_placements`` describe those stacks;
  ``micro`` 8 above 1.5e10 parameters;
* train, masked-dp mode: ``fl_train_step_masked_dp_stacked`` on the FSDP
  global parameters;
* prefill: the greedy next token and the caches;
* decode: one token against a full cache (``pos`` = S).

``in_placements``/``out_placements`` hold the specs of ``sharding.py``
(``{leaf name: spec}``), JAX's ``in_shardings``/``out_shardings``.
A leaf's name is its path in the arguments: ``state.client_params.
layers.0.mixer.wq``, ``batch.tokens``, ``caches.3.k``.  A KV cache's
``pos`` is a Python int, where JAX's is an int32 array leaf.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch import nn

from .. import configs
from ..configs.base import ArchConfig
from ..configs.shapes import SHAPES, InputShape
from ..fl.distributed import (DistFLState, RowPlacement, fl_train_step,
                              fl_train_step_masked_dp_stacked, mode_for,
                              param_count, row_layout)
from ..models import transformer as T
from . import sharding as SH
from .mesh import num_clients


class ProgramSpec(NamedTuple):
    name: str
    fn: Callable          # positional-args function the dry run calls
    args: tuple           # pytrees of (fake) DTensors
    in_placements: tuple  # {leaf name: spec} for each argument
    out_placements: Any
    meta: dict


class Leaf(NamedTuple):
    """An argument leaf before it is made: global shape, dtype, spec."""
    shape: tuple
    dtype: torch.dtype
    spec: tuple


def _model_dtype(cfg: ArchConfig) -> torch.dtype:
    return T.DTYPES[cfg.dtype]


def _train_batch_struct(cfg: ArchConfig, K: int, B_per: int,
                        S: int) -> dict:
    """``{name: (shape, dtype)}`` of a train batch."""
    if cfg.embeds_input:
        return {"embeds": ((K, B_per, S, cfg.d_model), _model_dtype(cfg)),
                "labels": ((K, B_per, S), torch.int32)}
    return {"tokens": ((K, B_per, S), torch.int32)}


def param_shapes(cfg: ArchConfig) -> dict:
    """``{name: (shape, dtype)}`` of the port's parameters (built on the
    meta device: nothing is allocated)."""
    model = T.Transformer(cfg, device="meta")
    return {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}


def cache_structs(cfg: ArchConfig, batch: int, capacity: int) -> list:
    """The port's per-layer caches on the meta device."""
    return T.init_caches(cfg, batch, capacity, device="meta")


def local_shape(shape: tuple, placements, mesh) -> tuple:
    """This rank's (rank 0's) shard shape: each ``Shard(i)`` mesh dim
    splits dim i as ``torch.chunk`` does (its first chunk)."""
    out = list(shape)
    for m, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] = -(-out[p.dim] // mesh.shape[m])
    return tuple(out)


def _contiguous_stride(shape: tuple) -> tuple:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def fake_maker(fake_mode, device_type: str = "cpu"):
    """``make(shape, dtype)`` of empty fake tensors under ``fake_mode``."""
    def make(shape, dtype):
        with fake_mode:
            return torch.empty(shape, dtype=dtype, device=device_type)
    return make


def to_dtensor(leaf: Leaf, mesh, make) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    placements = SH.to_placements(leaf.spec, mesh)
    local = make(local_shape(leaf.shape, placements, mesh), leaf.dtype)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(leaf.shape),
                              stride=_contiguous_stride(leaf.shape))


def _tree_leaves(prefix: str, tree) -> list:
    """``[(name, Leaf)]`` of a nested dict / list / NamedTuple of Leaves."""
    if isinstance(tree, Leaf):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = ((f, getattr(tree, f)) for f in tree._fields)
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), x) for i, x in enumerate(tree))
    else:
        return []
    out = []
    for k, v in items:
        out += _tree_leaves(f"{prefix}.{k}" if prefix else str(k), v)
    return out


def _build(tree, mesh, make):
    """``tree`` with each Leaf made into a DTensor."""
    if isinstance(tree, Leaf):
        return to_dtensor(tree, mesh, make)
    if isinstance(tree, dict):
        return {k: _build(v, mesh, make) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_build(getattr(tree, f), mesh, make)
                            for f in tree._fields))
    if isinstance(tree, list):
        return [_build(v, mesh, make) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_build(v, mesh, make) for v in tree)
    return tree


def leaf_specs(names_and_trees) -> tuple:
    """``{leaf name: spec}`` of each argument tree."""
    return tuple({n: leaf.spec for n, leaf in _tree_leaves(prefix, tree)}
                 for prefix, tree in names_and_trees)


def bind(cfg: ArchConfig, params: dict) -> T.Transformer:
    """A :class:`~models.transformer.Transformer` whose parameters are the
    tensors ``params`` (``{name: tensor}``, DTensors too): no copy."""
    model = T.Transformer(cfg, device="meta")
    for name, t in params.items():
        owner, _, leaf = name.rpartition(".")
        sub = model.get_submodule(owner) if owner else model
        sub._parameters[leaf] = nn.Parameter(t, requires_grad=False)
    return model


def _params_tree(shapes: dict, specs: dict) -> dict:
    return {n: Leaf(s, dt, specs[n]) for n, (s, dt) in shapes.items()}


def _caches_tree(cfg: ArchConfig, B: int, S: int, mesh, pos: int) -> list:
    caches = cache_structs(cfg, B, S)
    R = cfg.n_repeats
    shapes = {f"{i}.{f}": (R, *getattr(c, f).shape)
              for i, c in enumerate(caches) for f in c._fields
              if isinstance(getattr(c, f), torch.Tensor)}
    specs = SH.cache_shardings(shapes, mesh, B)
    out = []
    for i, c in enumerate(caches):
        fields = {}
        for f in c._fields:
            t = getattr(c, f)
            if isinstance(t, torch.Tensor):
                fields[f] = Leaf(tuple(t.shape), t.dtype,
                                 specs[f"{i}.{f}"][1:])
            else:
                fields[f] = pos       # a KVCache's ``pos``
        out.append(type(c)(**fields))
    return out


def _replica_rows(cfg: ArchConfig, K: int, gspec: dict, cspec: dict, mesh,
                  make) -> tuple:
    """The replica round's rows on ``mesh`` and their :class:`fl.
    distributed.RowPlacement`: the global rows hold this rank's shards of
    the parameters under ``gspec``, the client and anchor rows its share of
    the K clients (``[K / n, P_g]``) and their shards under ``cspec`` (K
    over the dp dims).  A client's parameters lie on the mesh dims that do
    not split K, as the same shards: the global and client rows line up
    element for element."""
    layout = row_layout(cfg)
    names = mesh.mesh_dim_names
    full = {n: SH.to_placements(cspec[n], mesh) for n in layout.names}
    first = full[layout.names[0]]
    k_dims = tuple(i for i, p in enumerate(first) if p.is_shard(0))
    rest = [i for i in range(mesh.ndim) if i not in k_dims]
    sub = mesh[tuple(names[i] for i in rest)] if len(rest) > 1 else \
        mesh[names[rest[0]]]
    client = {n: [p if not p.is_shard() else type(p)(p.dim - 1)
                  for i, p in enumerate(pl) if i not in k_dims]
              for n, pl in full.items()}
    placed = layout.placed(sub, client,
                           lambda s, pl: local_shape(s, pl, sub))
    glob = {n: SH.to_placements(gspec[n], mesh) for n in layout.names}
    if any(local_shape(s, glob[n], mesh) != placed.shapes[i]
           for i, (n, s) in enumerate(zip(layout.names, layout.shapes))):
        raise ValueError("the global and client shards do not line up")
    from torch.distributed.tensor import Replicate
    n_local = local_shape((K,), [p if p.is_shard(0) else Replicate()
                                 for p in first], mesh)[0]
    rows = tuple(make((size,), dt)
                 for dt, size in zip(placed.dtypes, placed.sizes))
    clients, anchors = (tuple(make((n_local, size), dt) for dt, size in
                              zip(placed.dtypes, placed.sizes))
                        for _ in range(2))
    return (RowPlacement(placed, mesh, k_dims),
            DistFLState(rows, clients, anchors))


def _greedy(logits):
    """The greedy token; a vocab-split DTensor is gathered first (DTensor's
    own distributed argmax reads its shard offsets on the host, which a
    fake tensor cannot give)."""
    from ..models.pshard import gather_dim
    return torch.argmax(gather_dim(logits, -1), dim=-1).to(torch.int32)


def input_specs(arch: str, shape_name: str | InputShape, mesh,
                lr: float = 0.01, cfg_override: ArchConfig | None = None,
                mode_override: str | None = None, *,
                clients: int | None = None, make=None,
                device_type: str | None = None,
                abstract: bool = False) -> ProgramSpec:
    """The program of ``arch`` at ``shape_name`` (a name of ``SHAPES`` or
    an :class:`InputShape`) on ``mesh`` (a ``DeviceMesh``).  ``clients``
    overrides K (JAX's: the product of the dp axes).  ``make(shape,
    dtype)`` makes a local shard; by default an empty fake tensor under a
    new ``FakeTensorMode`` (``meta["fake_mode"]``).  ``abstract`` leaves
    each argument leaf a :class:`Leaf` (shape, dtype, spec: JAX's
    ``ShapeDtypeStruct`` with its sharding), and ``mesh`` may then be a
    ``mesh.MeshSpec``: no process group is needed."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    cfg = cfg_override or configs.get(arch, shape)
    K = clients or num_clients(mesh)
    sb = len(cfg.mixer_pattern)
    fake_mode = None
    if not abstract and make is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        make = fake_maker(fake_mode, device_type or mesh.device_type)

    def build(trees) -> tuple:
        return tuple(t if abstract else _build(t, mesh, make)
                     for _, t in trees)
    shapes = param_shapes(cfg)
    plain_shapes = {n: s for n, (s, _) in shapes.items()}
    name = f"{arch}:{shape.name}"

    def meta(**kw):
        return {"cfg": cfg, "fake_mode": fake_mode, **kw}

    if shape.kind == "train":
        mode = mode_override or mode_for(cfg)
        B_per = max(shape.global_batch // K, 1)
        fsdp = mode == "masked_dp"
        gspec = SH.params_shardings(plain_shapes, mesh, sb, fsdp=fsdp)
        glob = _params_tree(shapes, gspec)
        batch = {n: Leaf(s, dt, None) for n, (s, dt) in
                 _train_batch_struct(cfg, K, B_per, shape.seq_len).items()}
        small = param_count(cfg) < SH.SMALL_MODEL_ELEMS and mode == "replica"
        bspec = SH.batch_shardings({n: l.shape for n, l in batch.items()},
                                   mesh, client_axis=True,
                                   shard_model_batch=small)
        batch = {n: l._replace(spec=bspec[n]) for n, l in batch.items()}
        mask = Leaf((K,), torch.float32, (None,))
        repl = {"loss": (), "participants": ()}
        if mode == "replica":
            cspec = SH.client_stacked_shardings(plain_shapes, mesh, sb)
            stacks = {n: Leaf((K, *s), dt, cspec[n])
                      for n, (s, dt) in shapes.items()}
            state = DistFLState(glob, stacks, dict(stacks))
            micro = 8 if param_count(cfg) > 1.5e10 else 1
            while B_per % micro != 0:
                micro //= 2
            trees = (("state", state), ("batch", batch), ("mask", mask))

            def fn(state, batch, mask):
                # on plain tensors (a world of one rank's shards, unwrapped)
                # the plain round
                from ..models.pshard import is_dtensor
                return fl_train_step(state, cfg, batch, mask, lr, 1, micro,
                                     placement=placement if is_dtensor(mask)
                                     else None)
        else:
            state = DistFLState(glob, None, None)
            probs = Leaf((K,), torch.float32, (None,))

            def fn(state, batch, mask, probs):
                return fl_train_step_masked_dp_stacked(state, cfg, batch,
                                                       mask, probs, lr)
            trees = (("state", state), ("batch", batch), ("mask", mask),
                     ("probs", probs))
        in_pl = leaf_specs(trees)
        if mode == "replica" and not abstract:
            # the state as rows of this rank's shards, made first (the
            # allocator model takes the leaves in order); ``in_placements``
            # keep the stacks' specs, which the rows' views carry
            placement, rows = _replica_rows(cfg, K, gspec, cspec, mesh, make)
            args = (rows, *build(trees[1:]))
        else:
            args = build(trees)
        return ProgramSpec(
            name=name, fn=fn, args=args,
            in_placements=in_pl, out_placements=(in_pl[0], repl),
            meta=meta(mode=mode, kind="train", K=K, B_per=B_per,
                      seq=shape.seq_len,
                      micro=micro if mode == "replica" else 1))

    # prefill keeps TP even for small models; decode replicates them
    pspec = SH.params_shardings(plain_shapes, mesh, sb,
                                small_replicate=shape.kind != "prefill")
    params = _params_tree(shapes, pspec)
    B, S = shape.global_batch, shape.seq_len

    if shape.kind == "prefill":
        if cfg.embeds_input:
            batch = {"embeds": ((B, S, cfg.d_model), _model_dtype(cfg))}
        else:
            batch = {"tokens": ((B, S), torch.int32)}
        bspec = SH.batch_shardings({n: s for n, (s, _) in batch.items()},
                                   mesh, client_axis=False)
        batch = {n: Leaf(s, dt, bspec[n]) for n, (s, dt) in batch.items()}
        out_caches = _caches_tree(cfg, B, S, mesh, S)

        def fn(params, batch):
            model = bind(cfg, params)
            logits, caches = T.prefill(model, capacity=S, **batch)
            return _greedy(logits), caches
        trees = (("params", params), ("batch", batch))
        return ProgramSpec(
            name=name, fn=fn, args=build(trees),
            in_placements=leaf_specs(trees),
            out_placements=((), leaf_specs((("caches", out_caches),))[0]),
            meta=meta(kind="prefill", B=B, seq=S))

    # decode: one token against a full cache (pos = S)
    caches = _caches_tree(cfg, B, S, mesh, S)
    token = Leaf((B, 1), torch.int32, None)
    token = token._replace(spec=SH.batch_shardings(
        {"t": token.shape}, mesh, client_axis=False)["t"])

    def fn(params, token, caches):
        model = bind(cfg, params)
        logits, caches = T.decode_step(model, token, caches)
        return _greedy(logits), caches
    trees = (("params", params), ("token", token), ("caches", caches))
    in_pl = leaf_specs(trees)
    return ProgramSpec(
        name=name, fn=fn, args=build(trees),
        in_placements=in_pl, out_placements=(token.spec, in_pl[2]),
        meta=meta(kind="decode", B=B, seq=S))
