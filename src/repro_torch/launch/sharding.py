"""Sharding policy: parameter, batch, cache or ledger leaf → placement.
Counterpart of ``repro.launch.sharding``, rule for rule.

Baseline (paper-faithful) layout:
  * virtual-client axis (leading K on replica-mode FL state, batch, masks)
    → data-parallel mesh axes ("pod","data")
  * parameters → Megatron-style 1-D tensor parallelism over "model":
    input-side projections shard the output feature dim, output-side
    projections shard the input feature dim (one all-reduce per block);
    experts shard over "model" (expert parallelism); vocab shards embed /
    unembed.
  * masked-DP mode (jamba-398B / llama4-400B) additionally shards the MoE
    expert stacks' largest remaining dim over "data" (FSDP) so one copy
    fits.

Every rule is divisibility-guarded; anything unmatched replicates.

A spec is JAX's ``PartitionSpec`` as a tuple: one entry a dim, ``None``
(replicated), an axis name, or a tuple of axis names (``("pod", "data")``).
:func:`param_pspec` takes JAX's key paths (``"['blocks'][0]['mixer']
['wq']"``), so a test holds it against JAX's entry by entry;
:func:`module_param_spec` gives the same spec for a name of the port's
``named_parameters()`` (``"layers.5.mixer.wq"``: the layers are unstacked,
so the stacked lead dim drops out).  :func:`to_placements` turns a spec
into DTensor placements on a mesh.  The tree functions take and return
``{name: …}`` dicts (JAX's take and return pytrees).
"""
from __future__ import annotations

import math
import re
from typing import Any

from .mesh import axis_sizes, dp_axes


def _axis_size(mesh, name) -> int:
    return axis_sizes(mesh)[name]


# (regex on keypath, index of dim to shard over "model"); negative = from end
_MODEL_DIM_RULES: list[tuple[str, int | None]] = [
    (r"\['embed'\]$", 0),                 # [V, d] vocab-sharded
    (r"\['unembed'\]$", -1),              # [d, V]
    (r"\['wq'\]$", -1), (r"\['wk'\]$", -1), (r"\['wv'\]$", -1),
    (r"\['wo'\]$", -2),
    (r"\['ffn'\]\['w1'\]$", -1), (r"\['ffn'\]\['w3'\]$", -1),
    (r"\['ffn'\]\['w2'\]$", -2),
    (r"\['router'\]$", None),             # replicated
    (r"\['in_proj'\]$", -1),
    (r"\['out_proj'\]$", -2),
    (r"\['x_proj'\]$", -2),
    (r"\['dt_proj'\]$", -1),
    (r"\['A_log'\]$", -2), (r"\['dt_bias'\]$", -1), (r"\['D'\]$", -1),
    (r"\['conv_w'\]$", -1), (r"\['conv_b'\]$", -1),
    (r"\['wog'\]$", -1), (r"\['out'\]$", -2),
    (r"\['wi'\]$", None), (r"\['wf'\]$", None),
    (r"\['wz'\]$", -1), (r"\['ri'\]$", None), (r"\['rf'\]$", None),
    (r"\['rz'\]$", None), (r"\['ro'\]$", None),
    (r"norm", None), (r"\['ln1'\]$", None), (r"\['ln2'\]$", None),
]

# MoE expert stacks: [R, E, ., .] — expert-parallel over "model"
_EXPERT_RULE = re.compile(r"\['ffn'\]\['w[123]'\]$")


def param_pspec(path: str, shape: tuple[int, ...], mesh, *,
                stacked_layers: bool, fsdp: bool = False) -> tuple:
    """Spec for one parameter leaf.

    path: JAX's ``keystr`` of the leaf inside the *params* pytree (no
    client axis); shape likewise (with the ``[n_repeats]`` lead dim of a
    ``blocks`` leaf when ``stacked_layers``).
    """
    msize = _axis_size(mesh, "model")
    ndim = len(shape)
    spec: list[Any] = [None] * ndim
    lead = 1 if (stacked_layers and "blocks" in path) else 0

    model_dim = None
    if re.search(r"\['w[kv]'\]$", path) and ndim - lead == 2:
        # GQA K/V projections: shard only when every shard holds at least
        # one whole (≤128-wide) KV head, by the flat KV feature dim (the
        # head count is not in the path)
        if shape[-1] % msize == 0 and shape[-1] // msize >= 128:
            model_dim = -1
    elif _EXPERT_RULE.search(path) and ndim - lead >= 3:
        model_dim = lead  # expert stack [.., E, in, out]: shard experts
    else:
        for pat, dim in _MODEL_DIM_RULES:
            if re.search(pat, path):
                if dim is None:
                    model_dim = None
                else:
                    model_dim = dim if dim < 0 else lead + dim
                break
        else:
            # fallback: largest dim (excluding layer-stack dim) divisible
            cand = [(s, i) for i, s in enumerate(shape)
                    if i >= lead and s % msize == 0 and s >= 2 * msize]
            model_dim = max(cand)[1] if cand else None

    if model_dim is not None:
        md = model_dim % ndim
        if shape[md] % msize == 0 and md >= lead:
            spec[md] = "model"
        else:
            # divisibility guard failed → try fallback largest divisible dim
            cand = [(s, i) for i, s in enumerate(shape)
                    if i >= lead and s % msize == 0 and s >= 2 * msize
                    and spec[i] is None]
            if cand:
                spec[max(cand)[1]] = "model"

    if fsdp and _EXPERT_RULE.search(path):
        # FSDP ("data"-axis weight sharding) only on the MoE expert stacks,
        # the only leaves whose replicated copies do not fit
        dsize = _axis_size(mesh, "data")
        if math.prod(shape[lead:]) >= (1 << 24):
            cand = [(s, i) for i, s in enumerate(shape)
                    if i >= lead and spec[i] is None and s % dsize == 0
                    and s >= 8 * dsize]
            if cand:
                spec[max(cand)[1]] = "data"

    return tuple(spec)


def jax_path(name: str, sb: int) -> str:
    """JAX's key path of the port's parameter ``name``: layer ``l`` of the
    port is slice ``l // sb`` of JAX's plan position ``l % sb``
    (``convert.py``)."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts = ["blocks", str(int(parts[1]) % sb)] + parts[2:]
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in parts)


def module_param_spec(name: str, shape: tuple[int, ...], mesh, sb: int, *,
                      fsdp: bool = False) -> tuple:
    """:func:`param_pspec` for the port's parameter ``name`` of ``shape``
    (unstacked)."""
    return param_pspec(jax_path(name, sb), tuple(shape), mesh,
                       stacked_layers=False, fsdp=fsdp)


SMALL_MODEL_ELEMS = int(5e8)


def total_elems(param_shapes: dict) -> int:
    return sum(math.prod(s) for s in param_shapes.values())


def replicated(shape) -> tuple:
    return (None,) * len(shape)


def params_shardings(param_shapes: dict, mesh, sb: int, *,
                     fsdp: bool = False,
                     small_replicate: bool = True) -> dict:
    """``{name: spec}`` for ``{name: shape}`` of the port's parameters.

    Models below SMALL_MODEL_ELEMS replicate entirely (tensor parallelism
    on a 125M model trades negligible memory for per-layer activation
    all-reduces)."""
    if small_replicate and total_elems(param_shapes) < SMALL_MODEL_ELEMS \
            and not fsdp:
        return {n: replicated(s) for n, s in param_shapes.items()}
    return {n: module_param_spec(n, s, mesh, sb, fsdp=fsdp)
            for n, s in param_shapes.items()}


def _dp_spec(mesh):
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def client_stacked_shardings(param_shapes: dict, mesh, sb: int, *,
                             fsdp: bool = False) -> dict:
    """Specs for ``[K, ...]`` client stacks of the parameters
    ``{name: shape}`` (``shape`` without K): K over the dp axes."""
    dp_spec = _dp_spec(mesh)
    small = total_elems(param_shapes) < SMALL_MODEL_ELEMS
    out = {}
    for n, s in param_shapes.items():
        base = replicated(s) if small else module_param_spec(
            n, s, mesh, sb, fsdp=fsdp)
        out[n] = (dp_spec, *base)
    return out


def batch_shardings(batch_shapes: dict, mesh, *, client_axis: bool,
                    shard_model_batch: bool = False) -> dict:
    """Batch leaves: leading K (client) or B (batch) dim over dp axes."""
    dp_spec = _dp_spec(mesh)
    K = int(math.prod(_axis_size(mesh, a) for a in dp_axes(mesh)))
    msize = _axis_size(mesh, "model")

    def one(shape):
        lead = shape[0]
        first = dp_spec if lead % K == 0 and lead >= K else None
        rest = [None] * (len(shape) - 1)
        # small-model DP: also shard the per-client batch dim over "model"
        if shard_model_batch and first is not None and len(shape) > 1 \
                and shape[1] % msize == 0 and shape[1] >= msize:
            rest[0] = "model"
        return (first, *rest)

    return {n: one(s) for n, s in batch_shapes.items()}


def cache_shardings(cache_shapes: dict, mesh, batch: int) -> dict:
    """Decode caches, JAX's ``[R, B, ...]`` leaves: batch over dp if
    divisible; the large per-token dim (KV seq / di) over "model"; for
    batch=1 the KV seq additionally shards over "data".  The port's
    per-layer caches are ``[B, ...]``: pass their shapes with JAX's lead
    dim (``(R, *shape)``) and drop it from the spec."""
    dp_spec = _dp_spec(mesh)
    K = int(math.prod(_axis_size(mesh, a) for a in dp_axes(mesh)))
    msize = _axis_size(mesh, "model")

    def one(shp):
        spec: list[Any] = [None] * len(shp)
        if len(shp) >= 2 and batch % K == 0 and shp[1] == batch \
                and batch >= K:
            spec[1] = dp_spec
            rest_axes = ("model",)
        else:
            rest_axes = ("data", "model") if batch == 1 else ("model",)
        total = int(math.prod(_axis_size(mesh, a) for a in rest_axes))
        cand = [(s, i) for i, s in enumerate(shp)
                if i >= 2 and spec[i] is None and s % total == 0
                and s >= total]
        if cand:
            i = max(cand)[1]
            spec[i] = rest_axes if len(rest_axes) > 1 else rest_axes[0]
        else:
            cand = [(s, i) for i, s in enumerate(shp)
                    if i >= 2 and spec[i] is None and s % msize == 0
                    and s >= msize]
            if cand:
                spec[max(cand)[1]] = "model"
        return tuple(spec)

    return {n: one(s) for n, s in cache_shapes.items()}


def client_axis_shardings(shapes: dict, mesh, axis: str) -> dict:
    """Client-stacked data leaves (``[K, N_max, ...]`` store blocks): the
    leading K axis over mesh axis ``axis``, the rest replicated; a leaf
    whose leading dim does not divide the axis replicates entirely."""
    size = _axis_size(mesh, axis)

    def one(shp):
        if len(shp) >= 1 and shp[0] % size == 0 and shp[0] >= size:
            return (axis, *([None] * (len(shp) - 1)))
        return ()

    return {n: one(tuple(s)) for n, s in shapes.items()}


def ledger_shardings(shapes: dict, mesh, axis: str = "k") -> dict:
    """The population-sized ``[K]`` ledgers of the sparse engine's phase
    A: the same rule as :func:`client_axis_shardings`."""
    return client_axis_shardings(shapes, mesh, axis)


def to_placements(spec: tuple, mesh) -> list:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for ``spec``: mesh
    dim m is ``Shard(i)`` where entry i names its axis (alone or in a
    tuple), else ``Replicate()``.  A dim over ``("pod", "data")`` is
    ``Shard`` on both mesh dims, in the tuple's order; a mesh dim of one
    rank replicates."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            m = names.index(axis)
            # a split over one rank is the whole tensor: Replicate (DTensor
            # would refuse to flatten a dim "split" that way)
            if mesh.shape[m] > 1:
                placements[m] = Shard(i)
    return placements
