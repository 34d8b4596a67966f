"""Param trees between the JAX package and the port, through numpy.

``params_from_jax`` takes the JAX MLP's param list or CNN tree as numpy
arrays (for example ``jax.tree_util.tree_map(np.asarray, params)``) and
returns the port's params; ``params_to_numpy`` goes back.  Both keep JAX's
leaf shapes (``{"w": [n_in, n_out], "b": [n_out]}`` per dense layer, HWIO
conv weights), so the two packages can train from the same weights.  The
CNN's ``{"convs": [...], "fc1", "fc2"}`` tree becomes the port's list
``[*convs, fc1, fc2]``, which flattens in the same order, and a list whose
first layer has a 4-D weight goes back to that tree.

``transformer_from_jax`` does the same for the decoder stack: it takes JAX's
``init_params`` tree (``embed``, ``blocks``, ``final_norm``, ``unembed``)
as numpy arrays, unstacks the leading ``[n_repeats]`` axis of ``blocks``
into the port's ``layers``, and casts each leaf to the model's dtype;
``transformer_to_numpy`` stacks it back (as float32 arrays, since numpy has
no bfloat16).  Every mixer's leaves go both ways by name: attention,
Mamba, MoE and the xLSTM's (``mlstm``: ``wq`` … ``out``, ``wi``/``wf``;
``slstm``: ``out`` and ``w``/``r``/``b`` of each gate).

``dist_state_from_jax`` takes JAX's ``fl.distributed.DistFLState`` (the
global tree and the clients' and anchors' trees stacked on a leading
``[K]`` axis, as numpy arrays) to the port's flat rows (``[P_g]`` and
``[K, P_g]`` per dtype of ``fl.distributed.row_layout``);
``dist_state_to_numpy`` goes back, so both packages can start a round from
the same state.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def params_from_jax(tree, device=None):
    """A list of ``{name: array}`` layers, or JAX's CNN tree, → a list of
    layers of float32 tensors on ``device`` (``None`` means the card)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        tree = [*tree["convs"], tree["fc1"], tree["fc2"]]
    return [{name: torch.tensor(np.asarray(a), dtype=torch.float32,
                                device=device)
             for name, a in layer.items()} for layer in tree]


def params_to_numpy(params):
    """The port's params → a list of ``{name: np.ndarray}`` layers, or
    JAX's CNN tree when the first layer is a convolution."""
    layers = [{name: t.detach().cpu().numpy() for name, t in layer.items()}
              for layer in params]
    if layers[0]["w"].ndim == 4:
        return {"convs": layers[:-2], "fc1": layers[-2], "fc2": layers[-1]}
    return layers


@torch.no_grad()
def load_jax_tree(module: torch.nn.Module, tree: dict) -> None:
    """Copy a nested ``{name: array}`` tree into the parameters (or
    submodules) of ``module`` of the same names, casting each array to its
    parameter's dtype.  Every parameter must be given, with its shape."""
    given = set()
    for name, value in tree.items():
        if isinstance(value, dict):
            load_jax_tree(getattr(module, name), value)
            given.add(name)
            continue
        param = getattr(module, name)
        a = np.array(value, dtype=np.float32)     # a writable copy
        if tuple(a.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {a.shape}, expected "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(a))
        given.add(name)
    missing = {n.split(".")[0] for n, _ in module.named_parameters()} - given
    if missing:
        raise ValueError(f"no value for {sorted(missing)}")


def transformer_from_jax(tree: dict, cfg, device=None):
    """JAX's transformer param tree (numpy leaves) → a
    ``models.transformer.Transformer`` on ``device`` (``None``: the card)."""
    from .models.transformer import Transformer
    model = Transformer(cfg, resolve_device(device))
    plan = cfg.layer_plan()
    flat = {k: v for k, v in tree.items() if k != "blocks"}
    load_jax_tree(model, {**flat, "layers": {
        str(r * len(plan) + i): _take(tree["blocks"][i], r)
        for r in range(cfg.n_repeats) for i in range(len(plan))}})
    return model


def _take(tree, r: int):
    return {k: _take(v, r) if isinstance(v, dict) else np.asarray(v)[r]
            for k, v in tree.items()}


def transformer_to_numpy(model) -> dict:
    """The inverse of :func:`transformer_from_jax`: JAX's tree layout with
    ``blocks`` stacked on ``[n_repeats]``, as float32 numpy arrays."""
    cfg = model.cfg
    plan = cfg.layer_plan()

    def tree(module):
        out = {n: p.detach().float().cpu().numpy()
               for n, p in module.named_parameters(recurse=False)}
        out.update({n: tree(m) for n, m in module.named_children()})
        return out

    layers = [tree(block) for block in model.layers]
    blocks = [_stack([layers[r * len(plan) + i]
                      for r in range(cfg.n_repeats)])
              for i in range(len(plan))]
    out = {n: p.detach().float().cpu().numpy()
           for n, p in model.named_parameters(recurse=False)}
    out["blocks"] = blocks
    return out


def _stack(trees):
    """The trees' arrays stacked on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {n: _stack([t[n] for t in trees]) for n in first}
    if isinstance(first, (list, tuple)):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return np.stack(trees)


def _index(tree, k: int):
    """Leaf ``[k]`` of every array of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {n: _index(v, k) for n, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_index(v, k) for v in tree]
    return np.asarray(tree)[k]


def _num_clients(stacked) -> int:
    while isinstance(stacked, (dict, list, tuple)):
        stacked = (next(iter(stacked.values())) if isinstance(stacked, dict)
                   else stacked[0])
    return np.asarray(stacked).shape[0]


def dist_state_from_jax(state, cfg, device=None):
    """JAX's ``DistFLState`` (numpy leaves; clients and anchors stacked on
    ``[K]``, or ``None`` in masked-dp mode) → the port's
    ``fl.distributed.DistFLState`` of rows on ``device``."""
    from .fl.distributed import DistFLState, row_layout
    layout = row_layout(cfg)
    device = resolve_device(device)

    def rows(tree):
        return layout.flatten(transformer_from_jax(tree, cfg, device))

    def stacked_rows(stacked):
        per = [rows(_index(stacked, k)) for k in range(_num_clients(stacked))]
        return tuple(torch.stack([p[g] for p in per])
                     for g in range(len(layout.dtypes)))

    global_tree, clients, anchors = state
    if clients is None:
        return DistFLState(rows(global_tree), None, None)
    return DistFLState(rows(global_tree), stacked_rows(clients),
                       stacked_rows(anchors))


def dist_state_to_numpy(state, cfg):
    """The inverse of :func:`dist_state_from_jax`: a ``DistFLState`` of JAX
    trees (float32 numpy leaves; clients and anchors stacked on
    ``[K]``)."""
    from .fl.distributed import DistFLState, row_layout
    layout = row_layout(cfg)

    def tree(rows):
        return transformer_to_numpy(layout.module(cfg, rows))

    def stacked(rows):
        if rows is None:
            return None
        return _stack([tree(tuple(r[k] for r in rows))
                       for k in range(rows[0].shape[0])])

    return DistFLState(tree(state.global_params),
                       stacked(state.client_params),
                       stacked(state.anchor_params))
