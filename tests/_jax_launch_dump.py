"""Dump JAX's launch-layer placements and argument shapes as JSON, for the
port's tests (``tests/test_torch_launch.py``, ``test_torch_dryrun.py``).

Run as a subprocess: it fabricates host devices before JAX starts.

    python tests/_jax_launch_dump.py specs OUT.json
        every arch × shape program's argument leaves on the 16×16 and
        2×16×16 meshes: path, shape, dtype, spec (512 host devices)
    python tests/_jax_launch_dump.py reduced OUT.json
        reduced configs on a 2×4 mesh: argument leaves and
        ``memory_analysis().argument_size_in_bytes`` (8 host devices)
"""
import json
import os
import sys

MODE = sys.argv[1]
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                           + ("512" if MODE == "specs" else "8"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.configs.shapes import SHAPES, InputShape  # noqa: E402
from repro.launch import specs as JS  # noqa: E402

#: reduced configs and shapes shared with the port's tests
REDUCED = {
    "llama3.2-1b": dict(layers=2, d_model=512, n_heads=8, n_kv_heads=8),
    "qwen3-moe-30b-a3b": dict(layers=2, d_model=512, n_heads=8,
                              n_kv_heads=8),
    "jamba-1.5-large-398b": dict(layers=8, d_model=256, n_heads=8,
                                 n_kv_heads=8),
    "xlstm-125m": dict(layers=2, d_model=256, n_heads=4),
}
REDUCED_SHAPES = {"train_small": InputShape("train_small", 64, 8, "train"),
                  "prefill_small": InputShape("prefill_small", 64, 4,
                                              "prefill"),
                  "decode_small": InputShape("decode_small", 64, 4,
                                             "decode")}


_init_params = JT.init_params


def _init_params_fast(key, cfg):
    """``init_params`` for ``eval_shape``: one super-block traced, its
    ``blocks`` leaves broadcast to ``n_repeats`` on the lead axis — the
    same shapes and dtypes as the full init, without tracing every layer
    (the full traces took ~10 minutes for the 80 programs)."""
    sb = len(cfg.mixer_pattern)
    if cfg.n_layers == sb:
        return _init_params(key, cfg)
    p = _init_params(key, dataclasses.replace(cfg, n_layers=sb))
    p["blocks"] = jax.tree_util.tree_map(
        lambda leaf: jnp.broadcast_to(leaf, (cfg.n_repeats,) + leaf.shape[1:]),
        p["blocks"])
    return p


def spec_of(sharding):
    out = []
    for e in sharding.spec:
        out.append(list(e) if isinstance(e, tuple) else e)
    return out


def leaves(spec):
    args = jax.tree_util.tree_flatten_with_path(spec.args)[0]
    shards = jax.tree_util.tree_leaves(
        spec.in_shardings,
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    assert len(args) == len(shards)
    return [{"path": jax.tree_util.keystr(kp), "shape": list(a.shape),
             "dtype": str(a.dtype), "spec": spec_of(s)}
            for (kp, a), s in zip(args, shards)]


def dump_specs():
    JT.init_params = _init_params_fast
    out = {}
    for multi in (False, True):
        shape = (2, 16, 16) if multi else (16, 16)
        axes = ("pod", "data", "model") if multi else ("data", "model")
        mesh = jax.make_mesh(shape, axes)
        for arch in configs.names():
            for sh in SHAPES:
                spec = JS.input_specs(arch, sh, mesh)
                out[f"{arch}|{sh}|{'x'.join(map(str, shape))}"] = {
                    "leaves": leaves(spec),
                    "mode": spec.meta.get("mode", "-")}
    return out


def dump_reduced():
    JS.SHAPES.update(REDUCED_SHAPES)
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    out = {}
    for arch, kw in REDUCED.items():
        cfg = configs.get(arch).reduced(**kw)
        for sh in REDUCED_SHAPES:
            spec = JS.input_specs(arch, sh, mesh, cfg_override=cfg)
            with mesh:
                compiled = jax.jit(
                    spec.fn, in_shardings=spec.in_shardings,
                    out_shardings=spec.out_shardings).lower(
                        *spec.args).compile()
            mem = compiled.memory_analysis()
            out[f"{arch}|{sh}"] = {
                "leaves": leaves(spec), "mode": spec.meta.get("mode", "-"),
                "argument_size_in_bytes": int(mem.argument_size_in_bytes)}
    return out


if __name__ == "__main__":
    data = dump_specs() if MODE == "specs" else dump_reduced()
    with open(sys.argv[2], "w") as f:
        json.dump(data, f)
