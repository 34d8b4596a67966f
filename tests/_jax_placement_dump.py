"""Dump JAX's placed dense runs as an ``.npz``, for the port's tests
(``tests/test_torch_placement.py``).

Run as a subprocess: it fabricates 4 host devices before JAX starts, so
``make_runner``'s default (``shard_clients=None``) places the client axis.

    python tests/_jax_placement_dump.py OUT.npz

The file holds JAX's mesh size for each K of ``MESH_KS`` (0 for no mesh),
and for each K of ``WORLD_KS``: the quickstart's world reduced (inputs,
labels, gains, initial MLP), then each case of ``CASES`` run placed by
``make_runner``'s default: masks, eval rounds, ``last_tx``, energies,
accuracy and loss, the final global and client leaves, and the spec of
the client leaves' sharding.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import CellConfig  # noqa: E402
from repro.core.channel import channel_gains, sample_positions  # noqa: E402
from repro.core.selection import AgeAwareScheme, RandomScheme  # noqa: E402
from repro.data import make_mnist_like, shard_noniid  # noqa: E402
from repro.data.synthetic import Dataset  # noqa: E402
from repro.fl import (AggregatorConfig, GuardConfig, SimConfig,  # noqa: E402
                      make_runner)
from repro.fl.engine import _client_mesh  # noqa: E402
from repro.models.small import init_mlp, mlp_accuracy, mlp_loss  # noqa: E402

MESH_KS = (3, 7, 8, 10, 12)
WORLD_KS = (8, 10)
T, DIM = 4, 64
BASE = dict(rounds=T, local_iters=2, batch_size=8, eval_every=2,
            eval_batch=200, data_path="device")
CASES = {
    "random": (lambda K: RandomScheme(0.5, K), {}),
    "age_guarded": (lambda K: AgeAwareScheme(3, K), dict(
        aggregator=AggregatorConfig(kind="age"),
        guards=GuardConfig(quarantine=True))),
}


def world(K: int):
    """``examples/quickstart.py``'s world at n_train 1,000, n_test 200, the
    first 64 input features, T 4 and a 64-24-10 MLP."""
    tr, te = make_mnist_like(jax.random.PRNGKey(0), n_train=1000, n_test=200)
    clients = [Dataset(c.x[:, :DIM], c.y, c.num_classes)
               for c in shard_noniid(jax.random.PRNGKey(1), tr, K, d=5)]
    te = Dataset(te.x[:, :DIM], te.y, te.num_classes)
    cell = CellConfig(num_clients=K)
    h = channel_gains(jax.random.PRNGKey(3),
                      sample_positions(jax.random.PRNGKey(2), cell), T).T
    params = init_mlp(jax.random.PRNGKey(4), dims=(DIM, 24, 10))
    return clients, te, cell, h, params


def main(out: str) -> None:
    if len(jax.devices()) != 4:
        raise SystemExit(f"expected 4 host devices, got {jax.devices()}")
    dump = {"mesh_ks": np.asarray(MESH_KS),
            "mesh_d": np.asarray([0 if _client_mesh(K) is None
                                  else _client_mesh(K).devices.size
                                  for K in MESH_KS])}
    for K in WORLD_KS:
        clients, te, cell, h, params = world(K)
        p = f"K{K}/"
        for k, c in enumerate(clients):
            dump[p + f"x{k}"] = np.asarray(c.x)
            dump[p + f"y{k}"] = np.asarray(c.y)
        dump[p + "test_x"], dump[p + "test_y"] = np.asarray(te.x), \
            np.asarray(te.y)
        dump[p + "h"] = np.asarray(h)
        for i, layer in enumerate(params):
            for name, a in layer.items():
                dump[p + f"param{i}_{name}"] = np.asarray(a)
        for case, (policy, extra) in CASES.items():
            cfg = SimConfig(**BASE, **extra)
            res = make_runner(mlp_loss, mlp_accuracy, clients, te,
                              policy(K), cell, cfg)(params, h)
            q = p + case + "/"
            for name in ("participation", "eval_rounds", "energy_per_client",
                         "energy_timeline", "test_acc", "test_loss"):
                dump[q + name] = np.asarray(getattr(res, name))
            st = res.state
            dump[q + "last_tx"] = np.asarray(st.last_tx)
            for i, a in enumerate(jax.tree_util.tree_leaves(
                    st.global_params)):
                dump[q + f"global{i}"] = np.asarray(a)
            leaves = jax.tree_util.tree_leaves(st.client_params)
            for i, a in enumerate(leaves):
                dump[q + f"client{i}"] = np.asarray(a)
            dump[q + "client_spec"] = np.asarray(
                str(leaves[0].sharding.spec))
    np.savez(out, **dump)


if __name__ == "__main__":
    main(sys.argv[1])
