"""The 15 golden scheme × path traces (tests/golden/harness.py) of the port
on the CPU, held against live JAX runs of the same harness.

``tests/golden/traces.json`` does not reproduce on the installed JAX, so
JAX's traces are computed here, once per module, by
``harness.compute_traces()``.  The port runs the same five schemes
(``harness.scheme_panel``: the policies and aggregators built in the port,
their settings checked against JAX's) on the same three paths (the dense
engine, the legacy host loop, the sparse engine) with ``harness._cfg``'s
settings, from ``harness.golden_world()``'s data, gains and params
converted through numpy.  ``harness.compare_traces`` holds each trace: the
participation masks by sha256, the eval grid exactly, loss, accuracy and
the energy timeline within its RTOL 1e-4 / ATOL 1e-5.  The port's three
paths must also realize the same masks.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro_torch.core.selection as tsel
from repro_torch.convert import params_from_jax
from repro_torch.core import CellConfig
from repro_torch.data import Dataset
from repro_torch.fl import (AggregatorConfig, SimConfig, make_sparse_runner,
                            run_simulation, run_simulation_legacy)
from repro_torch.models.small import mlp_accuracy, mlp_loss

from golden import harness

SCHEMES = ("paper", "fedasync-hinge", "fedasync-poly", "csmaafl",
           "age-aware")
KEYS = [f"{s}/{p}" for s in SCHEMES for p in harness.PATHS]


def to_torch(ds):
    return Dataset(torch.from_numpy(np.array(ds.x)),
                   torch.from_numpy(np.array(ds.y)), ds.num_classes)


def port_panel(K: int) -> dict:
    """``harness.scheme_panel`` with the port's policies and aggregators."""
    return {
        "paper": (tsel.random_policy(0.4, K), AggregatorConfig(kind="paper")),
        "fedasync-hinge": (tsel.random_policy(0.4, K),
                           AggregatorConfig(kind="fedasync",
                                            staleness_fn="hinge")),
        "fedasync-poly": (tsel.random_policy(0.4, K),
                          AggregatorConfig(kind="fedasync",
                                           staleness_fn="poly")),
        "csmaafl": (tsel.csma_policy(2, K), AggregatorConfig(kind="csmaafl")),
        "age-aware": (tsel.age_aware_policy(2, K),
                      AggregatorConfig(kind="age")),
    }


def port_cfg(T: int, aggregator) -> SimConfig:
    """``harness._cfg`` in the port: the same fields and values."""
    want = dataclasses.asdict(harness._cfg(T, None))
    kw = {f: want[f] for f in ("rounds", "local_iters", "batch_size",
                               "eval_every", "local_mode", "data_path",
                               "data_stream")}
    cfg = SimConfig(aggregator=aggregator, **kw)
    mine = dataclasses.asdict(dataclasses.replace(cfg, aggregator=None))
    assert mine == want, "harness._cfg has settings the port does not copy"
    return cfg


@pytest.fixture(scope="module")
def jax_traces():
    return harness.compute_traces()


@pytest.fixture(scope="module")
def port_traces():
    clients, te, cell, h, params, K, T = harness.golden_world()
    t_clients = [to_torch(c) for c in clients]
    t_test = to_torch(te)
    t_h = torch.from_numpy(np.array(h))
    t_params = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               device="cpu")
    t_cell = CellConfig(num_clients=K)
    jpanel, panel = harness.scheme_panel(K), port_panel(K)
    assert list(jpanel) == list(panel) == list(SCHEMES)
    traces, masks = {}, {}
    for name, (policy, agg) in panel.items():
        assert dataclasses.asdict(agg) == dataclasses.asdict(jpanel[name][1])
        cfg = port_cfg(T, agg)
        args = (t_params, mlp_loss, mlp_accuracy, t_clients, t_test, policy,
                t_h, t_cell, cfg)
        runs = {
            "dense": run_simulation(*args, device="cpu"),
            "legacy": run_simulation_legacy(*args, device="cpu"),
            "sparse": make_sparse_runner(mlp_loss, mlp_accuracy, t_clients,
                                         t_test, policy, t_cell, cfg,
                                         device="cpu")(t_params, t_h),
        }
        assert runs["dense"].state.client_params is not None
        assert runs["sparse"].state.client_params is None
        for path, res in runs.items():
            traces[f"{name}/{path}"] = harness._trace(res)
            masks[name, path] = res.participation
    return {"traces": traces}, masks


def test_the_port_computes_the_15_traces(jax_traces, port_traces):
    assert sorted(port_traces[0]["traces"]) == sorted(KEYS) == \
        sorted(jax_traces["traces"])


@pytest.mark.parametrize("key", KEYS)
def test_golden_trace_matches_live_jax(jax_traces, port_traces, key):
    got = {"traces": {key: port_traces[0]["traces"][key]}}
    want = {"traces": {key: jax_traces["traces"][key]}}
    assert harness.compare_traces(got, want) == []


@pytest.mark.parametrize("scheme", SCHEMES)
def test_the_three_paths_realize_the_same_masks(port_traces, scheme):
    masks = port_traces[1]
    for path in harness.PATHS[1:]:
        np.testing.assert_array_equal(masks[scheme, path],
                                      masks[scheme, harness.PATHS[0]])
