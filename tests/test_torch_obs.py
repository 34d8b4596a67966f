"""The port's observability layer (repro_torch.obs) on the CPU, against the
JAX package's (repro.obs) — the counterparts of tests/test_obs.py.

* Disabled taps (``None`` and ``MetricsSpec.none()``) leave a run bit-equal
  and dispatch the same operations, counted by a ``TorchDispatchMode``
  (the eager counterpart of JAX's pinned jaxpr); a tapped run is the
  untapped run bit for bit on every path.
* The port's taps equal JAX's on the dense, legacy and sparse paths:
  integers exact, floats within rtol 1e-5, atol 1e-6, as JAX's own
  ``assert_metrics_agree`` holds its three paths to each other.
* Partial specs, guard events, the scheme- and fault-matrix taps, the
  resumed tapped run, the manifests through ``runs.jsonl``, the report's
  ``--validate``/``--summary``/``--diff``, ``timed_compile``,
  ``maybe_profile`` and ``memory_snapshot``.

The world is tests/test_obs.py's: tests/test_engine_parity.py's
``tiny_world`` (K 5, T 8, 32 features, a 32-24-10 MLP), built by JAX and
converted through numpy.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import dataclasses
import json
import os
from collections import Counter

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.core.selection as jsel
from repro.fl import FaultConfig as JFaults
from repro.fl import GuardConfig as JGuards
from repro.fl import SimConfig as JSimConfig
from repro.fl import make_sparse_runner as j_make_sparse_runner
from repro.fl import run_simulation as j_run_simulation
from repro.fl import run_simulation_legacy as j_run_simulation_legacy
from repro.models.small import mlp_accuracy as j_mlp_accuracy
from repro.models.small import mlp_loss as j_mlp_loss
from repro.obs import MetricsSpec as JSpec
from repro.obs import metrics_summary as j_metrics_summary
import repro_torch.core.selection as tsel
from repro_torch.convert import params_from_jax
from repro_torch.core import CellConfig
from repro_torch.data import Dataset, from_client_datasets
from repro_torch.fl import (FaultConfig, GuardConfig, SimConfig, init_carry,
                            make_runner, make_sparse_runner, run_fault_matrix,
                            run_simulation, run_simulation_legacy)
from repro_torch.fl.resume import read_segment_manifest, run_resumable
from repro_torch.fl.schemes import SchemeSpec, run_scheme_matrix
from repro_torch.fl.state import AggregatorConfig
from repro_torch.models.small import mlp_accuracy, mlp_loss
from repro_torch.obs import (MetricsSpec, MetricsState, configure,
                             maybe_profile, metrics_summary, timed_compile,
                             validate_manifest)
from repro_torch.obs import report as obs_report
from repro_torch.obs.telemetry import (MANIFEST_SCHEMA, emit_run_manifest,
                                       get_telemetry)

from test_engine_parity import tiny_world

K, T, DIM = 5, 8, 32
M_RTOL, M_ATOL = 1e-5, 1e-6    # tests/test_obs.py: assert_metrics_agree
CELL = CellConfig(num_clients=K)


def to_torch(ds):
    return Dataset(torch.from_numpy(np.array(ds.x)),
                   torch.from_numpy(np.array(ds.y)), ds.num_classes)


@pytest.fixture(scope="module")
def world():
    clients, te, cell, h, params = tiny_world(K=K, rounds=T, dim=DIM)
    return dict(clients=clients, test=te, cell=cell, h=h, params=params,
                t_clients=[to_torch(c) for c in clients], t_test=to_torch(te),
                t_h=torch.from_numpy(np.array(h)),
                t_params=params_from_jax(
                    jax.tree_util.tree_map(np.asarray, params), device="cpu"))


def cfgs(**kw):
    """tests/test_obs.py's ``_cfg`` in both packages; ``metrics``,
    ``faults`` and ``guards`` as keyword dicts built in each."""
    spec, f, g = (kw.pop(k, None) for k in ("metrics", "faults", "guards"))
    base = dict(rounds=T, local_iters=2, batch_size=4, eval_every=2,
                local_mode="participants", data_path="device",
                data_stream="client")
    base.update(kw)
    return (JSimConfig(metrics=None if spec is None else JSpec(**spec),
                       faults=f and JFaults(**f), guards=g and JGuards(**g),
                       **base),
            SimConfig(metrics=None if spec is None else MetricsSpec(**spec),
                      faults=f and FaultConfig(**f),
                      guards=g and GuardConfig(**g), **base))


def policies(name="csma"):
    if name == "random":
        return jsel.RandomScheme(0.6, K), tsel.RandomScheme(0.6, K)
    return jsel.csma_policy(3, K), tsel.csma_policy(3, K)


def run_port(world, path, cfg, policy=None):
    policy = policy or policies()[1]
    args = (world["t_params"], mlp_loss, mlp_accuracy, world["t_clients"],
            world["t_test"], policy, world["t_h"], CELL, cfg)
    if path == "legacy":
        return run_simulation_legacy(*args, device="cpu")
    if path == "sparse":
        return make_sparse_runner(mlp_loss, mlp_accuracy,
                                  world["t_clients"], world["t_test"], policy,
                                  CELL, cfg, device="cpu")(
            world["t_params"], world["t_h"])
    return run_simulation(*args, device="cpu")


def run_jax(world, path, cfg, policy=None):
    policy = policy or policies()[0]
    args = (world["params"], j_mlp_loss, j_mlp_accuracy, world["clients"],
            world["test"], policy, world["h"], world["cell"], cfg)
    if path == "legacy":
        return j_run_simulation_legacy(*args)
    if path == "sparse":
        return j_make_sparse_runner(j_mlp_loss, j_mlp_accuracy,
                                    world["clients"], world["test"], policy,
                                    world["cell"], cfg)(world["params"],
                                                        world["h"])
    return j_run_simulation(*args)


def assert_metrics_agree(a, b, err=""):
    """tests/test_obs.py's: integer taps bit-exact, float taps within rtol
    1e-5, atol 1e-6; the same fields present."""
    assert a is not None and b is not None
    assert type(a)._fields == type(b)._fields
    for f in type(a)._fields:
        va, vb = getattr(a, f), getattr(b, f)
        if va is None:
            assert vb is None, f"{err}: {f} active on one path only"
            continue
        assert vb is not None, f"{err}: {f} active on one path only"
        va, vb = np.asarray(va), np.asarray(vb)
        assert va.shape == vb.shape, f"{err}: {f}"
        if np.issubdtype(vb.dtype, np.integer):
            assert va.dtype == np.int32 == vb.dtype, f"{err}: {f}"
            np.testing.assert_array_equal(va, vb, err_msg=f"{err}: {f}")
        else:
            assert va.dtype == np.float32, f"{err}: {f}"
            np.testing.assert_allclose(va, vb, rtol=M_RTOL, atol=M_ATOL,
                                       err_msg=f"{err}: {f}")


def assert_bit_equal(a, b):
    """Two runs of the port: the same trajectory, bit for bit."""
    for f in ("participation", "eval_rounds", "test_acc", "test_loss",
              "energy_per_client", "energy_timeline"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert torch.equal(a.state.global_params, b.state.global_params)
    assert torch.equal(a.state.last_tx, b.state.last_tx)


# --- disabled taps: bit parity and the same operations ----------------------


def test_disabled_taps_bit_parity_dense(world):
    off = run_port(world, "dense", cfgs()[1])
    none = run_port(world, "dense", cfgs(metrics=dict(
        participation=False, staleness_hist=False, energy_by_cause=False,
        guard_events=False, weight_stats=False))[1])
    assert off.metrics is None and none.metrics is None
    assert_bit_equal(off, none)


@pytest.mark.parametrize("path", ["dense", "legacy", "sparse"])
def test_tapped_run_does_not_perturb_trajectory(world, path):
    off = run_port(world, path, cfgs()[1])
    on = run_port(world, path, cfgs(metrics={})[1])
    assert_bit_equal(off, on)
    assert off.metrics is None and on.metrics is not None


class OpLog(TorchDispatchMode):
    """Every ATen operation dispatched inside the block, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_disabled_taps_identical_ops_and_carry(world):
    """``MetricsSpec.none()`` runs exactly the operations of
    ``metrics=None``, in the same order, on the same carry structure; a
    tapped run dispatches more (the eager counterpart of JAX's pinned
    jaxpr)."""
    logs = []
    for spec in (None, dict(participation=False, staleness_hist=False,
                            energy_by_cause=False, guard_events=False,
                            weight_stats=False), {}):
        cfg = cfgs(metrics=spec)[1]
        carry = init_carry(world["t_params"], K, cfg, "cpu")
        runner = make_runner(mlp_loss, mlp_accuracy, world["t_clients"],
                             world["t_test"], policies()[1], CELL, cfg,
                             device="cpu")
        with OpLog() as log:
            runner(world["t_params"], world["t_h"])
        logs.append((len(carry), log.ops))
    (n_off, off), (n_none, none), (n_on, on) = logs
    assert n_off == n_none == 2 and n_on == 3
    assert off == none
    assert len(on) > len(off)
    extra = Counter(on) - Counter(off)
    assert "aten.scatter_add.default" in extra


# --- enabled taps: the port against JAX on three paths ----------------------


@pytest.fixture(scope="module")
def tapped(world):
    """JAX's dense, legacy and sparse runs with every tap on."""
    jcfg, _ = cfgs(metrics={})
    return {p: run_jax(world, p, jcfg) for p in ("dense", "legacy",
                                                 "sparse")}


@pytest.mark.parametrize("path", ["dense", "legacy", "sparse"])
def test_taps_match_jax(world, tapped, path):
    got = run_port(world, path, cfgs(metrics={})[1])
    want = tapped[path]
    np.testing.assert_array_equal(got.participation, want.participation)
    assert_metrics_agree(got.metrics, want.metrics, f"port-jax {path}")
    assert_metrics_agree(got.metrics, tapped["dense"].metrics,
                         f"port {path}-jax dense")
    assert metrics_summary(got.metrics).keys() == \
        j_metrics_summary(want.metrics).keys()


def test_taps_agree_across_all_three_paths(world):
    cfg = cfgs(metrics={})[1]
    dense, legacy, sp = (run_port(world, p, cfg)
                         for p in ("dense", "legacy", "sparse"))
    assert_metrics_agree(dense.metrics, legacy.metrics, "dense-legacy")
    assert_metrics_agree(dense.metrics, sp.metrics, "dense-sparse")
    ms = dense.metrics
    np.testing.assert_array_equal(ms.tx_count,
                                  dense.participation.sum(axis=0))
    assert int(ms.rounds) == T and int(ms.agg_rounds) == T
    assert int(ms.stale_hist.sum()) == int(dense.participation.sum())
    summ = metrics_summary(ms)
    assert summ["tx_total"] == int(dense.participation.sum())
    assert summ["rounds"] == T


def test_partial_spec_subsets_run(world):
    spec = dict(participation=True, staleness_hist=False,
                energy_by_cause=False, guard_events=False,
                weight_stats=False)
    jcfg, cfg = cfgs(metrics=spec)
    res = run_port(world, "dense", cfg)
    ms = res.metrics
    assert ms.tx_count is not None and ms.stale_hist is None
    assert ms.energy_cause is None and ms.weight_entropy is None
    assert ms.agg_rounds is None
    np.testing.assert_array_equal(ms.tx_count, res.participation.sum(axis=0))
    assert_metrics_agree(ms, run_jax(world, "dense", jcfg).metrics,
                         "partial")


@pytest.mark.parametrize("path", ["dense", "legacy"])
def test_guard_event_taps_count_quarantines(world, path):
    jcfg, cfg = cfgs(metrics={}, faults=dict(p_corrupt=0.5,
                                             corrupt_mode="nan"),
                     guards=dict(quarantine=True, clip_norm=10.0),
                     participation="dense")
    jpol, tpol = policies("random")
    got = run_port(world, path, cfg, tpol)
    ge = got.metrics.guard_events
    assert ge.shape == (3,) and ge[0] >= 1
    assert_metrics_agree(got.metrics, run_jax(world, path, jcfg,
                                              jpol).metrics, "guards")


# --- the matrices -----------------------------------------------------------


@pytest.fixture(scope="module")
def matrix_world(world):
    """tests/test_scheme_parity.py's ``_matrix_world`` (severities d = 2 and
    4 padded to 256, two channel lanes) in the port, from JAX's data."""
    import jax.numpy as jnp
    from repro.core.channel import channel_gains, sample_positions
    from repro.data import Dataset as JDataset
    from repro.data import make_mnist_like, shard_noniid

    tr, _ = make_mnist_like(jax.random.PRNGKey(0), n_train=800, n_test=200)
    stores = []
    for d in (2, 4):
        cs = shard_noniid(jax.random.PRNGKey(1), tr, K, d=d)
        stores.append(from_client_datasets(
            [to_torch(JDataset(c.x[:, :DIM], c.y, c.num_classes))
             for c in cs], device="cpu", pad_to=256))
    pos = sample_positions(jax.random.PRNGKey(2), world["cell"])
    h = jnp.stack([channel_gains(jax.random.PRNGKey(30 + s), pos, T).T
                   for s in range(2)])
    return stores, torch.from_numpy(np.array(h))


def panel():
    """tests/test_scheme_parity.py's ``_panel``."""
    return [SchemeSpec("paper", tsel.random_policy(0.4, K),
                       AggregatorConfig(kind="paper")),
            SchemeSpec("fedasync", tsel.random_policy(0.4, K),
                       AggregatorConfig(kind="fedasync",
                                        staleness_fn="poly")),
            SchemeSpec("csmaafl", tsel.csma_policy(3, K),
                       AggregatorConfig(kind="csmaafl")),
            SchemeSpec("age-aware", tsel.age_aware_policy(2, K),
                       AggregatorConfig(kind="age"))]


def test_scheme_matrix_taps_dense_sparse_agree(world, matrix_world):
    stores, h = matrix_world
    seeds = [0, 1]

    def run(cfg, path):
        return run_scheme_matrix(world["t_params"], mlp_loss, mlp_accuracy,
                                 stores, world["t_test"], panel(), h, CELL,
                                 cfg, seeds, participation=path,
                                 device="cpu")

    cfg = cfgs(metrics={})[1]
    dense, sparse = run(cfg, "dense"), run(cfg, "sparse")
    assert isinstance(dense.metrics, MetricsState)
    assert dense.metrics.tx_count.shape == (2, 4, 2, K)
    assert_metrics_agree(dense.metrics, sparse.metrics, "matrix")
    np.testing.assert_array_equal(dense.metrics.tx_count,
                                  dense.participation.sum(axis=3))
    untapped = run(cfgs()[1], "dense")
    assert untapped.metrics is None
    np.testing.assert_array_equal(untapped.participation,
                                  dense.participation)


def test_fault_matrix_taps_per_guard_setting(world):
    cfg = SimConfig(rounds=T, local_iters=1, batch_size=8, eval_every=4,
                    eval_batch=200, data_path="device",
                    faults=FaultConfig(p_loss=0.3, max_retries=1,
                                       p_corrupt=0.3, corrupt_mode="nan"),
                    metrics=MetricsSpec())
    res = run_fault_matrix(world["t_params"], mlp_loss, mlp_accuracy,
                           world["t_clients"], world["t_test"],
                           tsel.RandomScheme(0.6, K), world["t_h"], CELL,
                           cfg, rates=[0.0, 1.0], device="cpu")
    assert set(res.metrics) == {"guarded", "unguarded"}
    for name, ms in res.metrics.items():
        assert ms.tx_count.shape == (2, K)
        # the rate-0 lane is the clean world: every decision delivers
        np.testing.assert_array_equal(ms.tx_count[0],
                                      res.delivered[name][0].sum(axis=0))
    assert res.metrics["unguarded"].guard_events is None
    assert res.metrics["guarded"].guard_events is not None


# --- telemetry: manifests, spans, timed_compile, profile, memory -----------


def test_manifest_emit_validate_jsonl_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_OBS_DIR", str(tmp_path))
    m = emit_run_manifest("test_kind", cfgs()[1], extra={"x": 1})
    assert validate_manifest(m) == []
    assert set(m) == set(MANIFEST_SCHEMA)
    assert {"torch", "cuda"} <= set(m["fingerprint"])
    path = os.path.join(str(tmp_path), "runs.jsonl")
    with open(path) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    assert lines[-1]["kind"] == "test_kind"
    assert lines[-1]["extra"] == {"x": 1}
    assert validate_manifest(lines[-1]) == []
    assert obs_report.main(["--validate", path]) == 0
    assert obs_report.main(["--summary", path]) == 0
    # schema violations are caught, a JAX fingerprint among them
    assert validate_manifest({"kind": 1}) != []
    jax_fp = dict(m, fingerprint={k: v for k, v in m["fingerprint"].items()
                                  if k not in ("torch", "cuda")})
    assert validate_manifest(jax_fp) == ["fingerprint missing 'torch'",
                                         "fingerprint missing 'cuda'"]
    with open(path, "a") as f:
        f.write(json.dumps({"kind": "broken"}) + "\n")
    assert obs_report.main(["--validate", path]) == 1


def test_runners_emit_manifests(world):
    tel = get_telemetry()
    before = len(tel.manifests)
    run_port(world, "dense", cfgs()[1])
    run_port(world, "sparse", cfgs()[1])
    kinds = [m["kind"] for m in tel.manifests[before:]]
    assert "make_runner" in kinds and "make_sparse_runner" in kinds
    for m in tel.manifests[before:]:
        assert validate_manifest(m) == []
    assert tel.span_stats("engine.execute")["count"] >= 1


def test_timed_compile_records_its_span():
    tel = get_telemetry()
    fn = timed_compile(lambda x: (x * 2.0).sum(), torch.ones(8, 8),
                       label="obs_test")
    assert float(fn(torch.ones(8, 8))) == 128.0
    assert tel.span_stats("obs_test.compile")["count"] >= 1
    # eager: there is no trace or lowering stage to time
    assert tel.span_stats("obs_test.lower") is None
    assert tel.span_stats("obs_test.trace") is None


def test_maybe_profile_writes_a_trace_only_when_asked(tmp_path,
                                                      monkeypatch):
    monkeypatch.delenv("REPRO_PROFILE_DIR", raising=False)
    with maybe_profile() as d:
        assert d is None
    with maybe_profile(str(tmp_path / "p")) as d:
        torch.ones(4).sum()
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(d, files[0])) as f:
        assert "traceEvents" in json.load(f)
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path / "q"))
    with maybe_profile() as d:
        torch.ones(4).sum()
    assert d == str(tmp_path / "q") and len(os.listdir(d)) == 1


def test_configure_overrides_the_environment(tmp_path, monkeypatch):
    import repro_torch.obs.telemetry as tm
    monkeypatch.setattr(tm, "_OBS_DIR", None)
    monkeypatch.setenv("REPRO_OBS_DIR", str(tmp_path / "env"))
    configure(obs_dir=str(tmp_path / "cfg"))
    emit_run_manifest("configured")
    assert os.path.exists(tmp_path / "cfg" / "runs.jsonl")
    assert not os.path.exists(tmp_path / "env")


def test_memory_snapshot_and_snapshot_on_the_cpu():
    tel = get_telemetry()
    if torch.cuda.is_available():
        pytest.skip("the CPU form; tests/test_torch_cuda.py holds the card's")
    assert tel.memory_snapshot() == [{"device": "cpu", "bytes_in_use": None,
                                      "peak_bytes_in_use": None}]
    tel.inc("obs_test.counter", 2)
    snap = tel.snapshot()
    assert snap["counters"]["obs_test.counter"] >= 2
    assert set(snap["spans"]) == set(tel.spans)


# --- reporter: diff gate ----------------------------------------------------


def _write_json(path, payload):
    with open(path, "w") as f:
        json.dump(payload, f)
    return str(path)


def test_report_diff_gates_on_time_regressions(tmp_path):
    old = _write_json(tmp_path / "old.json",
                      {"dense": {"warm_s": 1.0, "count": 5},
                       "fingerprint": {"git_sha": "aaa"}})
    slow = _write_json(tmp_path / "slow.json",
                       {"dense": {"warm_s": 3.0, "count": 500},
                        "fingerprint": {"git_sha": "bbb"}})
    ok = _write_json(tmp_path / "ok.json",
                     {"dense": {"warm_s": 1.05, "count": 500},
                      "fingerprint": {"git_sha": "ccc"}})
    assert obs_report.main(["--diff", old, slow, "--threshold", "2.0"]) == 1
    assert obs_report.main(["--diff", old, ok, "--threshold", "2.0"]) == 0
    assert obs_report.main(["--diff", old, slow, "--threshold", "4.0"]) == 0
    with open(old) as fo, open(slow) as fs:
        d = obs_report.diff_benches(json.load(fo), json.load(fs), 2.0)
    gated = {r["key"]: r["gated"] for r in d["rows"]}
    assert gated == {"dense.warm_s": True, "dense.count": False}
    assert [r["key"] for r in d["regressions"]] == ["dense.warm_s"]


# --- resumable runs: the taps through the checkpoints -----------------------


def test_resume_segment_manifest_roundtrip(world, tmp_path):
    cfg = dataclasses.replace(cfgs(metrics={})[1], checkpoint_every=3)
    pol = policies()[1]
    ckpt = str(tmp_path / "ckpt")

    def resumable(**kw):
        return run_resumable(world["t_params"], mlp_loss, mlp_accuracy,
                             world["t_clients"], world["t_test"], pol,
                             world["t_h"], CELL, cfg, ckpt, device="cpu",
                             **kw)

    assert resumable(stop_after_segment=1) is None       # a kill
    assert len(read_segment_manifest(ckpt)) == 1
    res = resumable()
    entries = read_segment_manifest(ckpt)
    assert [e["segment"] for e in entries] == list(range((T + 2) // 3))
    for e in entries:
        assert e["seed"] == cfg.seed and e["stride"] == 3
        assert e["t1"] > e["t0"] and e["wall_s"] > 0.0
        assert "backend" in e["fingerprint"]
    # the taps ride through the checkpoints: the resumed run's equal an
    # uninterrupted dense run's bit for bit
    dense = run_port(world, "dense", cfg, pol)
    for f in MetricsState._fields:
        a, b = getattr(res.metrics, f), getattr(dense.metrics, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
