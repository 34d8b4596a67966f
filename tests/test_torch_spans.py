"""The engines' phase spans (``repro_torch.obs.telemetry``) on the CPU.

* A dense run records ``round.data``, ``round.decision``,
  ``round.local_sgd`` and ``round.server`` T times each under
  ``engine.execute``, unplaced and placed over ``("cpu",) * 4``; the stream
  runner, the resumable runner (under ``resume.segment``) and the seed
  matrix record them too.
* A sparse run records ``sparse.gather`` and ``sparse.phase_b`` inside
  ``sparse.train``, and ``sparse.densify`` after it, a root of its own.
* Under a CPU ``torch.profiler`` every span is a host range among the
  profiler's events, properly nested, inside its parent's range.
* With no card no ``<name>.device`` entry is made.
* A run with a profiler recording equals a run without one, bit for bit:
  masks, ``last_tx``, the energy ledger and the global row.
* The telemetry's own span tree: the parent at the first record, threads
  apart.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import threading

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import repro_torch.fl.engine as E
from repro_torch import random as jr
from repro_torch.core import CellConfig
from repro_torch.core.selection import RandomScheme
from repro_torch.data import Dataset
from repro_torch.fl import (ClientPlacement, SimConfig, make_runner,
                            run_seed_matrix)
from repro_torch.fl.resume import run_resumable
from repro_torch.models.small import init_mlp, mlp_accuracy, mlp_loss
from repro_torch.obs import telemetry

K, T, DIM = 8, 4, 12
CPU = torch.device("cpu")
ROUND = ("round.data", "round.decision", "round.local_sgd", "round.server")
SPARSE = ("sparse.phase_a", "sparse.train", "sparse.gather",
          "sparse.phase_b", "sparse.densify")
BASE = dict(rounds=T, local_iters=2, batch_size=4, eval_every=2,
            eval_batch=32, data_path="device")
SPARSE_KW = dict(participation="sparse", local_mode="participants",
                 data_stream="client", participant_bucket=K)


@pytest.fixture(scope="module")
def world():
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(K, 6, DIM, generator=gen)
    y = (torch.arange(6, dtype=torch.int32) % 10).expand(K, 6).contiguous()
    clients = [Dataset(x[k], y[k], 10) for k in range(K)]
    test = Dataset(x[:, 0], y[:, 0].contiguous(), 10)
    h = torch.rand(K, T, generator=gen) * 9.9e-13 + 1e-14
    return dict(clients=clients, test=test, h=h,
                params=init_mlp(jr.PRNGKey(4), dims=(DIM, 8, 10),
                                device="cpu"))


@pytest.fixture
def tel(monkeypatch):
    """A fresh process sink for the test: the runners built in it record
    there."""
    sink = telemetry.Telemetry()
    monkeypatch.setattr(telemetry, "_TELEMETRY", sink)
    return sink


def runner(world, **kw):
    return make_runner(mlp_loss, mlp_accuracy, world["clients"],
                       world["test"], RandomScheme(0.5, K),
                       CellConfig(num_clients=K),
                       SimConfig(**dict(BASE, **kw)), device="cpu")


def assert_round_spans(tel, parent, runs=1):
    for name in ROUND:
        count, total, longest, up = tel.spans[name]
        assert (count, up) == (runs * T, parent), name
        assert 0.0 < longest <= total


@pytest.mark.parametrize("blocks", [1, 4])
def test_dense_run_records_each_round_phase(world, tel, monkeypatch,
                                            blocks):
    if blocks > 1:
        monkeypatch.setattr(E, "_client_mesh", lambda k, device=None:
                            ClientPlacement((CPU,) * blocks, k))
    runner(world)(world["params"], world["h"])
    assert_round_spans(tel, "engine.execute")
    count, total, _, up = tel.spans["engine.execute"]
    assert (count, up) == (1, None)
    # the children lie inside the root: their sum is at most its time
    assert sum(tel.spans[n][1] for n in ROUND) <= total
    assert tel.snapshot()["spans"]["round.server"]["parent"] == \
        "engine.execute"


@pytest.mark.parametrize("engine", ["stream", "resumable", "seed_matrix"])
def test_every_engine_of_the_round_records_its_phases(world, tel, engine,
                                                      tmp_path):
    if engine == "stream":
        runner(world, data_path="stream", stream_chunk=3)(world["params"],
                                                          world["h"])
        assert_round_spans(tel, "engine.execute")
    elif engine == "resumable":
        run_resumable(world["params"], mlp_loss, mlp_accuracy,
                      world["clients"], world["test"], RandomScheme(0.5, K),
                      world["h"], CellConfig(num_clients=K),
                      SimConfig(**dict(BASE, checkpoint_every=2)),
                      str(tmp_path), device="cpu")
        assert_round_spans(tel, "resume.segment")
        assert tel.spans["resume.segment"][0] == 2
    else:
        run_seed_matrix(world["params"], mlp_loss, mlp_accuracy,
                        world["clients"], world["test"],
                        RandomScheme(0.5, K), torch.stack([world["h"]] * 2),
                        CellConfig(num_clients=K), SimConfig(**BASE),
                        seeds=[1, 2], device="cpu")
        assert_round_spans(tel, "engine.execute", runs=2)
        assert not any(n.endswith("matrix.execute") for n in tel.spans)


def test_sparse_run_records_its_phases(world, tel):
    runner(world, **SPARSE_KW)(world["params"], world["h"])
    parents = {n: tel.spans[n][3] for n in SPARSE}
    assert parents == {"sparse.phase_a": None, "sparse.train": None,
                       "sparse.gather": "sparse.train",
                       "sparse.phase_b": "sparse.train",
                       "sparse.densify": None}
    assert all(tel.spans[n][0] == 1 for n in SPARSE)
    assert tel.spans["sparse.gather"][1] + tel.spans["sparse.phase_b"][1] \
        <= tel.spans["sparse.train"][1]
    assert not any(n.startswith("round.") for n in tel.spans)


def host_ranges(prof, names):
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name() in names and e.device_type() == DeviceType.CPU)


@pytest.mark.parametrize("kw", [{}, SPARSE_KW], ids=["dense", "sparse"])
def test_spans_are_nested_host_ranges_under_a_profiler(world, tel, kw):
    run = runner(world, **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(world["params"], world["h"])
    ranges = host_ranges(prof, set(tel.spans))
    assert sorted({n for _, _, n in ranges}) == sorted(tel.spans)
    assert len(ranges) == sum(c[0] for c in tel.spans.values())
    for i, (a0, a1, _) in enumerate(ranges):      # nested or disjoint
        for b0, b1, _ in ranges[i + 1:]:
            assert b1 <= a1 or b0 >= a1
    for b0, b1, name in ranges:                   # inside a parent's range
        up = tel.spans[name][3]
        if up is not None:
            assert any(a0 <= b0 and b1 <= a1
                       for a0, a1, n in ranges if n == up), name
    # no card, so no device timing
    assert not any(n.endswith(".device") for n in tel.spans)


@pytest.mark.parametrize("kw", [{}, SPARSE_KW], ids=["dense", "sparse"])
def test_a_profiled_run_is_the_same_run(world, tel, kw):
    run = runner(world, **kw)
    plain = run(world["params"], world["h"], seed=3)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = run(world["params"], world["h"], seed=3)
    np.testing.assert_array_equal(traced.participation, plain.participation)
    assert torch.equal(traced.state.last_tx, plain.state.last_tx)
    np.testing.assert_array_equal(traced.energy_per_client,
                                  plain.energy_per_client)
    assert torch.equal(traced.state.global_params,
                       plain.state.global_params)


def test_span_tree_keeps_the_first_parent_and_threads_apart(tel):
    with tel.span("a"):
        with tel.span("b"):
            pass
    with tel.span("b"):                # a later root keeps b's first parent
        pass

    def other():
        with tel.span("c"):            # nothing open on this thread
            pass

    with tel.span("a"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert {n: (c[0], c[3]) for n, c in tel.spans.items()} == {
        "a": (2, None), "b": (2, "a"), "c": (1, None)}
    assert tel.span_stats("b")["parent"] == "a"
