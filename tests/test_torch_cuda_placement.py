"""The dense engine's client axis placed over cards (JAX's
``shard_clients``) on NVIDIA cards: 4 virtual blocks of ``cuda:0``
against the unplaced run, and, where two or more cards are visible,
``make_runner``'s default over them.

Masks, deliveries, ``last_tx``, eval rounds, energies and integer taps
bit for bit; the global, client and anchor rows, accuracy, loss and float
taps at rtol 1e-4, atol 1e-5, NaN in the same places; eq. 3 = one K1
launch a block and round (subset mode, or weighted with guards and
schemes), counted by the kernel's wrapper; the rows on their blocks'
cards for the whole run, 2·(K/d)·W·4 bytes of them on each card.

Every test here is marked ``cuda`` and skips where there is no card.  This
file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m cuda \\
        tests/test_torch_cuda_placement.py
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import contextlib

import numpy as np
import pytest
import torch

import repro_torch.fl.engine as E
from repro_torch import random as jr
from repro_torch.core import CellConfig
from repro_torch.core.channel import channel_gains, sample_positions
from repro_torch.core.selection import AgeAwareScheme, RandomScheme
from repro_torch.data import make_mnist_like, shard_noniid
from repro_torch.fl import (AggregatorConfig, ClientPlacement, FaultConfig,
                            GuardConfig, RowBlocks, SimConfig, make_runner)
from repro_torch.models.small import init_mlp, mlp_accuracy, mlp_loss
from repro_torch.obs.taps import MetricsSpec

pytestmark = pytest.mark.cuda

K, T, BLOCKS = 16, 4, 4
RTOL, ATOL = 1e-4, 1e-5        # tests/golden/harness.py
BASE = dict(rounds=T, local_iters=2, batch_size=8, eval_every=2,
            eval_batch=500, data_path="device")
CASES = {
    "device": ("random", {}),
    "prestack": ("random", dict(data_path="prestack")),
    "participants": ("random", dict(local_mode="participants")),
    "age_guarded": ("age", dict(aggregator=AggregatorConfig(kind="age"),
                                guards=GuardConfig(quarantine=True))),
    "faults_nan": ("random", dict(faults=FaultConfig(
        p_fail=0.2, p_recover=0.5, p_crash=0.1, p_loss=0.3, max_retries=1,
        p_corrupt=0.3, corrupt_mode="nan"))),
    "taps": ("random", dict(metrics=MetricsSpec(), guards=GuardConfig(
        quarantine=True, clip_norm=0.5, staleness_power=0.5))),
}


@contextlib.contextmanager
def placed(devices):
    rule = E._client_mesh
    E._client_mesh = lambda k, device=None: ClientPlacement(tuple(devices), k)
    try:
        yield
    finally:
        E._client_mesh = rule


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    tr, te = make_mnist_like(jr.PRNGKey(0), n_train=2000, n_test=500,
                             device="cpu")
    clients = shard_noniid(jr.PRNGKey(1), tr, K, d=5)
    cell = CellConfig(num_clients=K)
    h = channel_gains(jr.PRNGKey(3), sample_positions(
        jr.PRNGKey(2), cell, device="cpu"), T).T
    return dict(clients=clients, test=te, cell=cell, h=h,
                params=init_mlp(jr.PRNGKey(4), device="cpu"))


def k1():
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda
    return fl_aggregate_cuda


def run(w, case, shard_clients=False):
    """The case's run on the card and K1's launches in it (all, subset,
    weighted)."""
    pol, extra = CASES[case]
    policy = AgeAwareScheme(4, K) if pol == "age" else RandomScheme(0.5, K)
    kernel = k1()
    kernel.launches = kernel.subset_launches = kernel.guarded_launches = 0
    res = make_runner(mlp_loss, mlp_accuracy, w["clients"], w["test"],
                      policy, w["cell"], SimConfig(**{**BASE, **extra}),
                      device="cuda", shard_clients=shard_clients)(
        w["params"], w["h"])
    torch.cuda.synchronize()
    return res, (kernel.launches, kernel.subset_launches,
                 kernel.guarded_launches)


def held(got, want):
    for name in ("participation", "eval_rounds", "energy_per_client",
                 "energy_timeline", "delivered", "corrupted"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    np.testing.assert_array_equal(got.state.last_tx.cpu().numpy(),
                                  want.state.last_tx.cpu().numpy())
    st = got.state.gathered()
    pairs = [(got.test_acc, want.test_acc), (got.test_loss, want.test_loss)]
    pairs += [(getattr(st, f).cpu().numpy(),
               getattr(want.state, f).cpu().numpy())
              for f in ("global_params", "client_params", "anchor_params")]
    if want.metrics is not None:
        for name, a in want.metrics._asdict().items():
            if a is None:
                continue
            b = getattr(got.metrics, name)
            if np.issubdtype(np.asarray(a).dtype, np.integer) \
                    or name == "energy_cause":
                np.testing.assert_array_equal(b, a, err_msg=name)
            else:
                pairs.append((b, a))
    for a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   equal_nan=True)


def expected(case, d):
    weighted = "guards" in CASES[case][1] or "aggregator" in CASES[case][1]
    return (d * T, 0, d * T) if weighted else (d * T, d * T, 0)


@pytest.mark.parametrize("case", list(CASES))
def test_virtual_blocks_equal_unplaced(world, case):
    want, n = run(world, case)
    assert n[0] == T
    with placed([torch.device("cuda", 0)] * BLOCKS):
        got, m = run(world, case, shard_clients=None)
    assert m == expected(case, BLOCKS)
    rows = got.state.client_params
    assert isinstance(rows, RowBlocks) and len(rows) == BLOCKS
    held(got, want)


@pytest.fixture(scope="module")
def cards(world):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"{n} card visible: the default placement needs two or "
                    "more")
    return n


@pytest.mark.parametrize("case", ["device", "prestack", "age_guarded"])
def test_default_placement_over_the_cards(world, cards, case):
    """``make_runner``'s default places K 16 over JAX's d of the visible
    cards; each card holds its blocks' rows, 2·(K/d)·W·4 bytes of them."""
    place = E._client_mesh(K, "cuda")
    d = len(place.devices)
    assert d == max(i for i in range(1, min(cards, K) + 1) if K % i == 0)
    want, _ = run(world, case)
    got, m = run(world, case, shard_clients=None)
    assert m == expected(case, d)
    assert all([b.device for b in rows] == list(place.devices)
               for rows in (got.state.client_params,
                            got.state.anchor_params))
    held(got, want)
    devices = list(place.devices)
    before = [torch.cuda.memory_allocated(x) for x in devices]
    row_bytes = 2 * (K // d) * got.state.layout.width * 4
    del got
    after = [torch.cuda.memory_allocated(x) for x in devices]
    for b, a in zip(before[1:], after[1:]):
        # each block's allocation rounds up, within a 2 MiB segment
        assert row_bytes <= b - a <= row_bytes + 2 * (2 << 20), \
            (b - a, row_bytes)
