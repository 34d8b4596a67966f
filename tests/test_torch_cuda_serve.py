"""The port's serve front door and CNN on an NVIDIA card.

* Racing submitter threads against a started server on the card, each
  training real deltas on its own clients' streams: every admitted ticket
  resolves and the session replays (``verify_replay``: ledgers bit for
  bit, the model within rtol 1e-4, atol 1e-5); then the load generator's
  threaded session on the card, replaying too.
* ``pull()`` views stay what they were after a flush in each of K1's
  modes (subset, weighted under guards, weighted under a scheme), and the
  flush launched K1 once in that mode.
* A flush returns after the device finished its aggregation: the stream is
  idle when ``flush`` returns, so admission latency covers the device.
* ``cnn_logits`` on the card is the same bits with the global cuDNN TF32
  flag on and off (its per-client gradients within 1e-5), and both agree
  with the CPU within rtol 1e-4, atol 1e-5, which TF32 would miss.

Every test here is marked ``cuda`` and skips where there is no card.  This
file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_serve.py
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import threading

import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.fl import AggregatorConfig, GuardConfig
from repro_torch.fl.state import ParamLayout
from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda
from repro_torch.models.small import cnn_logits, cnn_loss, init_cnn
from repro_torch.serve import (AggregationServer, LoadGenConfig, ServeConfig,
                               make_client_step, run_loadgen, toy_world,
                               verify_replay)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def test_racing_submitters_on_the_card_replay(card):
    K, per_thread, n_threads = 32, 12, 4
    params, store, loss_fn, acc_fn = toy_world(K, dim=8, classes=4, n_per=6,
                                               device=card)
    cfg = ServeConfig(num_clients=K, queue_capacity=8, max_batch=8,
                      min_bucket=2, flush_interval_s=0.001, local_iters=2,
                      batch_size=3, lr=0.05)
    server = AggregationServer(params, cfg, start=True, device=card)
    step = make_client_step(store, loss_fn, 2, 3, cfg.seed, lr=0.05,
                            layout=server.layout)
    admitted, rejected = [], []
    lock = threading.Lock()

    def submitter(w):          # clients w, w + n_threads, ... are its own
        rng = np.random.default_rng(w)
        seqs = {}
        done = 0
        while done < per_thread:
            k = w + n_threads * int(rng.integers(K // n_threads))
            version, g = server.pull_row()
            seq = seqs.get(k, 0)
            delta = step(g, k, seq)
            tk = server.submit(k, delta, version, seq=seq, energy_j=0.1)
            with lock:
                (admitted if tk.admitted else rejected).append(tk)
            if tk.admitted:
                seqs[k] = seq + 1
                done += 1

    threads = [threading.Thread(target=submitter, args=(w,))
               for w in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    server.close(drain=True)
    assert all(tk.wait(timeout=10) is not None for tk in admitted)
    assert len(admitted) == n_threads * per_thread
    assert int(server.ledger_snapshot()["tx_count"].sum()) == len(admitted)
    rep = verify_replay(server, store, params, loss_fn, acc_fn)
    assert rep["ok"] and rep["n_uploads"] == len(admitted)

    server = AggregationServer(params, cfg, start=True, device=card)
    report = run_loadgen(server, store, loss_fn, LoadGenConfig(
        uploads=64, workers=4, respect_probs=False, timeout_s=60.0))
    server.close(drain=True)
    assert report["uploads_unresolved"] == 0
    assert verify_replay(server, store, params, loss_fn, acc_fn)["ok"]


@pytest.mark.parametrize("mode", ["subset", "guarded", "scheme"])
def test_pulled_views_survive_a_flush_on_the_card(card, mode):
    kw = {"subset": {},
          "guarded": {"guards": GuardConfig(quarantine=True, clip_norm=5.0)},
          "scheme": {"aggregator": AggregatorConfig(kind="fedasync")}}[mode]
    params, store, loss_fn, acc_fn = toy_world(8, device=card)
    server = AggregationServer(params, ServeConfig(num_clients=8,
                                                   min_bucket=2, **kw),
                               start=False, device=card)
    v0, views = server.pull()
    before = [t.clone() for layer in views for t in layer.values()]
    counts = (fl_aggregate_cuda.launches, fl_aggregate_cuda.subset_launches,
              fl_aggregate_cuda.guarded_launches)
    server.submit(0, torch.full((server.layout.width,), 0.5, device=card),
                  v0)
    assert server.flush() == 1
    after = (fl_aggregate_cuda.launches, fl_aggregate_cuda.subset_launches,
             fl_aggregate_cuda.guarded_launches)
    want = {"subset": (1, 1, 0), "guarded": (1, 0, 1),
            "scheme": (1, 0, 1)}[mode]
    assert tuple(a - b for a, b in zip(after, counts)) == want
    for a, b in zip(before, [t for layer in views for t in layer.values()]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(server.global_row().abs().sum()) > 0.0
    server.close()


def test_flush_returns_after_the_device_finished(card):
    """A wide model (W ~ 4M) and a full bucket: when ``flush`` returns, the
    stream has nothing left to run."""
    params = [{"b": torch.zeros(10, device=card),
               "w": torch.zeros((400_000, 10), device=card)}]
    server = AggregationServer(params, ServeConfig(num_clients=64,
                                                   min_bucket=64),
                               start=False, device=card)
    W = server.layout.width
    for k in range(64):
        server.submit(k, torch.randn(W, device=card), 0)
    stream = torch.cuda.current_stream(card)
    assert server.flush() == 64
    assert stream.query()
    assert server.stats()["admit_ms"]["p50"] > 0.0
    server.close()


def test_cnn_on_the_card_ignores_the_tf32_flag(card):
    R, B = 3, 4
    params = init_cnn(jr.PRNGKey(4), device="cpu")
    layout = ParamLayout.of(params)
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((R, B, 32, 32, 3), generator=gen) * 2 - 1
    y = torch.randint(0, 10, (R, B), generator=gen)
    flat = torch.stack([layout.flatten(params) * (1 + 0.05 * r)
                        for r in range(R)])

    def run(device):
        f = flat.to(device).requires_grad_(True)
        p = layout.unflatten(f)
        logits = cnn_logits(p, x.to(device))
        (g,) = torch.autograd.grad(cnn_loss(p, x.to(device),
                                            y.to(device)).sum(), f)
        return logits.detach().cpu(), g.cpu()

    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        on = run(card)
        assert torch.backends.cudnn.allow_tf32 is True
        torch.backends.cudnn.allow_tf32 = False
        off = run(card)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    torch.testing.assert_close(on[0], off[0], rtol=0, atol=0)
    # cuDNN's weight gradients may sum in a run-dependent order; TF32 would
    # be off by ~1e-3
    torch.testing.assert_close(on[1], off[1], rtol=1e-5, atol=1e-6)
    for a, b in zip(on, run("cpu")):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
