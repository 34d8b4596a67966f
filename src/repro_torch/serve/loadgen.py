"""Load generator: thousands of probabilistically transmitting clients
(counterpart of ``repro.serve.loadgen``).

Emulates the paper's client population against a live
:class:`~repro_torch.serve.server.AggregationServer` without one OS thread
per client: a small worker pool draws *which* client acts next from a
heterogeneous activity distribution (lognormal weights — a few chatty
clients, a long quiet tail), pulls the current global row and the served
``p_{k,t}``, gates on the client's own Bernoulli draw (the paper's
autonomous participation), runs the real local-SGD step on the client's
own minibatch stream, and submits the delta.  Every submission keys its
minibatches by the client's private sequence counter — exactly what the
decision log records, so a load-generated session replays through
:func:`repro_torch.serve.replay.replay_session`.

The report measures sustained admitted uploads/s, admission-latency
percentiles and micro-batch occupancy from the server's telemetry.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..data.device import DeviceDataStore, client_round_indices, \
    data_stream_key
from ..fl.state import ParamLayout
from ..obs.telemetry import emit_run_manifest, get_telemetry
from ..optim import Optimizer, sgd


@dataclasses.dataclass(frozen=True)
class LoadGenConfig:
    """``uploads`` is the admitted-upload target (the run also stops at
    ``timeout_s``).  ``rate_sigma`` spreads client activity lognormally
    (0 = uniform).  ``pace_s`` adds exponential think-time per submission
    (0 = max-throughput mode).  ``respect_probs`` gates each upload on the
    served ``p_{k,t}``; switch it off to stress raw ingest throughput."""

    uploads: int = 500
    workers: int = 4
    seed: int = 0
    rate_sigma: float = 1.0
    pace_s: float = 0.0
    respect_probs: bool = True
    timeout_s: float = 120.0
    ticket_wait_s: float = 30.0


def toy_world(num_clients: int, dim: int = 16, classes: int = 10,
              n_per: int = 8, seed: int = 0, device=None):
    """A linear-softmax world for load tests: ``(params, store, loss_fn,
    acc_fn)`` on ``device`` (``None`` means the card).  Clients get
    gaussian clusters per label (the JAX package's numpy draws, so the
    same data bit for bit); the params are one layer ``[{"b", "w"}]`` and
    the loss and accuracy take them stacked over clients too."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, dim)).astype(np.float32)
    y = rng.integers(0, classes, (num_clients, n_per))
    x = centers[y] + 0.5 * rng.normal(
        size=(num_clients, n_per, dim)).astype(np.float32)
    store = DeviceDataStore(
        torch.from_numpy(x).to(device),
        torch.from_numpy(y.astype(np.int32)).to(device),
        torch.full((num_clients,), n_per, dtype=torch.int32, device=device))
    params = [{"b": torch.zeros(classes, dtype=torch.float32, device=device),
               "w": torch.zeros((dim, classes), dtype=torch.float32,
                                device=device)}]

    def logits(p, xb):
        return xb @ p[0]["w"] + p[0]["b"].unsqueeze(-2)

    def loss_fn(p, xb, yb):
        lg = logits(p, xb)
        ll = torch.gather(lg, -1, yb.long().unsqueeze(-1)).squeeze(-1)
        return (torch.logsumexp(lg, dim=-1) - ll).mean(-1)

    def acc_fn(p, xb, yb):
        return (torch.argmax(logits(p, xb), dim=-1) == yb).to(
            torch.float32).mean(-1)

    return params, store, loss_fn, acc_fn


def make_client_step(store: DeviceDataStore, loss_fn: Callable,
                     local_iters: int, batch_size: int, seed: int,
                     opt: Optimizer | None = None, lr: float = 0.01,
                     layout: ParamLayout | None = None):
    """The live client's computation: ``(global, k, seq) -> delta [W]``.
    ``global`` is the server's ``[W]`` row (then ``layout`` is needed) or
    a param tree.  Minibatches come from ``fold_in(fold_in(data_key,
    seq), k)`` — the client's own stream, reproducible from ``(seed, k,
    seq)`` alone — and local SGD is the engine's own
    :func:`~repro_torch.fl.engine.make_local_train` on a width-1 lane
    (what replay's phase B runs over a bucket)."""
    from ..fl.engine import make_local_train

    data_key = data_stream_key(seed, device=store.x.device)
    train = make_local_train(loss_fn, opt or sgd(lr))
    K = store.num_clients

    @torch.no_grad()
    def step(g, k: int, seq: int) -> torch.Tensor:
        lay = layout
        if not isinstance(g, torch.Tensor):
            lay = ParamLayout.of(g)
            g = lay.flatten(g)
        if lay is None:
            raise ValueError("a [W] row needs the layout: "
                             "make_client_step(..., layout=...)")
        kc = min(max(int(k), 0), K - 1)
        bidx = client_round_indices(data_key, seq, k, store.lengths[kc],
                                    local_iters, batch_size).long()
        xb, yb = store.x[kc][bidx], store.y[kc][bidx]
        g1 = g[None]
        return (train(g1, xb[None], yb[None], lay) - g1)[0]

    return step


def run_loadgen(server, store: DeviceDataStore, loss_fn: Callable,
                lg: LoadGenConfig, opt: Optimizer | None = None) -> dict:
    """Drive a burst against a running server; returns the measured report.

    The server must have its batcher thread running (``start=True``) —
    tickets resolve asynchronously while workers keep submitting.  Each
    worker waits for its delta on the device before submitting it, as a
    client finishes training before it uploads.
    """
    if server._batcher is None:
        raise ValueError("run_loadgen needs a running batcher "
                         "(AggregationServer(start=True))")
    cfg = server.cfg
    K = cfg.num_clients
    if store.num_clients != K:
        raise ValueError(f"store has {store.num_clients} clients, "
                         f"server expects {K}")
    step = make_client_step(store, loss_fn, cfg.local_iters, cfg.batch_size,
                            cfg.seed, opt=opt, lr=cfg.lr,
                            layout=server.layout)
    rng0 = np.random.default_rng(lg.seed)
    if lg.rate_sigma > 0:
        weights = rng0.lognormal(0.0, lg.rate_sigma, K)
    else:
        weights = np.ones(K)
    weights = weights / weights.sum()

    lock = threading.Lock()
    seqs = np.zeros((K,), np.int64)
    tickets: list = []
    counts = {"admitted": 0, "skipped": 0, "busy": 0}
    rejects: dict[str, int] = {}
    errors: list = []
    deadline = time.perf_counter() + lg.timeout_s

    def work(widx: int):
        rng = np.random.default_rng(lg.seed * 9973 + 7 * widx + 1)
        while True:
            with lock:
                if counts["admitted"] >= lg.uploads:
                    return
            if time.perf_counter() > deadline:
                return
            k = int(rng.choice(K, p=weights))
            if lg.pace_s > 0:
                time.sleep(float(rng.exponential(lg.pace_s)))
            if server.in_flight(k):      # advisory — saves the train compute
                with lock:
                    counts["busy"] += 1
                continue
            version, g = server.pull_row()
            if lg.respect_probs:
                if rng.random() >= float(server.transmit_probs()[k]):
                    with lock:
                        counts["skipped"] += 1
                    continue
            with lock:
                seq = int(seqs[k])
                seqs[k] += 1
            delta = step(g, k, seq)
            if delta.device.type == "cuda":
                torch.cuda.current_stream(delta.device).synchronize()
            tk = server.submit(k, delta, version, seq=seq,
                               energy_j=server.upload_cost(k))
            with lock:
                if tk.admitted:
                    counts["admitted"] += 1
                    tickets.append(tk)
                else:
                    rejects[tk.reason] = rejects.get(tk.reason, 0) + 1

    def worker(widx: int):
        try:
            work(widx)
        except Exception as e:       # raised below, on the caller's thread
            errors.append(e)

    tel = get_telemetry()
    t0 = time.perf_counter()
    with tel.span("serve.loadgen"):
        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(lg.workers)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=lg.timeout_s + 10.0)
        if errors:
            raise errors[0]
        unresolved = 0
        for tk in tickets:
            if tk.wait(timeout=lg.ticket_wait_s) is None:
                unresolved += 1
    elapsed = time.perf_counter() - t0

    stats = server.stats()
    resolved = counts["admitted"] - unresolved
    report = {
        "clients": K,
        "uploads_admitted": counts["admitted"],
        "uploads_resolved": resolved,
        "uploads_unresolved": unresolved,
        "skipped_bernoulli": counts["skipped"],
        "skipped_busy": counts["busy"],
        "rejected": rejects,
        "elapsed_s": elapsed,
        "uploads_per_second": resolved / max(elapsed, 1e-9),
        "batches": stats.get("batches", 0),
        "admit_ms": stats.get("admit_ms", {}),
        "occupancy": stats.get("occupancy", {}),
        "distinct_clients": int(np.count_nonzero(seqs)),
    }
    emit_run_manifest(
        "serve_loadgen", lg,
        extra={"clients": K, "uploads_admitted": counts["admitted"],
               "uploads_per_second": report["uploads_per_second"],
               "batches": report["batches"]})
    return report
