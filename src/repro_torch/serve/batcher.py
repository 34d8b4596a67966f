"""Micro-batcher: coalesce async uploads into one aggregation launch
(counterpart of ``repro.serve.batcher``).

* :func:`build_apply_fn` — the device side.  Stacks the submitted ``[W]``
  delta rows, zero-pads them to a pow2 *bucket* (:func:`pick_bucket`, the
  sparse engine's ``participant_bucket`` discipline) and runs the **same**
  participant-subset aggregation family as the sparse engine's phase B —
  ``scheme_subset_aggregate`` / ``guarded_subset_aggregate`` /
  ``subset_aggregate``, in the same precedence order, with the population
  size as the 1/K divisor: one K1 launch a flush, in its subset mode, or
  its weighted mode under active guards or a scheme aggregator.  Replay
  parity depends on this: an offline re-run through
  ``build_sparse_train_program`` hits the identical aggregation code on
  identically padded lanes.  JAX keeps a cache of jitted aggregations
  across servers (``_AGG_CACHE``); PyTorch runs eagerly and compiles
  nothing, so the port has no such cache.
* :class:`MicroBatcher` — the host side.  A daemon thread parked on the
  server's condition variable; it flushes when a full ``max_batch`` is
  pending or the oldest pending update has waited ``flush_interval_s``
  (the latency bound).
"""
from __future__ import annotations

import threading
import time

import torch

from .. import resolve_device
from ..fl.state import (guarded_subset_aggregate, scheme_subset_aggregate,
                        subset_aggregate)


def pick_bucket(n: int, min_bucket: int, max_batch: int) -> int:
    """Smallest power of two ≥ max(n, min_bucket), clamped to max_batch."""
    need = max(int(n), int(min_bucket), 1)
    b = 1 << (need - 1).bit_length()
    return min(b, int(max_batch))


def build_apply_fn(guards, aggregator, num_clients: int, device=None):
    """``(global [W], deltas: list of [W] rows, bucket, stale [n], probs
    [n]) -> global' [W]`` on ``device`` (``None`` means the card), a fresh
    tensor (the input row is never written).  ``stale`` and ``probs`` are
    host arrays or tensors of the ``n`` real lanes; the padding lanes get
    ``valid`` False, staleness 0 and probability 0."""
    ap = (aggregator.params(resolve_device(device))
          if aggregator is not None else None)

    def apply(g: torch.Tensor, deltas: list, bucket: int, stale, probs):
        n = len(deltas)
        dev = g.device
        deltas_p = torch.stack(deltas)
        if bucket > n:
            deltas_p = torch.cat([deltas_p, deltas_p.new_zeros(
                (bucket - n,) + deltas_p.shape[1:])])
        valid = torch.arange(bucket, device=dev) < n
        stale_p = torch.zeros(bucket, dtype=torch.int32, device=dev)
        stale_p[:n] = torch.as_tensor(stale, dtype=torch.int32).to(dev)
        probs_p = torch.zeros(bucket, dtype=torch.float32, device=dev)
        probs_p[:n] = torch.as_tensor(probs, dtype=torch.float32).to(dev)
        # precedence mirrors fl/sparse.build_sparse_train_program exactly
        if aggregator is not None:
            return scheme_subset_aggregate(g, deltas_p, valid, num_clients,
                                           stale_p, probs_p, ap,
                                           guards=guards)
        if guards is not None and guards.active:
            return guarded_subset_aggregate(g, deltas_p, valid, num_clients,
                                            stale_p, guards)
        return subset_aggregate(g, deltas_p, valid, num_clients)

    return apply


class MicroBatcher(threading.Thread):
    """Background flush loop.  Holds the server's condition variable only to
    *decide* when to flush; the flush itself (device work) runs unlocked
    through :meth:`AggregationServer.flush`.  An exception in a flush is
    recorded on :attr:`error` and stops the loop; the server's ``close``
    raises it to its caller."""

    def __init__(self, server):
        super().__init__(daemon=True, name="repro-serve-batcher")
        self._srv = server
        self._halt = threading.Event()
        self.error: BaseException | None = None

    def run(self) -> None:
        srv = self._srv
        cfg = srv.cfg
        while not self._halt.is_set():
            with srv._cv:
                while (not srv._pending and not self._halt.is_set()
                        and not srv._closed):
                    srv._cv.wait(timeout=0.05)
                if self._halt.is_set():
                    return
                if not srv._pending:       # closed and drained
                    return
                if not srv._closed and len(srv._pending) < cfg.max_batch:
                    oldest = min(p.ticket.arrival_s
                                 for p in srv._pending.values())
                    wait_for = (cfg.flush_interval_s
                                - (time.perf_counter() - oldest))
                    if wait_for > 0:
                        srv._cv.wait(timeout=wait_for)
                        continue
            try:
                srv.flush()
            except Exception as e:       # kept for close() to surface
                self.error = e
                return

    def stop(self, timeout: float = 10.0) -> None:
        self._halt.set()
        with self._srv._cv:
            self._srv._cv.notify_all()
        self.join(timeout=timeout)
