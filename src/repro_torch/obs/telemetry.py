"""Host-side telemetry: spans, counters and run manifests.  The part of
``repro.obs.telemetry`` that ``launch.generate`` uses.

The in-memory record is always on (dict updates); writing to disk
is opt-in: with ``REPRO_OBS_DIR`` set, run manifests append to
``<dir>/runs.jsonl``, one JSON object a line, in the JAX package's schema
(``schema_version``, ``kind``, ``written_unix``, ``config_sha``,
``fingerprint``, ``extra``).  The fingerprint names torch and CUDA where the
JAX package's names JAX.

Spans aggregate per name (count / total / max seconds).  A span measures
the host clock: around work on the card it covers the enqueue unless the
work inside ends in a synchronisation.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import os
import platform
import subprocess
import time
from typing import Any

import torch

MANIFEST_SCHEMA_VERSION = 1
_MAX_MANIFESTS = 256


class Telemetry:
    """Aggregation sink: counters, named spans, manifests."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.counters: dict = {}
        self.spans: dict = {}          # name -> [count, total_s, max_s]
        self.manifests: list = []

    def inc(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            c = self.spans.setdefault(name, [0, 0.0, 0.0])
            c[0] += 1
            c[1] += dt
            c[2] = max(c[2], dt)

    def span_stats(self, name: str) -> dict | None:
        c = self.spans.get(name)
        if c is None:
            return None
        return {"count": c[0], "total_s": c[1], "max_s": c[2],
                "mean_s": c[1] / max(c[0], 1)}


_TELEMETRY = Telemetry()


def get_telemetry() -> Telemetry:
    """The process-wide sink (the JAX package's, likewise, is one)."""
    return _TELEMETRY


@functools.lru_cache(maxsize=1)
def _git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def env_fingerprint() -> dict:
    """Where and what produced a run: git sha, torch and CUDA versions,
    whether a card is visible and how many, CPU count, platform."""
    cuda = torch.cuda.is_available()
    return {
        "git_sha": _git_sha(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "backend": "cuda" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "cpu_count": os.cpu_count(),
        "platform": platform.platform(),
        "python": platform.python_version(),
    }


def config_fingerprint(cfg: Any) -> str:
    """Short stable hash of a config's repr (a frozen dataclass's repr is
    its full field map)."""
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


def run_manifest(kind: str, cfg: Any = None,
                 extra: dict | None = None) -> dict:
    return {
        "schema_version": MANIFEST_SCHEMA_VERSION,
        "kind": kind,
        "written_unix": time.time(),
        "config_sha": config_fingerprint(cfg) if cfg is not None else "",
        "fingerprint": env_fingerprint(),
        "extra": dict(extra or {}),
    }


def emit_run_manifest(kind: str, cfg: Any = None,
                      extra: dict | None = None) -> dict:
    """Record a manifest in the process telemetry and, when
    ``REPRO_OBS_DIR`` is set, append it to ``<dir>/runs.jsonl``."""
    m = run_manifest(kind, cfg, extra)
    tel = get_telemetry()
    tel.manifests.append(m)
    del tel.manifests[:-_MAX_MANIFESTS]
    d = os.environ.get("REPRO_OBS_DIR")
    if d:
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "runs.jsonl"), "a") as f:
            f.write(json.dumps(m, default=float) + "\n")
    return m
