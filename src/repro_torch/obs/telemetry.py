"""Host-side telemetry: spans, counters, memory snapshots, run manifests
and profiler captures (counterpart of ``repro.obs.telemetry``).

Everything here is host Python around the device work; it changes no
round's arithmetic.  The in-memory record is always on (dict updates);
writing to disk is opt-in:

* ``REPRO_OBS_DIR`` (or :func:`configure`) — run manifests append to
  ``<dir>/runs.jsonl``, one JSON object a line, in the JAX package's schema
  (:data:`MANIFEST_SCHEMA`, checked by :func:`validate_manifest` and
  ``python -m repro_torch.obs.report --validate``).  The fingerprint names
  torch and CUDA where the JAX package's names JAX and jaxlib;
* ``REPRO_PROFILE_DIR`` (or :func:`configure`) — :func:`maybe_profile`
  wraps a block in ``torch.profiler`` and exports a Chrome trace there.

Spans aggregate per name as ``[count, total_s, max_s, parent]`` (a million
runner calls cost a bounded dict): the host clock (``perf_counter``), and
the name of the span open around it on the same thread when the name was
first recorded (``None`` at a root), so :meth:`Telemetry.snapshot` gives
the tree and a span's self time (its total less its children's).  On the
host clock a span around work on the card covers the enqueue unless the
work inside ends in a synchronisation.

Tracing is on exactly while a ``torch.profiler`` records (the benchmark's
traced window, :func:`maybe_profile`, or a caller's own profiler); there
is no other switch.  Then a span is also a ``record_function`` range, so
it sits in the profiler's timeline above its kernels and the card's idle
gaps, and on each CUDA device of its ``devices`` a pair of timing events
brackets it on the device's current stream, with no synchronisation inside
the span.  The pairs are read when the outermost open span on the thread
closes (each root of the engines ends in a readback, so that read waits on
nothing; a root that does not pays one synchronisation) into ``<name>.device``
in the same format, the longest of its devices, its parent the nearest
enclosing span that times devices.  A pair runs from the phase's start on
the stream to the end of its last kernel, so it holds any idle in which
the card waited for the phase's host work: consecutive phases' pairs tile
the card's timeline.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import os
import platform
import subprocess
import threading
import time
from typing import Any

import torch

__all__ = ["Telemetry", "get_telemetry", "configure", "env_fingerprint",
           "config_fingerprint", "run_manifest", "emit_run_manifest",
           "validate_manifest", "maybe_profile", "timed_compile",
           "MANIFEST_SCHEMA", "MANIFEST_SCHEMA_VERSION"]

MANIFEST_SCHEMA_VERSION = 1

#: required manifest keys -> type (``extra`` is free-form)
MANIFEST_SCHEMA = {
    "schema_version": int,
    "kind": str,
    "written_unix": float,
    "config_sha": str,
    "fingerprint": dict,
    "extra": dict,
}

#: the fingerprint's required keys: JAX's, with ``torch`` and ``cuda`` in
#: place of ``jax`` and ``jaxlib``
_FINGERPRINT_KEYS = ("git_sha", "torch", "cuda", "backend", "device_count",
                     "cpu_count", "platform", "python")

#: cap on the in-memory manifest record (old entries rotate out)
_MAX_MANIFESTS = 256


class Telemetry:
    """Aggregation sink: counters, named spans, manifests."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.counters: dict = {}
        self.spans: dict = {}   # name -> [count, total_s, max_s, parent]
        self.manifests: list = []
        self._local = threading.local()   # each thread's open spans

    def inc(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def _record(self, name: str, dt: float, parent: str | None) -> None:
        c = self.spans.get(name)
        if c is None:
            c = self.spans[name] = [0, 0.0, 0.0, parent]
        c[0] += 1
        c[1] += dt
        c[2] = max(c[2], dt)

    @contextlib.contextmanager
    def span(self, name: str, devices=()):
        """Time the block as ``name`` on the host clock; while a profiler
        records, also as a ``record_function`` range and, on each CUDA
        device of ``devices`` (``torch.device``s; others and repeats are
        skipped), a timing-event pair (see the module docstring)."""
        local = self._local
        if not hasattr(local, "open"):
            local.open, local.pending = [], []
        stack = local.open
        parent = stack[-1][0] if stack else None
        pairs = None
        if torch._C._autograd._profiler_enabled():
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            pairs = [(torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True), d)
                     for d in dict.fromkeys(devices) if d.type == "cuda"]
            for start, _, d in pairs:
                start.record(torch.cuda.current_stream(d))
        stack.append((name, bool(pairs)))
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            if pairs is not None:
                for _, end, d in pairs:
                    end.record(torch.cuda.current_stream(d))
                rf.__exit__(None, None, None)
            self._record(name, dt, parent)
            if pairs:
                timed = [n for n, on in stack if on]
                local.pending.append((name + ".device", pairs,
                                      timed[-1] + ".device" if timed
                                      else None))
            if not stack and local.pending:
                self._resolve(local.pending)

    def _resolve(self, pending: list) -> None:
        """Each closed span's device time, the longest of its pairs."""
        for name, pairs, parent in pending:
            for _, end, _ in pairs:
                end.synchronize()
            self._record(name, max(start.elapsed_time(end)
                                   for start, end, _ in pairs) * 1e-3,
                         parent)
        pending.clear()

    def span_stats(self, name: str) -> dict | None:
        c = self.spans.get(name)
        if c is None:
            return None
        return {"count": c[0], "total_s": c[1], "max_s": c[2],
                "mean_s": c[1] / max(c[0], 1), "parent": c[3]}

    def snapshot(self) -> dict:
        return {"counters": dict(self.counters),
                "spans": {k: self.span_stats(k) for k in self.spans}}

    def memory_snapshot(self) -> list:
        """Each card's current and peak allocated bytes
        (``torch.cuda.memory_stats``); with no card, one CPU entry whose
        values are ``None``, as JAX's CPU backend gives."""
        if not torch.cuda.is_available():
            return [{"device": "cpu", "bytes_in_use": None,
                     "peak_bytes_in_use": None}]
        out = []
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            out.append({
                "device": f"cuda:{i} {torch.cuda.get_device_name(i)}",
                "bytes_in_use": stats.get("allocated_bytes.all.current"),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak")})
        return out


_TELEMETRY = Telemetry()
_OBS_DIR: str | None = None
_PROFILE_DIR: str | None = None


def get_telemetry() -> Telemetry:
    """The process-wide sink (the JAX package's, likewise, is one)."""
    return _TELEMETRY


def configure(obs_dir: str | None = None,
              profile_dir: str | None = None) -> None:
    """Programmatic opt-in (overrides the environment variables)."""
    global _OBS_DIR, _PROFILE_DIR
    if obs_dir is not None:
        _OBS_DIR = obs_dir
    if profile_dir is not None:
        _PROFILE_DIR = profile_dir


def _obs_dir() -> str | None:
    return _OBS_DIR or os.environ.get("REPRO_OBS_DIR") or None


def _profile_dir() -> str | None:
    return _PROFILE_DIR or os.environ.get("REPRO_PROFILE_DIR") or None


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
    """Record a manifest in the process telemetry and, when an obs dir is
    configured, append it to ``<dir>/runs.jsonl``.  Called by
    ``make_runner``, ``make_sparse_runner``, the ``run_*_matrix`` sweeps,
    ``run_resumable`` and ``launch.generate``."""
    m = run_manifest(kind, cfg, extra)
    tel = get_telemetry()
    tel.manifests.append(m)
    del tel.manifests[:-_MAX_MANIFESTS]
    d = _obs_dir()
    if d:
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "runs.jsonl"), "a") as f:
            f.write(json.dumps(m, default=float) + "\n")
    return m


def validate_manifest(m: dict) -> list:
    """Schema check: a list of problems (empty = valid)."""
    if not isinstance(m, dict):
        return [f"manifest is {type(m).__name__}, expected dict"]
    problems = []
    for key, typ in MANIFEST_SCHEMA.items():
        if key not in m:
            problems.append(f"missing key {key!r}")
        elif typ is float and isinstance(m[key], (int, float)):
            pass
        elif not isinstance(m[key], typ):
            problems.append(f"key {key!r}: {type(m[key]).__name__}, "
                            f"expected {typ.__name__}")
    fp = m.get("fingerprint")
    if isinstance(fp, dict):
        problems += [f"fingerprint missing {k!r}"
                     for k in _FINGERPRINT_KEYS if k not in fp]
    return problems


@contextlib.contextmanager
def maybe_profile(out_dir: str | None = None):
    """Opt-in ``torch.profiler`` capture of the block (CPU, and CUDA where
    a card is visible), exported as a Chrome trace
    ``<dir>/trace_<pid>_<n>.json``: a no-op unless ``out_dir`` is given or
    ``REPRO_PROFILE_DIR``/:func:`configure` set one.  Yields the directory
    (``None`` when off)."""
    d = out_dir or _profile_dir()
    if not d:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(d, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    tel = get_telemetry()
    tel.inc("profile.captures")
    with profile(activities=acts) as prof:
        yield d
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        d, f"trace_{os.getpid()}_{tel.counters['profile.captures']}.json"))


def timed_compile(fn, *args, label: str = "jit"):
    """The eager counterpart of JAX's AOT ``timed_compile``: there is no
    trace, lowering or compile stage to time, so the first call
    ``fn(*args)`` runs under the ``<label>.compile`` span — what a first
    call pays here: kernels built at first use, cuBLAS handles, the
    caching allocator's first blocks — followed by a synchronisation of
    the card (when one is visible) inside the span.  Returns ``fn``, ready
    for its warm calls; wrap those in ``span(f"{label}.execute")``.  No
    ``<label>.trace`` or ``<label>.lower`` span is recorded."""
    with get_telemetry().span(f"{label}.compile"):
        fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return fn
