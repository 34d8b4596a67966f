"""Observability (counterpart of ``repro.obs``), three layers:

* :mod:`repro_torch.obs.taps` — per-round metrics: a :class:`MetricsSpec`
  of reducers accumulated into fixed-shape tensors carried through every
  execution path.  Disabled (the default), a run launches exactly the
  untapped run's operations.
* :mod:`repro_torch.obs.telemetry` — host side: spans, counters, memory
  snapshots, the JSONL run manifest (opt-in via ``REPRO_OBS_DIR``) and a
  ``torch.profiler`` capture (opt-in via ``REPRO_PROFILE_DIR``).
* :mod:`repro_torch.obs.report` — summaries of ``runs.jsonl`` and the
  diff of two ``BENCH_*.json`` files with a regression threshold.
"""
from .taps import (MetricsSpec, MetricsState, init_metrics, merge_metrics,
                   metrics_active, metrics_round_update, metrics_summary,
                   update_ledger_taps, update_train_taps)
from .telemetry import (config_fingerprint, configure, emit_run_manifest,
                        env_fingerprint, get_telemetry, maybe_profile,
                        run_manifest, timed_compile, validate_manifest)

__all__ = [
    "MetricsSpec", "MetricsState", "init_metrics", "merge_metrics",
    "metrics_active", "metrics_round_update", "metrics_summary",
    "update_ledger_taps", "update_train_taps",
    "config_fingerprint", "configure", "emit_run_manifest",
    "env_fingerprint", "get_telemetry", "maybe_profile", "run_manifest",
    "timed_compile", "validate_manifest",
]
