"""Observability: host telemetry (spans, counters, run manifests)."""
from .telemetry import emit_run_manifest, env_fingerprint, get_telemetry

__all__ = ["emit_run_manifest", "env_fingerprint", "get_telemetry"]
