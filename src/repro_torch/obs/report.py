"""Benchmark-ledger reporter: summarize runs, diff two BENCH_*.json files
(counterpart of ``repro.obs.report``, reading the port's manifests).

Three modes::

    python -m repro_torch.obs.report --summary obs_out/runs.jsonl
    python -m repro_torch.obs.report --validate obs_out/runs.jsonl
    python -m repro_torch.obs.report --diff BENCH_old.json BENCH_new.json \
        --threshold 1.25 [--keys engine]

``--validate`` checks every JSONL line against :data:`MANIFEST_SCHEMA` and
exits 1 on the first malformed manifest.  ``--diff`` flattens the numeric
scalar leaves shared by both files and compares them: keys whose leaf name
ends in a time suffix (``_s``/``_ms``/``_us``/``_sec``/``_seconds``) are
*lower-is-better* and **gate** — a new/old ratio above the threshold is a
regression and the process exits 1; every other shared
numeric key is reported informationally.  Environment-stamp keys
(``fingerprint``, ``written_unix``, ``schema`` …) are skipped, since they
legitimately differ between runs.
"""
from __future__ import annotations

import argparse
import json
import sys

from .telemetry import validate_manifest

#: leaf-name suffixes treated as timings (lower is better, gated on diff).
TIME_SUFFIXES = ("_s", "_ms", "_us", "_sec", "_seconds")

#: top-level / leaf keys that are stamps, not measurements.
SKIP_KEYS = {"fingerprint", "written_unix", "schema", "schema_version",
             "config_sha", "git_sha"}

#: bases smaller than this are noise — ratios against them are meaningless.
MIN_BASE = 1e-9


def flatten_numeric(obj, prefix: str = "", out: dict | None = None) -> dict:
    """``{"a": {"b": [1.5, 2]}} -> {"a.b[0]": 1.5, "a.b[1]": 2.0}`` keeping
    only int/float scalar leaves (bools excluded) and skipping stamp keys."""
    if out is None:
        out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k in SKIP_KEYS:
                continue
            flatten_numeric(v, f"{prefix}.{k}" if prefix else str(k), out)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            flatten_numeric(v, f"{prefix}[{i}]", out)
    elif isinstance(obj, bool):
        pass
    elif isinstance(obj, (int, float)):
        out[prefix] = float(obj)
    return out


def is_time_key(key: str) -> bool:
    leaf = key.rsplit(".", 1)[-1]
    leaf = leaf.split("[", 1)[0]
    return leaf.endswith(TIME_SUFFIXES)


def diff_benches(old: dict, new: dict, threshold: float,
                 key_filter: str | None = None) -> dict:
    """Compare shared numeric leaves.  Returns ``{"rows": [...],
    "regressions": [...], "missing": [...], "added": [...]}`` where each row
    is ``(key, old, new, ratio, gated)``."""
    fo, fn = flatten_numeric(old), flatten_numeric(new)
    if key_filter:
        fo = {k: v for k, v in fo.items() if key_filter in k}
        fn = {k: v for k, v in fn.items() if key_filter in k}
    rows, regressions = [], []
    for k in sorted(set(fo) & set(fn)):
        o, n = fo[k], fn[k]
        gated = is_time_key(k)
        if abs(o) < MIN_BASE:
            ratio = None          # near-zero base: report, never gate
        else:
            ratio = n / o
        rows.append({"key": k, "old": o, "new": n, "ratio": ratio,
                     "gated": gated})
        if gated and ratio is not None and ratio > threshold:
            regressions.append(rows[-1])
    return {"rows": rows, "regressions": regressions,
            "missing": sorted(set(fo) - set(fn)),
            "added": sorted(set(fn) - set(fo))}


def render_diff(d: dict, threshold: float) -> str:
    lines = [f"{'key':<56} {'old':>12} {'new':>12} {'ratio':>8}  gate"]
    for r in d["rows"]:
        ratio = "n/a" if r["ratio"] is None else f"{r['ratio']:.3f}"
        flag = ""
        if r["gated"]:
            flag = "REGRESSED" if r in d["regressions"] else "ok"
        lines.append(f"{r['key']:<56} {r['old']:>12.6g} {r['new']:>12.6g} "
                     f"{ratio:>8}  {flag}")
    for k in d["missing"]:
        lines.append(f"{k:<56} (removed in new)")
    for k in d["added"]:
        lines.append(f"{k:<56} (new key)")
    n_gated = sum(1 for r in d["rows"] if r["gated"])
    lines.append(f"-- {len(d['rows'])} shared keys, {n_gated} gated at "
                 f"{threshold:.2f}x, {len(d['regressions'])} regression(s)")
    return "\n".join(lines)


def load_jsonl(path: str) -> list:
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise SystemExit(f"{path}:{i + 1}: bad JSON line: {e}")
    return out


def summarize_runs(manifests: list) -> str:
    lines = [f"{len(manifests)} run manifest(s)"]
    by_kind: dict = {}
    for m in manifests:
        by_kind.setdefault(m.get("kind", "?"), []).append(m)
    for kind, ms in sorted(by_kind.items()):
        fp = ms[-1].get("fingerprint", {}) or {}
        lines.append(f"  {kind:<24} x{len(ms):<4} backend={fp.get('backend')}"
                     f" devices={fp.get('device_count')}"
                     f" torch={fp.get('torch')} cuda={fp.get('cuda')}"
                     f" git={str(fp.get('git_sha'))[:9]}")
        extra = ms[-1].get("extra", {}) or {}
        for k in sorted(extra)[:8]:
            v = extra[k]
            if isinstance(v, float):
                v = f"{v:.6g}"
            lines.append(f"      {k} = {v}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.report",
        description="Benchmark-ledger reporter / perf-regression gate.")
    ap.add_argument("--summary", metavar="RUNS_JSONL",
                    help="render a summary of a runs.jsonl manifest log")
    ap.add_argument("--validate", metavar="RUNS_JSONL",
                    help="schema-check every manifest line; exit 1 if any fail")
    ap.add_argument("--diff", nargs=2, metavar=("OLD", "NEW"),
                    help="diff two BENCH_*.json files; exit 1 on regression")
    ap.add_argument("--threshold", type=float, default=1.25,
                    help="gated-ratio bound for --diff (default 1.25)")
    ap.add_argument("--keys", default=None,
                    help="only diff keys containing this substring")
    args = ap.parse_args(argv)

    if not (args.summary or args.validate or args.diff):
        ap.error("one of --summary / --validate / --diff is required")

    rc = 0
    if args.validate:
        manifests = load_jsonl(args.validate)
        bad = 0
        for i, m in enumerate(manifests):
            problems = validate_manifest(m)
            for p in problems:
                print(f"{args.validate}:{i + 1}: {p}")
            bad += bool(problems)
        print(f"{len(manifests) - bad}/{len(manifests)} manifests valid")
        if bad or not manifests:
            rc = 1
    if args.summary:
        print(summarize_runs(load_jsonl(args.summary)))
    if args.diff:
        with open(args.diff[0]) as f:
            old = json.load(f)
        with open(args.diff[1]) as f:
            new = json.load(f)
        d = diff_benches(old, new, args.threshold, args.keys)
        print(render_diff(d, args.threshold))
        if d["regressions"]:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
