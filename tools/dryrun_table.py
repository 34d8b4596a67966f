"""The markdown table of the port's dry runs: one row per arch × shape,
each mesh's status, run seconds (build + run + probes, on the machine that
ran it), predicted per-device argument and peak temporary GB, FLOPs and
collective GB, and for each failure the failing operation's message.

    PYTHONPATH=src python tools/dryrun_table.py artifacts/dryrun_torch \\
        [OTHER_DIR ...]

Each directory holds the JSON files ``python -m repro_torch.launch.dryrun
--all [--multi-pod] --out DIR`` wrote.
"""
import glob
import json
import os
import sys


def load(dirs):
    recs = {}
    for d in dirs:
        for path in sorted(glob.glob(os.path.join(d, "*.json"))):
            with open(path) as f:
                r = json.load(f)
            recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def cell(r) -> str:
    if r is None:
        return "not run"
    if r["status"] != "ok":
        return f"**fail** ({r.get('seconds', '?')} s): {r['error'][:160]}"
    secs = r["build_s"] + r["run_s"] + r.get("probe_s", 0.0)
    m, c = r["memory"], r["collectives"]
    return (f"ok, {secs:.1f} s; args {m['argument_size_in_bytes'] / 1e9:.3f}"
            f" GB, temp {m['temp_size_in_bytes'] / 1e9:.3f} GB, "
            f"{r['cost']['flops']:.3e} FLOPs, coll "
            f"{c['total_bytes'] / 1e9:.3f} GB")


def main(dirs) -> int:
    recs = load(dirs)
    keys = sorted({(a, s) for a, s, _ in recs})
    print("| arch | shape | mode | 16x16 | 2x16x16 |")
    print("|---|---|---|---|---|")
    for arch, shape in keys:
        one = recs.get((arch, shape, "16x16"))
        two = recs.get((arch, shape, "2x16x16"))
        mode = (one or two or {}).get("mode", "-")
        print(f"| {arch} | {shape} | {mode} | {cell(one)} | {cell(two)} |")
    ok = sum(r["status"] == "ok" for r in recs.values())
    print(f"\n{ok} of {len(recs)} combinations ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:] or ["artifacts/dryrun_torch"]))
