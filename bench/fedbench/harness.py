"""One run of a cell: set-up, the measured window, the traced reading of
the per-layer metrics, the check against the plain reference, and the
result line.

    python3 bench/run.py --workload <w> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the inputs from the seed on the card, loads K1 (built once
into the checkout's ``src/repro_torch/kernels/_build``), builds the
runner through ``repro_torch.fl.make_runner`` and runs it once on the
cell's own shapes.  The window then runs seed lanes one after another
(each a run of T rounds), for ``--seconds`` seconds, the run in flight at
the end finished and counted: ``rounds_per_s`` is all rounds completed
over all the time they took.  One run of the window, drawn from the seed,
is judged against the reference once the window has closed and the
program's state is freed.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np

from . import spec

BANNED = ("jax", "jaxlib", "flax", "repro")
#: the traced part of a ``--trace 1`` window: its first whole runs that
#: last this long (a longer trace only slows its reading)
TRACE_SECONDS = 8.0


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _cache_dirs() -> None:
    """Every build and kernel cache in fixed directories of the checkout:
    the CUDA driver's, and Triton's and PyTorch's extension builds for
    kernels a later program may bring (K1 builds into the checkout's
    ``src/repro_torch/kernels/_build`` itself)."""
    base = spec.ROOT / ".bench_cache"
    for var, sub in (("CUDA_CACHE_PATH", "cuda"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)


def banned_modules() -> list:
    """Top-level names of loaded modules that the port must not bring in,
    each compared whole."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(BANNED))


def _sync(torch, devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _trace_context(cell, runs, T, seconds, tel, spans0, k1_0,
                   devices) -> dict:
    """What the per-layer readers read of the traced runs (the device
    trace is added under ``"trace"``)."""
    from . import program
    k1_1 = program.k1_counters()
    return {"config": cell.config, "traffic": cell.traffic,
            "model": cell.model, "runs": list(runs),
            "rounds": len(runs) * T, "window_s": seconds,
            "spans": {k: v[1] - spans0.get(k, 0.0)
                      for k, v in tel.spans.items()},
            "k1": {k: k1_1[k] - k1_0[k] for k in k1_0},
            "blocks": len(devices),
            "width": -(-int(cell.config["parameters"]) // 4) * 4,
            "devices": [d.index for d in devices]}


def check_numbers(cell, world, lane: int, devices, prog: dict,
                  clients, ref: dict | None = None) -> dict:
    """The numbers of ``prog`` (a run's outputs) against the reference's
    run of the same lane (``ref``, computed here when not given)."""
    from . import compare, reference
    if ref is None:
        ref = reference.run(cell, world, lane, devices, clients=clients)
    return compare.numbers(prog, ref, cell.config["layers"])


def run_cell(cell, seed: int, seconds: float, trace: bool, devices: list,
             t_start: float) -> dict:
    """The result line of one run of ``cell`` on ``devices``."""
    import torch

    from . import compare, program
    from . import trace as tracing
    from .world import make_world

    from repro_torch.obs.telemetry import get_telemetry

    devices = [torch.device(d) for d in devices]
    on_card = devices[0].type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cell.config["tf32"])
    T = int(cell.traffic["rounds"])
    store_dev = "cpu" if len(devices) > 1 else None
    t = time.time()
    world = make_world(cell, seed, devices[0], store_device=store_dev)
    _sync(torch, devices)
    log(f"[setup] inputs {time.time() - t:.3f} s")
    t = time.time()
    runner = program.build_runner(cell, world, devices)
    log(f"[setup] runner {time.time() - t:.3f} s")
    t = time.time()
    runner(world.params, world.h, seed=world.lane(0))
    _sync(torch, devices)
    log(f"[setup] warm-up run {time.time() - t:.3f} s")
    if trace:   # the profiler's first start, before the traced window
        tracing.start().stop()
    setup_s = time.time() - t_start

    clients = program.sample_clients(cell, seed)
    tel = get_telemetry()
    spans0 = {k: v[1] for k, v in tel.spans.items()}
    k1_0 = program.k1_counters()
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 4])
    prof = tracing.start() if trace else None
    ctx = None
    if prof is not None:
        window = torch.profiler.record_function(tracing.WINDOW)
        window.__enter__()
    runs, kept, i = [], None, 1

    def read_trace(elapsed: float) -> dict:
        window.__exit__(None, None, None)
        prof.stop()
        out = _trace_context(cell, runs, T, elapsed, tel, spans0, k1_0,
                             devices)
        t = time.time()
        out["trace"] = tracing.reduce(prof, out["devices"]) if on_card \
            else {}
        log(f"[trace] {len(runs)} runs traced, read in "
            f"{time.time() - t:.3f} s")
        return out

    t0 = time.perf_counter()
    while True:
        res = runner(world.params, world.h, seed=world.lane(i))
        _sync(torch, devices)
        if rng.random() < 1.0 / i:       # one run kept, uniform over all
            kept = (i, program.outputs(res, clients))
        if prof is not None:
            runs.append({"n_tx": np.asarray(res.participation).sum(1)})
        del res
        i += 1
        now = time.perf_counter()
        if prof is not None and now - t0 >= TRACE_SECONDS:
            ctx = read_trace(now - t0)
            prof = None
            t0 += time.perf_counter() - now   # the reading is not timed
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    if prof is not None:
        ctx = read_trace(t1 - t0)
    n_runs = i - 1
    rounds = n_runs * T
    log(f"[window] {n_runs} runs, {rounds} rounds in {t1 - t0:.3f} s")
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) \
        if on_card else 0
    metrics = {}
    device = {"platform": "gpu" if on_card else devices[0].type,
              "kind": torch.cuda.get_device_name(devices[0]) if on_card
              else "cpu",
              "count": len(devices), "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        red = ctx["trace"]
        if red:
            device["busy_s"] = float(np.mean(list(red["busy_s"].values())))
            device["window_s"] = float(red["window_s"])
            breakdown = {"device_ops": tracing.top(red["kernels"]),
                         "idle_gaps": tracing.top(red["idle_gaps"])}
    else:
        values = {"rounds_per_s": rounds / (t1 - t0),
                  "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
        for m in cell.end_to_end:
            v = values[spec.base(m["name"])]
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the check: the kept run against the reference, after the program's
    # state is gone
    del runner
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.time()
    lane_i, prog_out = kept
    values = check_numbers(cell, world, world.lane(lane_i), devices,
                           prog_out, clients)
    correct, table = compare.judge(values, cell.limits)
    log(f"[check] run {lane_i} of {n_runs} against the reference in "
        f"{time.time() - t:.3f} s")
    result = {"correct": bool(correct), "attempted": n_runs,
              "failed": 0 if correct else 1, "metrics": metrics,
              "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = table
    for name, row in table.items():
        log(f"check {name} {row['value']} limit {row['limit']}")
    return result


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.time() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    _cache_dirs()
    sys.path.insert(0, str(spec.ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        log("no CUDA card visible: this benchmark measures the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      [f"cuda:{i}" for i in range(cell.chips)], t_start)
    bad = banned_modules()
    if bad:
        log(f"modules loaded that must not be: {bad}")
        return 3
    print(json.dumps(result), flush=True)
    return 0
