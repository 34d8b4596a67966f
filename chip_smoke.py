#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reporting on its own lines:

1. environment — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, the precision settings, and the K1 kernel's ``nvcc`` build
   (from ``src/repro_torch/kernels/csrc``, into ``kernels/_build``);
2. kernel — K1 (``fl_aggregate``) in all three modes, float32 and bfloat16,
   R ∈ {1, 10, 100} rows, M ∈ {77, 8193, 159012, 199210}, plus misaligned
   views, against its plain PyTorch version on the card; NaN/Inf with the
   guard on and off; then CUDA-event timings (L2 flushed before each launch)
   of the kernel, the plain version and ``torch.addmv`` at the main path's
   shape, beside the bandwidth bound;
3. slice — the quickstart simulation at full width and data scale (K = 10,
   the 784-200-10 MLP, 60,000/10,000 MNIST-like examples, non-IID d = 5,
   T = 12 rounds of 5 local steps of batch 10, ρ = 0.05, λ = 0.01) for
   ProposedOnline, RandomScheme(p̄ = 0.1) and ProposedOnline with Δ = 3; each
   run must launch K1 exactly once per round; then the same runs on the CPU
   from the same data and initial params: masks equal bit for bit, energy,
   accuracy and loss within rtol 1e-4, atol 1e-5.

Float32 products run in full float32 on the card: TF32 is switched off for
both cuBLAS matmuls and cuDNN, so card-against-CPU differences are summation
order only.  Any failed check raises and the script exits non-zero; with no
CUDA card, or without the rest of the repository beside it, it exits
non-zero before printing any result.  The last line is the one JSON object
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),     # tests/test_kernels.py
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-5               # tests/golden/harness.py
K, T = 10, 12
MAIN_M = 159_012   # the MLP's 159,010 params in a 16-byte-aligned row


def log(*parts):
    print(*parts, flush=True)


def card_bandwidth(name: str) -> tuple[float, str]:
    """Peak device-memory rate (bytes/s) of the H100 variant ``name`` names,
    from NVIDIA's data sheets."""
    if "H100" in name and "PCIe" in name:
        return 2.0e12, "H100 PCIe 2.0 TB/s"
    if "H100" in name and "NVL" in name:
        return 3.9e12, "H100 NVL 3.9 TB/s"
    return 3.35e12, "H100 SXM 3.35 TB/s"


FP32_PEAK = 67e12   # H100 SXM float32 outside the tensor cores, flop/s


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"[env] torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    from repro_torch.kernels.fl_aggregate import library
    t0 = time.perf_counter()
    built = library()
    log(f"[env] fl_aggregate built in {built.seconds:.2f} s (nvcc), ready "
        f"after {time.perf_counter() - t0:.2f} s: {built.path.name}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[ptxas] {line.strip()}")
    return smi


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def kernel_inputs(torch, R, M, dtype, gen, offset=0):
    """g [M], d [R, M] (views ``offset`` elements into their buffers), a 0/1
    mask and folded weights, all on the card."""
    dev = torch.device("cuda")
    gbuf = torch.randn(M + offset, generator=gen, device=dev)
    dbuf = torch.randn(R * M + offset, generator=gen, device=dev)
    g = gbuf.to(dtype)[offset:]
    d = dbuf.to(dtype)[offset:].view(R, M)
    mask = (torch.rand(R, generator=gen, device=dev) < 0.5).float()
    weights = mask * torch.rand(R, generator=gen, device=dev) / R
    return g, d, mask, weights


def run_mode(ops, ref, mode, g, d, mask, weights, kernel: bool):
    if mode == "plain":
        return (ops.fl_aggregate(g, d, mask) if kernel
                else ref.fl_aggregate_ref(g, d, mask))
    if mode == "subset":
        k = 3 * d.shape[0]
        return (ops.fl_aggregate_subset(g, d, mask, k) if kernel
                else ref.fl_aggregate_subset_ref(g, d, mask, k))
    return (ops.fl_aggregate_guarded(g, d, weights) if kernel
            else ref.fl_aggregate_guarded_ref(g, d, weights))


def check_kernel(torch):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    worst = {}
    main_err = 0.0
    n = 0
    for mode in ("plain", "subset", "guarded"):
        for dname, dtype in dtypes.items():
            for R in (1, 10, 100):
                for M in (77, 8193, MAIN_M, 199_210):
                    for offset in ((0, 1) if R == 10 else (0,)):
                        g, d, mask, w = kernel_inputs(torch, R, M, dtype, gen,
                                                      offset)
                        before = fl_aggregate_cuda.launches
                        out = run_mode(ops, ref, mode, g, d, mask, w, True)
                        want = run_mode(ops, ref, mode, g, d, mask, w, False)
                        torch.cuda.synchronize()
                        if fl_aggregate_cuda.launches != before + 1:
                            raise AssertionError("kernel did not launch")
                        if out.dtype != dtype or out.shape != (M,):
                            raise AssertionError(f"bad output {out.dtype} "
                                                 f"{tuple(out.shape)}")
                        err = float((out.float() - want.float()).abs().max())
                        torch.testing.assert_close(out.float(), want.float(),
                                                   **TOL[dname])
                        key = (mode, dname)
                        worst[key] = max(worst.get(key, 0.0), err)
                        if dname == "float32" and M == MAIN_M and R == K:
                            main_err = max(main_err, err)
                        n += 1
    for (mode, dname), err in sorted(worst.items()):
        log(f"[kernel] {mode:8s} {dname:8s} max |kernel - plain| = {err:.3e} "
            f"(tolerance atol {TOL[dname]['atol']}, rtol "
            f"{TOL[dname]['rtol']})")
    log(f"[kernel] {n} shape/mode/dtype/alignment cases within tolerance")

    # NaN/Inf: the guard quarantines, its absence propagates
    for dname, dtype in dtypes.items():
        for M in (77, 8193, MAIN_M):
            g, d, _, _ = kernel_inputs(torch, 4, M, dtype, gen)
            d[1] = torch.nan
            d[2, 0] = torch.inf
            d[3, -1] = -torch.inf
            w = torch.tensor([0.25, 0.0, 0.25, 0.0], device="cuda")
            out = ops.fl_aggregate_guarded(g, d, w)
            if not bool(torch.isfinite(out).all()):
                raise AssertionError("guard let a non-finite value through")
            torch.testing.assert_close(
                out.float(), ref.fl_aggregate_guarded_ref(g, d, w).float(),
                **TOL[dname])
            mask = torch.tensor([1.0, 0.0, 0.0, 0.0], device="cuda")
            plain = ops.fl_aggregate(g, d, mask)
            if not bool(torch.isnan(plain).all()):
                raise AssertionError("guard off: NaN row with mask 0 did not "
                                     "propagate")
    log("[kernel] NaN/Inf: guard on -> finite and equal to the plain version; "
        "guard off -> NaN propagates through a zero mask (fp32, bf16)")
    return main_err


def time_ms(torch, fn, flush, iters=100, warmup=5):
    """Median per-call time in ms from CUDA events, L2 flushed before each
    call (the 50 MB L2 would otherwise hold the operands)."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def time_kernel(torch, bandwidth):
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(256 * 2**20 // 4, device="cuda")   # 256 MB > L2
    rows = {}
    for R in (K, 100):
        for M in (MAIN_M, 199_210):
            g, d, mask, _ = kernel_inputs(torch, R, M, torch.float32, gen)
            lib = torch.addmv(g, d.T, mask, alpha=1.0 / R)
            torch.testing.assert_close(lib, ref.fl_aggregate_ref(g, d, mask),
                                       **TOL["float32"])
            t_kernel = time_ms(torch, lambda: ops.fl_aggregate(g, d, mask),
                               flush)
            t_plain = time_ms(torch, lambda: ref.fl_aggregate_ref(g, d, mask),
                              flush)
            t_lib = time_ms(torch, lambda: torch.addmv(g, d.T, mask,
                                                       alpha=1.0 / R), flush)
            nbytes = (R * M + 2 * M) * 4 + R * 4
            t_bytes = nbytes / bandwidth * 1e3
            t_ops = 2 * R * M / FP32_PEAK * 1e3
            bound = max(t_bytes, t_ops)
            rows[(R, M)] = dict(ms=t_kernel, plain_ms=t_plain,
                                library_ms=t_lib, bound_ms=bound,
                                bound_by="bytes" if t_bytes >= t_ops
                                else "operations")
            log(f"[kernel-time] R={R} M={M} fp32: kernel {t_kernel:.4f} ms, "
                f"plain {t_plain:.4f} ms, torch.addmv {t_lib:.4f} ms, bound "
                f"{bound:.4f} ms ({nbytes / 1e6:.2f} MB moved), kernel at "
                f"{nbytes / t_kernel / 1e9:.2f} TB/s = "
                f"{100 * bound / t_kernel:.1f}% of the bound")
    return rows


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def slice_runs(torch):
    import numpy as np

    from repro_torch import random as jr
    from repro_torch.core import CellConfig, ProblemSpec
    from repro_torch.core.channel import channel_gains, sample_positions
    from repro_torch.core.selection import ProposedOnline, RandomScheme
    from repro_torch.data import Dataset, make_mnist_like, shard_noniid
    from repro_torch.fl import SimConfig, run_simulation
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda
    from repro_torch.models.small import init_mlp, mlp_accuracy, mlp_loss

    cell = CellConfig(num_clients=K)
    spec = ProblemSpec(cell=cell, rho=0.05, lam=0.01, num_rounds=T)
    t0 = time.perf_counter()
    train, test = make_mnist_like(jr.PRNGKey(0))                 # the card
    clients = shard_noniid(jr.PRNGKey(1), train, K, d=5)
    h = channel_gains(jr.PRNGKey(3, device="cuda"),
                      sample_positions(jr.PRNGKey(2, device="cuda"), cell),
                      T).T                                       # [K, T]
    params = init_mlp(jr.PRNGKey(4))
    torch.cuda.synchronize()
    store_mb = (K * max(c.y.shape[0] for c in clients) * (784 * 4 + 4)) / 1e6
    log(f"[slice] data on the card in {time.perf_counter() - t0:.2f} s: "
        f"{train.x.shape[0]} train / {test.x.shape[0]} test examples, "
        f"K={K} shards of {[c.y.shape[0] for c in clients]} examples "
        f"(device store {store_mb:.0f} MB), MLP "
        f"{sum(p.numel() for layer in params for p in layer.values())} "
        f"params")

    cfg = SimConfig(rounds=T, local_iters=5, batch_size=10, eval_every=4)
    runs = [("proposed", ProposedOnline(spec), cfg),
            ("random", RandomScheme(p_bar=0.1, num_clients=K), cfg),
            ("proposed-staleness3", ProposedOnline(spec),
             dataclasses.replace(cfg, max_staleness=3))]
    card, launches = {}, 0
    for name, policy, run_cfg in runs:
        fl_aggregate_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_simulation(params, mlp_loss, mlp_accuracy, clients, test,
                             policy, h, cell, run_cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = fl_aggregate_cuda.launches
        if n != T:
            raise AssertionError(f"{name}: K1 launched {n} times in {T} "
                                 f"rounds")
        launches += n
        if out.participation.shape != (T, K) or not all(
                np.isfinite(a).all() for a in (out.test_acc, out.test_loss,
                                               out.energy_per_client)):
            raise AssertionError(f"{name}: malformed result")
        card[name] = out
        log(f"[slice] {name:20s} card: final_acc={out.test_acc[-1]:.4f} "
            f"final_loss={out.test_loss[-1]:.4f} "
            f"energy={out.energy_per_client.sum():.4f} J "
            f"uploads={int(out.participation.sum())} wall={wall:.2f} s "
            f"K1 launches={n} (= T)")

    # the proposed scheme's (P1') solve of every round, alone and warm: how
    # much of a proposed run it takes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs, _ = ProposedOnline(spec).policy_fn(None, h.T, None)
    torch.cuda.synchronize()
    log(f"[slice] (P1') solve of all {T} rounds alone on the card: "
        f"{time.perf_counter() - t0:.2f} s (mean p = "
        f"{float(probs.mean()):.4f})")

    def cpu(ds):
        return Dataset(ds.x.cpu(), ds.y.cpu(), ds.num_classes)

    c_clients, c_test = [cpu(c) for c in clients], cpu(test)
    c_params = [{k: v.cpu() for k, v in layer.items()} for layer in params]
    for name, policy, run_cfg in runs:
        t0 = time.perf_counter()
        ref = run_simulation(c_params, mlp_loss, mlp_accuracy, c_clients,
                             c_test, policy, h.cpu(), cell, run_cfg,
                             device="cpu")
        wall = time.perf_counter() - t0
        got = card[name]
        np.testing.assert_array_equal(got.participation, ref.participation)
        worst = 0.0
        for field in ("energy_per_client", "energy_timeline", "test_acc",
                      "test_loss"):
            a, b = getattr(got, field), getattr(ref, field)
            np.testing.assert_allclose(a, b, rtol=SLICE_RTOL,
                                       atol=SLICE_ATOL, err_msg=field)
            worst = max(worst, float(np.max(np.abs(a - b)
                                            / (SLICE_ATOL + SLICE_RTOL
                                               * np.abs(b)))))
        log(f"[slice] {name:20s} cpu: masks equal bit for bit; energy, acc, "
            f"loss within rtol {SLICE_RTOL} atol {SLICE_ATOL} (worst "
            f"{worst:.3f} of the tolerance); cpu wall={wall:.2f} s")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    smi = environment(torch)
    bandwidth, bw_name = card_bandwidth(torch.cuda.get_device_name(0))
    log(f"[env] bound uses {bw_name} device memory, {FP32_PEAK / 1e12:.0f} "
        f"TFLOP/s fp32")
    max_err = check_kernel(torch)
    timing = time_kernel(torch, bandwidth)
    launches = slice_runs(torch)
    main_row = timing[(K, MAIN_M)]
    kernels = {"kernels": [{
        "name": "fl_aggregate",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fl_aggregate.cu",
        "replaces": "src/repro/kernels/fl_aggregate.py:43",
        "launches": launches,
        "max_abs_err": max_err,
        **main_row,
    }]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all; timings at "
        f"R={K}, M={MAIN_M} fp32 on {smi}")
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
