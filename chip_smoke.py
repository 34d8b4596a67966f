#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reporting on its own lines:

1. environment — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, the precision settings, and the ``nvcc`` builds of K1, K2,
   K3 and ``mlp_sgd``, all four at once (from
   ``src/repro_torch/kernels/csrc``, into ``kernels/_build``), with ptxas's
   registers and spills;
2. kernel — K1 (``fl_aggregate``) in all three modes, float32 and bfloat16,
   R ∈ {1, 7, 8, 10, 11, 12, 16, 64, 65, 100, 1000} rows (directly loaded
   rows, the ring, partial stages, the main path's R), M ∈ {77, 8193, 159012, 199210, 600001}
   (narrow, misaligned rows, several tiles a block), aligned and misaligned
   views, against its plain PyTorch version on the card; NaN/Inf with the
   guard on and off at R 4 and 64; two launches bit-equal; then CUDA-event
   timings of the kernel and ``torch.addmv`` (with the mode's folded
   weights) with the L2 dirty, clean and warm (``time_ms``), and of the
   plain version: plain mode at R 10, 64, 100 and 1000 (M 159,012), R 10
   and 100 (M 199,210), bf16 R 100 and the CNN's R 10 × M 620,364; subset
   mode at the serve buckets R 8, 16, 32 and 64 and weighted mode at R 10
   and 64 (M 159,012) — beside the bandwidth bound and the time of a
   trivial launch; the launch plans the design rejected, timed beside the
   one it takes; the wrapper's host time a call;
2b. the MLP's local-SGD kernel (``mlp_sgd``) at the main path's shapes:
   R 10,000 (the dense cell's K) and 2,048 (the sparse cell's bucket) rows
   × L 5 × B 10 of the 784-200-10 MLP, held against its plain version
   (rtol 1e-4, atol 1e-5, padding bit-equal) on inputs with a margin at
   relu's kink, the rows beyond it counted on the paper's inputs, and two
   launches bit-equal;
   then its CUDA-event time with the L2 flushed (median), beside its
   bound (bytes: each row read and written once plus the batches; FMAs:
   the forward, dh and the weight gradients) and the plain version's;
3. slice — the quickstart simulation at full width and data scale (K = 10,
   the 784-200-10 MLP, 60,000/10,000 MNIST-like examples, non-IID d = 5,
   T = 12 rounds of 5 local steps of batch 10, ρ = 0.05, λ = 0.01) for
   ProposedOnline, RandomScheme(p̄ = 0.1) and ProposedOnline with Δ = 3; each
   run must launch K1 exactly once per round; then the same runs on the CPU
   from the same data and initial params: masks equal bit for bit, energy,
   accuracy and loss within rtol 1e-4, atol 1e-5;
3b. the comparison panel — the paper's schemes on phase 3's data and
   params: offline Algorithm 1 solved on the card (timed alone, its outer
   iterations printed) and on the CPU (p and w within rtol 1e-4, atol 1e-5,
   the objective within rtol 1e-4); k matched to the online scheme's mean
   participation (phase 3's (P1') solve); then ProposedOffline,
   GreedyScheme(k) and AgeBasedScheme(k) with no aggregator,
   CsmaScheme(k) + csmaafl, AgeAwareScheme(k) + age, RandomScheme(mean/K) +
   fedasync (poly) with a norm clip, and ProposedOnline with quarantine and
   staleness down-weighting.  Each run launches K1 once a round, in its
   weighted mode for the last four (the per-mode count says so), and is
   held against the same run on the CPU as in phase 3;
3c. the sparse two-phase engine — (a) phase 3's world with
   ``local_mode="participants"`` and the per-client stream: RandomScheme
   (p̄ = 0.1; phase A's full hoist), phase 3's (P1') solve replayed with
   Δ = 3 (the round-by-round path with forcing) and AgeAwareScheme(1) with
   the age aggregator and quarantine (a ledger policy; K1's weighted mode),
   each run sparse and dense on the card and on the CPU: masks, ``last_tx``
   and eval rounds equal, energy, accuracy, loss and the final model within
   rtol 1e-4, atol 1e-5, card against CPU and sparse against dense; the
   sparse runs launch K1 once a round in its subset mode (the first two) or
   its weighted mode; (b) the population sweep of
   ``benchmarks/bench_sparse.py`` with the paper's MLP: stores of K = 10³,
   10⁴, 10⁵ and 10⁶ clients × 8 examples of 784 float32 built on the card
   from a seeded generator (25.1 GB at 10⁶), RandomScheme(16/K), bucket 64,
   T = 20 rounds of 5 steps of batch 10; each run twice, the warm one
   printing wall time, ms a round, the ``sparse.phase_a`` / ``sparse.train``
   spans, transmitters a round and K1's 20 subset launches at R 64; a dense
   baseline at K = 10³ held against the sparse run; the participant gather
   alone at 10⁶; K = 10⁵ held against the same run on the CPU; phase B
   built once for the whole sweep;
3d. faults and the matrix sweeps, each on the card against the same run
   on the CPU (masks, deliveries, corruptions and ``last_tx`` bit for bit,
   floats within rtol 1e-4, atol 1e-5, NaN in the same places): (a) phase
   3's world under benchmarks/bench_faults.py's fault cocktail with
   RandomScheme(0.5): dense unguarded NaN, dense guarded NaN, Inf and
   ×100 uploads, and guarded and unguarded NaN on the sparse path
   (participants mode, bucket 8) against the dense one; every run must
   corrupt a delivery, and K1 must reduce real non-finite rows in its
   plain, subset and weighted modes (counted by rows, by weight); (b)
   ``run_fault_matrix`` over bench_faults.py's rates 0–1 (guarded all
   finite, unguarded finite at rate 0, delivered mass falling with the
   rate); (c) ``run_scheme_matrix`` at benchmarks/fig6_7_schemes.py's
   fig6_k10 setting (K 10, 5,000 examples, severities d = 2 and 5, T 16,
   seeds 0 and 1, the matched 5-scheme panel: 20 lanes), dense and sparse
   on the card (sparse = dense; phase B built once; a lane = a single run)
   and dense on the CPU; (d) ``run_seed_matrix`` for the three baselines on
   3 seed lanes and ``run_scenario_matrix`` over ρ 0.01, 0.05, 0.2 on one
   lane, at benchmarks/bench_engine.py's K 10 setting;
3e. the data paths and resumable runs: (a) benchmarks/bench_data.py's
   world, nothing cut (K 16, 8,000/1,000 examples, d 5, RandomScheme(0.15),
   B 10, eval_batch 512, eval_every T/4, stream_chunk max(T/8, 16)) on the
   prestack, device and stream paths at T 50 (L 5) and T 500 (L 1), cold
   then warm, and at T 1000 (L 1; cut from 2000 for phase 9's time) once,
   on the device and stream paths
   only (the prestack run is cut for time): prep, cold and warm seconds and the
   device-resident data bytes (``torch.cuda.memory_allocated`` around the
   data; the device store's flat across T, the stream's two chunks); stream
   = device bit for bit (masks, energy, the global row, acc, loss),
   prestack masks = device masks, and at T 50 card = CPU on all three
   paths; a warm T 8, L 1 run on the device and stream paths and the
   device path's index draw alone under ``torch.profiler`` (wall, device
   busy and events a round); (b) ``choose_data_path`` with the card's own budget (bench_data's
   store and the 10⁶-client store of phase 3c resolve to the device, an
   estimate over half the card's memory to the stream, with no
   allocation) and ``make_runner(data_path="auto")`` under a budget below
   the store: the stream runner, equal to the device runner bit for bit;
   (c) phase 3d (a)'s guarded faulty world, ``checkpoint_every`` 3:
   ``run_resumable`` = ``make_runner``, killed after 2 segments and
   resumed = uninterrupted (deliveries, fault state, K1's weighted
   launches), ``eval_mode="replay"`` boundary evals = the in-loop ones at
   the same rounds, a fingerprint mismatch raises; (d) quickstart random
   runs with ``momentum`` and ``adam``, card = CPU (Adam's model after one
   round at the slice tolerance and after 4 rounds by a relative L2 limit
   between one-ulp nudges and planted faults), and ``shard_store`` (60,000
   examples, K 10, d 5) and ``dirichlet_store`` (K 100, α 0.3), card = CPU
   bit for bit, each timed;
3f. observability and the legacy host loop: (a) phase 3's world under
   phase 3d (a)'s fault cocktail, the guards and the fedasync aggregator
   with every metrics tap on, on the dense engine, the legacy loop and the
   sparse engine (participants mode, the per-client stream): tapped =
   untapped bit for bit on each path, integer taps equal across the paths,
   card = CPU (masks, deliveries, ``last_tx`` and integer taps bit for
   bit; floats, float taps and the model within rtol 1e-4, atol 1e-5);
   (b) tests/golden/harness.py's 15 scheme × path traces, card = CPU under
   its ``compare_traces`` rule (mask sha256, the eval grid, loss, accuracy
   and the energy timeline within rtol 1e-4, atol 1e-5), the three paths'
   masks equal; (c) benchmarks/bench_obs.py's world with the paper's MLP
   (dense K 128, sparse K 4,096, E 6, T 40, L 2, B 4): warm ms a round
   untapped and tapped and their ratio beside JAX's CPU bound of 1.10 (a
   finding, not a gate), and the legacy loop's ms a round beside the
   dense runner's on the quickstart world; (d) every manifest valid,
   ``python -m repro_torch.obs.report --validate --summary`` on a
   ``runs.jsonl`` written under a temporary ``REPRO_OBS_DIR``, one tapped
   round under ``maybe_profile`` leaving a trace, ``memory_snapshot`` and
   ``timed_compile`` on the card;
3g. the entry points, the CNN and the serve front door, each card run held
   against the same run on the CPU (masks, ``last_tx`` and decision logs
   bit for bit, floats within rtol 1e-4, atol 1e-5, but for two models
   that local SGD's chaos moves further: the train CLI's after 30 rounds
   is measured, and the CNN's after 12 rounds held to a relative L2 of
   1e-2 beside the CPU's own one-ulp nudge): (a)
   ``examples/quickstart_torch.main`` as the JAX script runs it;
   ``launch.train.main`` at its defaults (K 10, 5,000 examples, d 5, T 30)
   with ``--scheme random`` and ``proposed``, each ``--ckpt`` written and
   loaded back; ``examples/mnist_fl_schemes_torch.main --rounds 12`` (cut
   from 200 for time: each proposed round is a (P1') solve); (b) the CNN
   at the paper's data scale: ``make_cifar_like``'s defaults (50,000 /
   10,000 × 3,072 float32 on the card), K 10, d 5, ``init_cnn``'s default
   widths (620,362 params), T 12 × L 5 × B 10 under RandomScheme(0.1) and
   ProposedOnline, K1 plain once a round at R 10 × M 620,364, a warm round
   timed; (c) benchmarks/bench_serve.py's --quick setting with the
   paper's MLP for its dim-16 model (K 1,000 clients × 8 examples of dim
   784, ``ServeConfig(max_batch=64, min_bucket=8, flush_interval_s=0.002,
   queue_capacity=256, policy_refresh_min_interval_s=2.0)``, the online
   policy at ρ 0.05 on 64 rounds of gains; cut from its full K 4,000,
   2,000 uploads and 8 workers, which took 312.4 s): warm 64-row flushes
   timed, a client step timed alone, then the ``throughput`` and
   ``paper`` load modes, 200 uploads (cut from 500 for phase 9's time)
   on 4 workers after a warm-up burst
   of 128, uploads/s, admission p50/p95,
   occupancy, the ``serve.flush`` and ``serve.policy_refresh`` spans, K1's
   subset launches by bucket and ``verify_replay`` on each session; then
   tests/test_serve.py's manual sessions (plain; guards with csmaafl, K1's
   weighted mode) on the card and the CPU with the same uploads: equal
   decision logs and ledgers, models within tolerance; then every (mode,
   dtype, R, M) that phases 3 to 3g gave K1 is held against the plain
   version (by phase 2's sweep, or checked there and then);
4. attention kernel — K2 (``flash_attention``) against its plain version on
   the card: the sweeps of tests/test_kernels.py (MHA, GQA 2:1 and 4:1,
   MQA, hd 64 and 128), windows 1 to 128, ``causal=False``, ragged S (1,
   77, 129, 200, 1000), G = 8, more work items than blocks, q/k/v as views
   of one fused buffer, float32 and bfloat16, the first token attending
   only to itself, and the slices' own shapes (B 4, S 1024, H 32, KV 8, hd
   64 and H 64, KV 8, hd 128, bf16); then CUDA-event timings (L2 flushed)
   of the kernel, the plain version and ``scaled_dot_product_attention`` at
   B 4 × S 1024, B 1 × S 4096 and B 1 × S 32,768 (hd 64) and at Jamba's
   B 4 × S 1024 (hd 128), beside the bound, and the wrapper's host time a
   call (bf16 encodes its TMA tensor maps; float32 has none);
5. LLM slice — (a) ``llama3.2-1b`` at full width and depth in bfloat16
   through ``repro_torch.launch.generate.main`` (batch 4, prompt 1024, 32
   new tokens): K2 must launch once per layer of the prefill (16); init,
   prefill and per-token decode times and peak memory; (b) on the card, at
   full width and depth, prefill(t[:1024]) then 31 decode steps must
   reproduce forward(t) at S = 1056: in float32 to tests/test_models.py's
   tolerances, in bfloat16 to 0.1 (bf16 rounding: the run also measures
   the gap with decode rounded as forward rounds, with K2's plain version
   in forward, and between two correct forwards); then a torch.profiler
   window over a prefill and over 8 decode steps;
   (c) full width at depth 2 in float32: greedy tokens on the card equal
   the CPU's from the same weights, logits within rtol 1e-4, atol 1e-4;
6. scan kernel — K3 (``selective_scan``) against its plain version on the
   card, y and the final state: the sweeps of tests/test_kernels.py in
   float32 and bfloat16, ragged S and d, N 8 and 16, S over many staged
   chunks, every x/dt dtype mix, the model's bf16 x with fp32 dt and
   strided B, C, and the
   slice's shape (B 4, S 1024, d 16,384, N 16); then CUDA-event timings (L2
   flushed) of the kernel and the plain version at B 4 × S 1024, B 1 × S
   4096 and B 1 × S 32,768, beside the bound (the SFU's exponentials, the
   bytes, the fp32 flop);
7. Jamba slice — (a) one 8-layer period of ``jamba-1.5-large-398b`` at full
   width without experts (depth 72 → 8, every layer's FFN the dense SwiGLU)
   in bfloat16 through ``repro_torch.launch.generate.generate`` (batch 4,
   prompt 1024, 32 new tokens): K3 must launch once per Mamba layer of the
   prefill (7) and K2 once (the attention layer); init, prefill and
   per-token decode times and peak memory; (b) prefill(t[:1024]) then 31
   decode steps against forward(t) at S = 1056, in bfloat16 beside two
   measured distances between correct bf16 forwards, then a torch.profiler
   window over a prefill and 8 decode steps; and in float32 (36 GB) at
   tests/test_models.py's tolerances;
8. card against CPU — reduced Jamba (the whole published plan, MoE with 4
   experts) in float32: greedy tokens on the card equal the CPU's, logits
   within rtol 1e-4, atol 5e-5;
9. training — (a) ``xlstm-125m`` at full width and depth (12 layers
   mLSTM/sLSTM, d 768, vocab 50,304, 116,260,608 params) in bf16: generation
   through ``launch.generate.generate`` (batch 4, prompt 1024, 32 new
   tokens; prefill, ms a token, peak memory), one mLSTM and one sLSTM layer
   alone, then 3 FL rounds through ``launch.train --arch xlstm-125m`` (K 4,
   B 2, S 64; K1 twice a round, the bf16 and float32 rows); (b)
   ``llama3.2-1b`` at full width and depth in bf16 (1,235,814,400 params)
   through ``launch.train --arch llama3.2-1b`` (K 4, B 2, S 64, 3 rounds,
   replica mode): K2 in the forward of every local step (192 launches), K1
   once a round at R 4 × M 1,235,814,400 (R·M past 2³²), held against its
   plain version on the round's own inputs (column slices) and timed beside
   ``torch.addmv`` and its bound; (c) every reduced configuration in
   float32, the card against the CPU from the same state and batch: loss and
   gradients, one replica round (2 local steps) and one masked-dp round,
   with K2 and K3 under autograd through their custom ops; then those ops'
   gradients against the plain versions' autograd on the same inputs and
   the recompute backward's cost (K2 at B 2 × S 64 and 1024, K3 at S 16 and
   64);
10. launch layer — the dry run's one-rank prediction of Llama-3.2-1B's
   prefill, decode and training round against the same programs on the
   card, and four dry runs on fabricated worlds (``launch_layer``);
11. client placement — the dense engine's client axis over 4 virtual
   blocks of the card against the unplaced run at K 1,000 (the MLP at full
   width, the device path, a random and an age-aware guarded run; eq. 3 =
   4 K1 launches a round, subset or weighted mode), ms a round of both, and
   with two or more cards ``make_runner``'s default over them
   (``client_placement``).

Float32 products run in full float32 on the card: TF32 is switched off for
both cuBLAS matmuls and cuDNN, so card-against-CPU differences are summation
order only.  Any failed check raises and the script exits non-zero; with no
CUDA card, or without the rest of the repository beside it, it exits
non-zero before printing any result.  The last line is the one JSON object
``{"ok": true, "device": {...}}``; the line before it lists the kernels
(K1, K2, K3 and ``mlp_local_sgd``, the last with its launches in
phases 3 and 3b, counted from zero before each run and held to one a
round, and phase 2b's times at R 10,000 and, under ``bucket_2048``, at
R 2,048), each with its launches on its main path
(phases 3 to 3g
for K1, also counted by mode: plain, subset and weighted, and phase 3g's
alone by mode, with the
non-finite rows phase 3d's faulty runs reduced; the generate
run of phase 5a for K2, that of phase 7a for K3) and its times at the main
path's shape, and under ``phase_9`` its launches on the training paths
(K1 also its times at the Llama round's shape; K2 and K3 the recompute
backward's), under ``phase_10`` the launch layer's and, for K1, under
``phase_11`` the placed and unplaced runs' launches by mode.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),     # tests/test_kernels.py
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-5               # tests/golden/harness.py
K, T = 10, 12
MAIN_M = 159_012   # the MLP's 159,010 params + 2 zero columns (ParamLayout)


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
BF16_PEAK = 989e12  # H100 SXM bf16 tensor cores, dense, flop/s


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
    import importlib
    modules = tuple(importlib.import_module(f"repro_torch.kernels.{name}")
                    for name in ("fl_aggregate", "flash_attention",
                                 "selective_scan", "mlp_sgd"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        libs = list(pool.map(lambda module: module.library(), modules))
    for module, lib in zip(modules, libs):
        log(f"[env] {module.__name__.rsplit('.', 1)[1]} built in "
            f"{lib.seconds:.2f} s (nvcc): {lib.path.name}")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[ptxas] {line.strip()}")
    log(f"[env] kernels ready after {time.perf_counter() - t0:.2f} s")
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


def check_case(torch, mode, dname, R, M, offset, gen) -> float:
    """One K1 launch against its plain version on the same inputs; returns
    max |kernel - plain|."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda
    dtype = getattr(torch, dname)
    g, d, mask, w = kernel_inputs(torch, R, M, dtype, gen, offset)
    before = fl_aggregate_cuda.launches
    out = run_mode(ops, ref, mode, g, d, mask, w, True)
    want = run_mode(ops, ref, mode, g, d, mask, w, False)
    torch.cuda.synchronize()
    if fl_aggregate_cuda.launches != before + 1:
        raise AssertionError("kernel did not launch")
    if out.dtype != dtype or out.shape != (M,):
        raise AssertionError(f"bad output {out.dtype} {tuple(out.shape)}")
    err = float((out.float() - want.float()).abs().max())
    torch.testing.assert_close(out.float(), want.float(), **TOL[dname])
    return err


def check_kernel(torch):
    """Phase 2; returns K1's worst error at the slice's shape and the
    ``(mode, dtype, R, M)`` cases it held."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    worst = {}
    checked = set()
    main_err = 0.0
    n = 0
    # R: 1 to 11 load every row directly, 12 and up go through the ring in
    # stages of 10 (fp32) or 16 (bf16) rows, so 12, 16 (fp32), 65 and 1000
    # end in a partial stage; 8, 10, 16 and 64 are the main path's buckets
    # and populations; M: 77 and 8193 are narrower than one tile a block,
    # 199,210 leaves every other row 8 bytes off 16, 600,001 gives each
    # block three tiles; offset 1 misaligns every operand
    for mode in ("plain", "subset", "guarded"):
        for dname in dtypes:
            for R in (1, 7, 8, 10, 11, 12, 16, 64, 65, 100, 1000):
                for M in (77, 8193, MAIN_M, 199_210, 600_001):
                    for offset in (0, 1):
                        err = check_case(torch, mode, dname, R, M, offset,
                                         gen)
                        checked.add((mode, dname, R, M))
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

    # NaN/Inf: the guard quarantines, its absence propagates; R = 4 loads
    # its rows directly, R = 64 streams them through the ring
    for dname, dtype in dtypes.items():
        for R in (4, 64):
            for M in (77, 8193, MAIN_M):
                g, d, _, _ = kernel_inputs(torch, R, M, dtype, gen)
                d[1] = torch.nan
                d[2, 0] = torch.inf
                d[3, -1] = -torch.inf
                w = torch.zeros(R, device="cuda")
                w[0::2] = 1.0 / R
                out = ops.fl_aggregate_guarded(g, d, w)
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError("guard let a non-finite value "
                                         "through")
                torch.testing.assert_close(
                    out.float(), ref.fl_aggregate_guarded_ref(g, d, w).float(),
                    **TOL[dname])
                mask = torch.zeros(R, device="cuda")
                mask[0] = 1.0
                plain = ops.fl_aggregate(g, d, mask)
                if not bool(torch.isnan(plain).all()):
                    raise AssertionError("guard off: NaN row with mask 0 did "
                                         "not propagate")
    log("[kernel] NaN/Inf at R 4 and 64: guard on -> finite and equal to the "
        "plain version; guard off -> NaN propagates through a zero mask "
        "(fp32, bf16)")

    # determinism: two launches on the same inputs give the same bits
    cases = [("plain", "float32", K, MAIN_M, 0),
             ("plain", "float32", 1000, MAIN_M, 0),
             ("guarded", "float32", 64, MAIN_M, 0),
             ("subset", "bfloat16", 65, 199_210, 1),
             ("plain", "bfloat16", 7, 600_001, 1)]
    for mode, dname, R, M, offset in cases:
        g, d, mask, w = kernel_inputs(torch, R, M, dtypes[dname], gen, offset)
        first = run_mode(ops, ref, mode, g, d, mask, w, True)
        second = run_mode(ops, ref, mode, g, d, mask, w, True)
        if not torch.equal(first, second):
            raise AssertionError(f"two launches differ: {mode} {dname} R={R} "
                                 f"M={M} offset={offset}")
    log(f"[kernel] deterministic: two launches bit-equal in {len(cases)} "
        f"cases (R 7 to 1000, direct and ring, fp32 and bf16, misaligned)")
    return main_err, checked


# ---------------------------------------------------------------------------
# phase 2b
# ---------------------------------------------------------------------------

# (R, L, B): the dense cell's K 10,000 and the sparse cell's 2,048-row
# bucket, 5 local steps of batch 10
MLP_SGD_SHAPES = ((10_000, 5, 10), (2_048, 5, 10))


def mlp_sgd_bound(R, L, B, bandwidth, dims=(784, 200, 10), W=MAIN_M):
    """The least time (ms) of R rows' L local steps: ``(bytes_ms, ops_ms)``.
    Bytes: each row read once and written once, the batches (inputs and
    labels) read once.  Operations: 2 FLOPs an FMA of the forward (x.W1,
    h.W2), dh and the two weight gradients."""
    D, H, C = dims
    nbytes = 2 * R * W * 4 + R * L * B * (D + 1) * 4
    fmas = R * L * B * (2 * D * H + 3 * H * C)
    return nbytes / bandwidth * 1e3, 2 * fmas / FP32_PEAK * 1e3


def mlp_sgd_inputs(torch, gen, params, layout, R, L, B, margin):
    """Rows near ``params`` with padding 7.25 and a step's batches; with
    ``margin`` b1 is +1 and -1 in turn and the inputs 0.1 N(0, 1), so every
    pre-activation is 7 sigma from relu's kink (tests/test_torch_cuda.py:
    sgd_inputs)."""
    first = layout.flatten(params)
    if margin:
        first[:200] = 1.0 - 2.0 * (torch.arange(200, device="cuda") % 2)
    rows = first.expand(R, -1) + 0.01 * torch.randn(
        R, layout.width, generator=gen, device="cuda")
    rows[:, layout.size:] = 7.25
    xb = torch.randn(R, L, B, 784, generator=gen, device="cuda")
    if margin:
        xb *= 0.1
    yb = torch.randint(0, 10, (R, L, B), generator=gen, device="cuda",
                       dtype=torch.int32)
    return rows, xb, yb


def time_mlp_sgd(torch, bandwidth):
    """Phase 2b; returns each shape's numbers, by ``(R, L, B)``.  The
    kernel is held against its plain version on inputs with a margin at
    relu's kink (every element within tolerance); on the paper's inputs,
    where a few of the R·L·B·200 pre-activations land within rounding of 0
    and the two may take relu's two sides once their last bits part, the
    rows beyond the tolerance are counted (the kernel's rows are
    autograd's bit for bit: tests/test_torch_cuda.py)."""
    from repro_torch import random as jr
    from repro_torch.fl.state import ParamLayout
    from repro_torch.kernels import ref
    from repro_torch.kernels.mlp_sgd import launch_plan, mlp_local_sgd_cuda
    from repro_torch.models.small import init_mlp
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_mlp(jr.PRNGKey(0), device="cuda")
    layout = ParamLayout.of(params)
    flush = torch.empty(64 * 2**20 // 4, device="cuda")   # > the 50 MB L2
    lr = 0.01
    out = {}
    for R, L, B in MLP_SGD_SHAPES:
        for margin in (True, False):
            rows, xb, yb = mlp_sgd_inputs(torch, gen, params, layout, R, L,
                                          B, margin)
            got = mlp_local_sgd_cuda(rows, xb, yb, lr, layout)
            want = ref.mlp_local_sgd_ref(rows, xb, yb, lr, layout)
            err = float((got - want).abs().max())
            beyond = int((~torch.isclose(got, want, rtol=1e-4, atol=1e-5))
                         .any(1).sum())
            if (margin and beyond) or not torch.equal(
                    got[:, layout.size:], rows[:, layout.size:]):
                raise AssertionError(f"mlp_sgd differs from its plain "
                                     f"version at R {R}: max |diff| "
                                     f"{err:.3e} in {beyond} rows")
            if not torch.equal(got, mlp_local_sgd_cuda(rows, xb, yb, lr,
                                                       layout)):
                raise AssertionError(f"two mlp_sgd launches differ at R {R}")
            del got, want
            log(f"[mlp-sgd] R {R} x L {L} x B {B}, "
                f"{'inputs with a margin' if margin else 'the paper inputs'}"
                f": max |kernel - plain| {err:.3e}, rows beyond rtol 1e-4 / "
                f"atol 1e-5: {beyond} of {R}; two launches bit-equal")
        kernel_ms = time_ms(torch, lambda: mlp_local_sgd_cuda(
            rows, xb, yb, lr, layout), flush, iters=10, warmup=2)
        plain_ms = time_ms(torch, lambda: ref.mlp_local_sgd_ref(
            rows, xb, yb, lr, layout), flush, iters=3, warmup=1)
        bytes_ms, ops_ms = mlp_sgd_bound(R, L, B, bandwidth)
        bound_ms = max(bytes_ms, ops_ms)
        plan = launch_plan(B, 784, 200, 10, layout.width)
        log(f"[mlp-sgd] R {R} x L {L} x B {B} (784-200-10): kernel "
            f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms (bytes {bytes_ms:.4f}, FMA {ops_ms:.4f}), "
            f"{100 * bound_ms / kernel_ms:.1f} % of it; plan {plan}")
        out[(R, L, B)] = {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bytes_ms": bytes_ms,
                          "ops_ms": ops_ms, "max_abs_err": err}
        del rows, xb, yb
        torch.cuda.empty_cache()
    return out


def check_main_shapes(torch, checked) -> None:
    """Every ``(mode, dtype, R, M)`` the main path (phases 3 to 3g) gave K1
    is held against the plain version: the shapes phase 2 did not sweep
    are checked here, at both alignments, on fresh inputs."""
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1
    seen = set(k1.shapes)
    extra = sorted(seen - checked)
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for mode, dname, R, M in extra:
        for offset in (0, 1):
            worst = max(worst, check_case(torch, mode, dname, R, M, offset,
                                          gen))
    names = ", ".join(f"{m} {d} R {r} M {c}" for m, d, r, c in sorted(seen))
    log(f"[kernel] the main path gave K1 {len(seen)} shapes ({names}); "
        f"{len(seen) - len(extra)} held in phase 2, {len(extra)} held now "
        f"(worst |kernel - plain| {worst:.3e})")


def time_ms(torch, fn, flush, iters=100, warmup=5, l2="dirty"):
    """Median per-call time in ms from CUDA events.  ``l2`` says what the
    50 MB L2 holds when a call starts: "dirty" (``flush.zero_()`` before
    each call: another buffer's written lines, which the call pays to write
    back; phases 4 and 6 and PR 14's K1 times), "clean" (``flush.sum()``:
    another buffer's clean lines, so the call pays for its own bytes only)
    or "warm" (no flush: the operands stay where the previous call left
    them, as the main path's pseudo-gradients do; the card sleeps first so
    that the host has queued every call before the first one runs)."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    if l2 == "warm":
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
    for s, e in zip(starts, ends):
        if l2 == "dirty":
            flush.zero_()
        elif l2 == "clean":
            flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


L2_MODES = ("dirty", "clean", "warm")
CNN_M = 620_364    # the CNN's 620,362 params + 2 zero columns (ParamLayout)
# K1's timed (mode, R, M, dtype): plain at the dense main path's R 10 (the
# MLP and the CNN), the sparse bucket R 64, R 100 and the dense R 1000;
# subset at the serve buckets R 8-64; weighted at R 10 (the panel, guards)
# and R 64 (a guarded or scheme serve flush); M 199,210 and bf16 beside
TIMED_SHAPES = (
    ("plain", K, MAIN_M, "float32"), ("plain", 64, MAIN_M, "float32"),
    ("plain", 100, MAIN_M, "float32"), ("plain", 1000, MAIN_M, "float32"),
    ("plain", K, 199_210, "float32"), ("plain", 100, 199_210, "float32"),
    ("plain", 100, MAIN_M, "bfloat16"), ("plain", K, CNN_M, "float32"),
    ("subset", 8, MAIN_M, "float32"), ("subset", 16, MAIN_M, "float32"),
    ("subset", 32, MAIN_M, "float32"), ("subset", 64, MAIN_M, "float32"),
    ("guarded", K, MAIN_M, "float32"), ("guarded", 64, MAIN_M, "float32"))


def time_kernel(torch, bandwidth):
    import importlib
    k1 = importlib.import_module("repro_torch.kernels.fl_aggregate")
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(256 * 2**20 // 4, device="cuda")   # 256 MB > L2
    tiny = torch.empty(1, device="cuda")
    floor = {l2: time_ms(torch, tiny.zero_, flush, l2=l2) for l2 in L2_MODES}
    log("[kernel-time] floor: a 4-byte zero_() between its events takes "
        + ", ".join(f"{floor[l2]:.4f} ms ({l2})" for l2 in L2_MODES))
    rows = {}
    for mode, R, M, dname in TIMED_SHAPES:
        dtype = getattr(torch, dname)
        g, d, mask, w = kernel_inputs(torch, R, M, dtype, gen)
        # the one addmv call with the mode's folded weight vector (the
        # guard's zeroing of non-finite elements has no library form; these
        # inputs are finite)
        lw = {"plain": mask / R, "subset": mask / (3 * R),
              "guarded": w}[mode].to(dtype)
        lib = torch.addmv(g, d.T, lw)
        torch.testing.assert_close(
            lib.float(), run_mode(ops, ref, mode, g, d, mask, w,
                                  False).float(), **TOL[dname])
        iters = 30 if R == 1000 else 100
        t_kernel, t_lib = {}, {}
        for l2 in L2_MODES:
            t_kernel[l2] = time_ms(torch, lambda: run_mode(
                ops, ref, mode, g, d, mask, w, True), flush, iters, l2=l2)
            t_lib[l2] = time_ms(torch, lambda: torch.addmv(g, d.T, lw),
                                flush, iters, l2=l2)
        t_plain = time_ms(torch, lambda: run_mode(ops, ref, mode, g, d, mask,
                                                  w, False), flush, iters)
        elem = g.element_size()
        nbytes = (R * M + 2 * M) * elem + R * 4
        t_bytes = nbytes / bandwidth * 1e3
        t_ops = 2 * R * M / FP32_PEAK * 1e3
        bound = max(t_bytes, t_ops)
        rows[(mode, R, M, dname)] = dict(
            ms=t_kernel["dirty"], plain_ms=t_plain,
            library_ms=t_lib["dirty"], bound_ms=bound,
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        plan = k1.launch_plan(
            R, M, elem, torch.cuda.get_device_properties(0).multi_processor_count)
        path = (f"direct {plan.direct} rows" if plan.direct == R else
                f"ring {plan.stages} x {plan.rows} rows")
        log(f"[kernel-time] {mode} R={R} M={M} {dname} ({path}, bound "
            f"{bound:.4f} ms "
            f"= {nbytes / 1e6:.2f} MB): kernel "
            + ", ".join(f"{t_kernel[l2]:.4f}" for l2 in L2_MODES)
            + " ms; torch.addmv "
            + ", ".join(f"{t_lib[l2]:.4f}" for l2 in L2_MODES)
            + f" ms (L2 {'/'.join(L2_MODES)}); plain {t_plain:.4f} ms; "
            f"kernel at {100 * bound / t_kernel['dirty']:.1f}% / "
            f"{100 * bound / t_kernel['clean']:.1f}% of the bound (dirty / "
            f"clean), {t_kernel['clean'] / t_lib['clean']:.2f}x addmv's "
            f"time (clean)")
        if mode == "plain" and (R, M, dname) in (
                (K, MAIN_M, "float32"), (100, MAIN_M, "float32"),
                (1000, MAIN_M, "float32")):
            plan_steps(torch, k1, plan, g, d, mask, flush)
        del g, d, lw, lib
    host_time_kernel(torch, gen)
    return rows


def plan_steps(torch, k1, plan, g, d, mask, flush):
    """K1 under the launch plans its design rejected, beside the plan it
    takes (L2 clean): the ring at R = 10, and at R = 100 and 1000 the first
    rows loaded directly, a deeper ring and shallower stages."""
    import dataclasses as dc
    R, M = d.shape
    w = mask.float().contiguous()
    elem = g.element_size()

    def launch(p):
        out = torch.empty_like(g)
        rc = k1.library().lib.fl_aggregate_launch(
            g.data_ptr(), d.data_ptr(), w.data_ptr(), out.data_ptr(), R, M,
            1.0 / R, 0 if elem == 4 else 1, 0, p.tile, p.tiles, p.grid,
            p.direct, p.rows, p.stages, p.slot_bytes,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fl_aggregate launch failed: CUDA error {rc}")
        return out

    want = launch(plan)
    if R <= k1.DIRECT_MAX:
        steps = [("the ring", dc.replace(plan, direct=0, rows=R, stages=2))]
    else:
        deep = max(1, (k1.MAX_SMEM - k1.RING_OFFSET)
                   // (plan.rows * plan.slot_bytes))
        steps = [(f"{k1.DIRECT_MAX} rows direct",
                  dc.replace(plan, direct=k1.DIRECT_MAX)),
                 (f"{deep} stages", dc.replace(plan, stages=deep)),
                 ("4-row stages", dc.replace(
                     plan, rows=4, stages=k1.RING_BYTES // (4 * plan.slot_bytes)))]
    parts = [f"taken {time_ms(torch, lambda: launch(plan), flush, 30, l2='clean'):.4f}"]
    for name, p in steps:
        if not torch.equal(launch(p), want):
            raise AssertionError(f"plan '{name}' changed the bits")
        parts.append(f"{name} {time_ms(torch, lambda: launch(p), flush, 30, l2='clean'):.4f}")
    log(f"[kernel-plan] R={R} M={M}: " + ", ".join(parts)
        + " ms (L2 clean; every plan gives the same bits)")


def host_time_kernel(torch, gen, calls=200):
    """The wrapper's host time per call at the main path's shape, median
    of ``calls`` calls on the host clock, each into an idle stream."""
    from repro_torch.kernels import ops
    g, d, mask, _ = kernel_inputs(torch, K, MAIN_M, torch.float32, gen)
    for _ in range(5):
        ops.fl_aggregate(g, d, mask)
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.fl_aggregate(g, d, mask)
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    log(f"[kernel-host] R={K} M={MAIN_M} fp32: wrapper host time "
        f"{statistics.median(times) * 1e6:.1f} us a call (median of {calls}; "
        f"the plan is cached, the shared-memory attribute set once)")


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
    from repro_torch.kernels.mlp_sgd import mlp_local_sgd_cuda
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
    card, launches, sgd_launches = {}, 0, 0
    for name, policy, run_cfg in runs:
        fl_aggregate_cuda.launches = 0
        mlp_local_sgd_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_simulation(params, mlp_loss, mlp_accuracy, clients, test,
                             policy, h, cell, run_cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n, m = fl_aggregate_cuda.launches, mlp_local_sgd_cuda.launches
        if n != T or m != T:
            raise AssertionError(f"{name}: K1 launched {n} times and "
                                 f"mlp_sgd {m} times in {T} rounds")
        launches += n
        sgd_launches += m
        if out.participation.shape != (T, K) or not all(
                np.isfinite(a).all() for a in (out.test_acc, out.test_loss,
                                               out.energy_per_client)):
            raise AssertionError(f"{name}: malformed result")
        card[name] = out
        log(f"[slice] {name:20s} card: final_acc={out.test_acc[-1]:.4f} "
            f"final_loss={out.test_loss[-1]:.4f} "
            f"energy={out.energy_per_client.sum():.4f} J "
            f"uploads={int(out.participation.sum())} wall={wall:.2f} s "
            f"K1 launches={n} (= T), mlp_sgd launches={m} (= T)")

    # the proposed scheme's (P1') solve of every round, alone and warm: how
    # much of a proposed run it takes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs, w = ProposedOnline(spec).policy_fn(None, h.T, None)
    torch.cuda.synchronize()
    log(f"[slice] (P1') solve of all {T} rounds alone on the card: "
        f"{time.perf_counter() - t0:.2f} s (mean p = "
        f"{float(probs.mean()):.4f})")
    world = dict(cell=cell, spec=spec, clients=clients, test=test, h=h,
                 params=params, probs=probs, w=w,
                 mlp_sgd_launches={"phase_3": sgd_launches})

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
        worst = held_to_cpu(np, card[name], ref)
        log(f"[slice] {name:20s} cpu: masks equal bit for bit; energy, acc, "
            f"loss within rtol {SLICE_RTOL} atol {SLICE_ATOL} (worst "
            f"{worst:.3f} of the tolerance); cpu wall={wall:.2f} s")
    world.update(c_clients=c_clients, c_test=c_test, c_params=c_params)
    return launches, world


def held_to_cpu(np, got, ref) -> float:
    """Masks equal bit for bit, energy, accuracy and loss within the slice
    tolerance; returns the worst float as a share of its tolerance."""
    np.testing.assert_array_equal(got.participation, ref.participation)
    worst = 0.0
    for field in ("energy_per_client", "energy_timeline", "test_acc",
                  "test_loss"):
        a, b = getattr(got, field), getattr(ref, field)
        np.testing.assert_allclose(a, b, rtol=SLICE_RTOL, atol=SLICE_ATOL,
                                   err_msg=field)
        worst = max(worst, float(np.max(np.abs(a - b)
                                        / (SLICE_ATOL + SLICE_RTOL
                                           * np.abs(b)))))
    return worst


# ---------------------------------------------------------------------------
# phase 3b
# ---------------------------------------------------------------------------

PANEL_CLIP = 0.05    # the norm clip of the guarded random run


def panel_runs(torch, world):
    """The paper's comparison panel on phase 3's data and params; returns
    K1's launches in the seven card runs, and those in its weighted
    mode."""
    import numpy as np

    from repro_torch.core import algorithm1
    from repro_torch.core.selection import (AgeAwareScheme, AgeBasedScheme,
                                            CsmaScheme, GreedyScheme,
                                            ProposedOffline, ProposedOnline,
                                            RandomScheme)
    from repro_torch.fl import (AggregatorConfig, GuardConfig, SimConfig,
                                run_simulation)
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda
    from repro_torch.kernels.mlp_sgd import mlp_local_sgd_cuda
    from repro_torch.models.small import mlp_accuracy, mlp_loss

    t_phase = time.perf_counter()
    cell, spec, h = world["cell"], world["spec"], world["h"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    offline = ProposedOffline(spec, h)                           # the card
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    res = offline.result
    t0 = time.perf_counter()
    cres = algorithm1.solve(h.cpu(), spec, device="cpu")
    cpu_s = time.perf_counter() - t0
    for field, got, want in (("p", res.p, cres.p), ("w", res.w, cres.w)):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=SLICE_RTOL, atol=SLICE_ATOL,
                                   err_msg=f"offline {field}")
    np.testing.assert_allclose(float(res.objective), float(cres.objective),
                               rtol=SLICE_RTOL, err_msg="offline objective")
    if not (torch.isfinite(res.p).all() and torch.isfinite(res.w).all()):
        raise AssertionError("offline Algorithm 1: non-finite p or w")
    log(f"[panel] offline Algorithm 1 (K={K}, T={T}) alone on the card: "
        f"{card_s:.2f} s, {int(res.iters)} outer iterations, residual "
        f"{float(res.residual):.3e}, objective {float(res.objective):.6f}; "
        f"on the CPU {cpu_s:.2f} s, {int(cres.iters)} iterations, objective "
        f"{float(cres.objective):.6f}: p, w within rtol {SLICE_RTOL} atol "
        f"{SLICE_ATOL}")

    # k matched to the online scheme (examples/mnist_fl_schemes.py), from
    # phase 3's (P1') solve of every round
    avg = float(world["probs"].sum() / T)
    k = max(1, round(avg))
    log(f"[panel] matched participation: avg={avg:.4f} clients/round, k={k}")
    cfg = SimConfig(rounds=T, local_iters=5, batch_size=10, eval_every=4)

    def with_(**kw):
        return dataclasses.replace(cfg, **kw)

    runs = [  # (name, policy, config, weighted mode)
        ("proposed-offline", offline, cfg, False),
        ("greedy", GreedyScheme(k, K), cfg, False),
        ("age", AgeBasedScheme(k, K), cfg, False),
        ("csma+csmaafl", CsmaScheme(k, K),
         with_(aggregator=AggregatorConfig(kind="csmaafl")), True),
        ("age-aware+age", AgeAwareScheme(k, K),
         with_(aggregator=AggregatorConfig(kind="age")), True),
        ("random+fedasync+clip", RandomScheme(min(avg / K, 1.0), K),
         with_(aggregator=AggregatorConfig(kind="fedasync",
                                           staleness_fn="poly"),
               guards=GuardConfig(clip_norm=PANEL_CLIP)), True),
        ("proposed+guards", ProposedOnline(spec),
         with_(guards=GuardConfig(quarantine=True, staleness_power=0.5)),
         True)]
    card, launches, weighted_launches, sgd_launches = {}, 0, 0, 0
    for name, policy, run_cfg, weighted in runs:
        fl_aggregate_cuda.launches = 0
        fl_aggregate_cuda.guarded_launches = 0
        mlp_local_sgd_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_simulation(world["params"], mlp_loss, mlp_accuracy,
                             world["clients"], world["test"], policy, h, cell,
                             run_cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n, n_w = fl_aggregate_cuda.launches, fl_aggregate_cuda.guarded_launches
        m = mlp_local_sgd_cuda.launches
        if n != T or n_w != (T if weighted else 0) or m != T:
            raise AssertionError(f"{name}: K1 launched {n} times, {n_w} in "
                                 f"its weighted mode, and mlp_sgd {m} "
                                 f"times in {T} rounds")
        launches += n
        weighted_launches += n_w
        sgd_launches += m
        if out.participation.shape != (T, K) or not all(
                np.isfinite(a).all() for a in (out.test_acc, out.test_loss,
                                               out.energy_per_client)):
            raise AssertionError(f"{name}: malformed result")
        card[name] = out
        log(f"[panel] {name:20s} card: final_acc={out.test_acc[-1]:.4f} "
            f"final_loss={out.test_loss[-1]:.4f} "
            f"energy={out.energy_per_client.sum():.4f} J "
            f"uploads={int(out.participation.sum())} wall={wall:.2f} s "
            f"K1 launches={n} (= T), weighted={n_w}, mlp_sgd launches={m} "
            f"(= T)")
    for name, policy, run_cfg, _ in runs:
        t0 = time.perf_counter()
        ref = run_simulation(world["c_params"], mlp_loss, mlp_accuracy,
                             world["c_clients"], world["c_test"], policy,
                             h.cpu(), cell, run_cfg, device="cpu")
        wall = time.perf_counter() - t0
        worst = held_to_cpu(np, card[name], ref)
        log(f"[panel] {name:20s} cpu: masks equal bit for bit; energy, acc, "
            f"loss within rtol {SLICE_RTOL} atol {SLICE_ATOL} (worst "
            f"{worst:.3f} of the tolerance); cpu wall={wall:.2f} s")
    log(f"[panel] phase 3b in {time.perf_counter() - t_phase:.1f} s")
    world["mlp_sgd_launches"]["phase_3b"] = sgd_launches
    return launches, weighted_launches


# ---------------------------------------------------------------------------
# phase 3c
# ---------------------------------------------------------------------------

SPARSE_KW = dict(local_mode="participants", data_path="device",
                 data_stream="client")
# benchmarks/bench_sparse.py's sweep, with the paper's MLP in place of its
# dim-8 stand-in: p = 16/K, so ~16 transmitters a round at every K
SWEEP_K = (1_000, 10_000, 100_000, 1_000_000)
SWEEP_CPU_K = 100_000        # the population also run on the host CPU
SWEEP_T, SWEEP_BUCKET, SWEEP_PER_CLIENT = 20, 64, 8


def held_to(np, got, ref) -> float:
    """:func:`held_to_cpu`, plus eval rounds and ``last_tx`` equal and the
    final global model within the slice tolerance."""
    worst = held_to_cpu(np, got, ref)
    np.testing.assert_array_equal(got.eval_rounds, ref.eval_rounds)
    np.testing.assert_array_equal(got.state.last_tx.cpu().numpy(),
                                  ref.state.last_tx.cpu().numpy())
    a = got.state.global_params.cpu().numpy()
    b = ref.state.global_params.cpu().numpy()
    np.testing.assert_allclose(a, b, rtol=SLICE_RTOL, atol=SLICE_ATOL,
                               err_msg="global model")
    return max(worst, float(np.max(np.abs(a - b)
                                   / (SLICE_ATOL + SLICE_RTOL * np.abs(b)))))


def k1_counts(k1):
    return k1.launches, k1.subset_launches, k1.guarded_launches


def zero_k1(k1):
    k1.launches = k1.subset_launches = k1.guarded_launches = 0


def sparse_runs(torch, world):
    """(a) phase 3's quickstart world on the sparse path, each run sparse
    and dense on the card and on the CPU; returns K1's launches in the card
    runs as (plain, subset, weighted)."""
    import types

    import numpy as np

    from repro_torch.core.selection import (AgeAwareScheme, RandomScheme,
                                            _schedule_policy)
    from repro_torch.fl import (AggregatorConfig, GuardConfig, SimConfig,
                                run_simulation)
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1
    from repro_torch.models.small import mlp_accuracy, mlp_loss

    cell, h = world["cell"], world["h"]
    # phase 3's (P1') solve of every round, replayed: the same (p, w) the
    # proposed scheme would solve for again
    proposed = _schedule_policy(types.SimpleNamespace(p=world["probs"].T,
                                                      w=world["w"].T))
    cfg = SimConfig(rounds=T, local_iters=5, batch_size=10, eval_every=4,
                    **SPARSE_KW)
    runs = [  # name, policy, config, K1's mode on the sparse path
        ("random", RandomScheme(p_bar=0.1, num_clients=K), cfg, "subset"),
        ("proposed-staleness3", proposed,
         dataclasses.replace(cfg, max_staleness=3), "subset"),
        ("age-aware+age+guards", AgeAwareScheme(1, K),
         dataclasses.replace(cfg, aggregator=AggregatorConfig(kind="age"),
                             guards=GuardConfig(quarantine=True)),
         "weighted")]
    card, total = {}, np.zeros(3, int)
    for name, policy, run_cfg, mode in runs:
        for engine in ("sparse", "dense"):
            zero_k1(k1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_simulation(
                world["params"], mlp_loss, mlp_accuracy, world["clients"],
                world["test"], policy, h, cell,
                dataclasses.replace(run_cfg, participation=engine))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = k1_counts(k1)
            sparse = engine == "sparse"
            if (out.state.client_params is None) != sparse:
                raise AssertionError(f"{name}: the {engine} engine did not run")
            want = (T, T if sparse and mode == "subset" else 0,
                    T if mode == "weighted" else 0)
            if n != want:
                raise AssertionError(f"{name} {engine}: K1 launches (all, "
                                     f"subset, weighted) {n}, not {want}")
            total += n
            card[name, engine] = out
            log(f"[sparse] {name:22s} {engine:6s} card: "
                f"final_acc={out.test_acc[-1]:.4f} "
                f"final_loss={out.test_loss[-1]:.4f} "
                f"energy={out.energy_per_client.sum():.4f} J "
                f"uploads={int(out.participation.sum())} wall={wall:.2f} s "
                f"K1 launches={n[0]} (= T), subset={n[1]}, weighted={n[2]}")
        worst = held_to(np, card[name, "sparse"], card[name, "dense"])
        log(f"[sparse] {name:22s} sparse = dense on the card: masks, "
            f"last_tx, eval rounds equal; energy, acc, loss, model within "
            f"rtol {SLICE_RTOL} atol {SLICE_ATOL} (worst {worst:.3f})")
    for name, policy, run_cfg, _ in runs:
        for engine in ("sparse", "dense"):
            t0 = time.perf_counter()
            ref = run_simulation(
                world["c_params"], mlp_loss, mlp_accuracy,
                world["c_clients"], world["c_test"], policy, h.cpu(), cell,
                dataclasses.replace(run_cfg, participation=engine),
                device="cpu")
            worst = held_to(np, card[name, engine], ref)
            log(f"[sparse] {name:22s} {engine:6s} cpu: masks, last_tx, eval "
                f"rounds equal; energy, acc, loss, model within rtol "
                f"{SLICE_RTOL} atol {SLICE_ATOL} (worst {worst:.3f}); cpu "
                f"wall={time.perf_counter() - t0:.2f} s")
    return total


def sweep_store(torch, K: int, device):
    """K clients of 8 examples of 784 float32 from a seeded generator,
    labels ``i mod 10`` for a client's example i; channel gains uniform in
    [1e-14, 1e-12)."""
    from repro_torch.data import DeviceDataStore
    gen = torch.Generator(device=device).manual_seed(K)
    n = SWEEP_PER_CLIENT
    store = DeviceDataStore(
        torch.randn(K, n, 784, generator=gen, device=device),
        (torch.arange(n, dtype=torch.int32, device=device) % 10).repeat(K, 1),
        torch.full((K,), n, dtype=torch.int32, device=device))
    h = torch.rand(K, SWEEP_T, generator=gen, device=device) \
        * (1e-12 - 1e-14) + 1e-14
    return store, h


def population_sweep(torch):
    """(b) the paper's MLP over K = 10³…10⁶ clients on the sparse path, two
    runs each (the second warm), a dense baseline at K = 10³, and the
    K = 10⁵ run held against the CPU; returns K1's launches (plain, subset,
    weighted) in the card runs."""
    import numpy as np

    from repro_torch import random as jr
    from repro_torch.core import CellConfig
    from repro_torch.core.selection import RandomScheme
    from repro_torch.data import (Dataset, DeviceDataStore, data_stream_key,
                                  gather_participant_rounds, store_bytes)
    from repro_torch.fl import SimConfig, make_runner, make_sparse_runner
    from repro_torch.fl.sparse import train_trace_count
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1
    from repro_torch.models.small import init_mlp, mlp_accuracy, mlp_loss
    from repro_torch.obs.telemetry import get_telemetry

    t_phase = time.perf_counter()
    tel = get_telemetry()
    gen = torch.Generator(device="cuda").manual_seed(99)
    test = Dataset(torch.randn(2048, 784, generator=gen, device="cuda"),
                   torch.arange(2048, dtype=torch.int32, device="cuda") % 10,
                   10)
    params = init_mlp(jr.PRNGKey(4))
    cfg = SimConfig(rounds=SWEEP_T, local_iters=5, batch_size=10,
                    eval_every=5, participant_bucket=SWEEP_BUCKET,
                    participation="sparse", **SPARSE_KW)
    builds, total = train_trace_count(), np.zeros(3, int)

    def timed(runner, h, label, expect):
        nonlocal total
        out = None
        for call in ("cold", "warm"):
            spans = {k: tuple(tel.spans.get(k, [0, 0.0, 0.0])[:2])
                     for k in ("sparse.phase_a", "sparse.train")}
            zero_k1(k1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = runner(params, h)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = k1_counts(k1)
            if n != expect:
                raise AssertionError(f"{label}: K1 launches (all, subset, "
                                     f"weighted) {n}, not {expect}")
            total += n
        if not (np.isfinite(out.test_acc).all()
                and np.isfinite(out.energy_per_client).all()):
            raise AssertionError(f"{label}: non-finite result")
        spent = {k: tel.spans[k][1] - v[1] for k, v in spans.items()
                 if k in tel.spans and tel.spans[k][0] > v[0]}
        per = out.participation.sum(axis=1)
        log(f"[sweep] {label}: warm wall={wall:.3f} s "
            f"({1e3 * wall / SWEEP_T:.2f} ms a round)"
            + "".join(f", {k} {1e3 * v:.1f} ms" for k, v in spent.items())
            + f", transmitters a round mean {per.mean():.2f} max "
            f"{int(per.max())}, K1 launches={n[0]} (subset {n[1]}), "
            f"final_acc={out.test_acc[-1]:.4f}")
        return out

    def traced(runner, h, label):
        """One more run under the profiler: where a run's time goes."""
        nonlocal total
        zero_k1(k1)
        trace_window(torch, f"{label}, one run", lambda: runner(params, h))
        total += k1_counts(k1)

    for K in SWEEP_K:
        store, h = sweep_store(torch, K, "cuda")
        if store.nbytes != store_bytes(K, SWEEP_PER_CLIENT, (784,)):
            raise AssertionError("store footprint disagrees with store_bytes")
        log(f"[sweep] K={K}: store {store.nbytes / 1e9:.3f} GB on the card "
            f"({store_bytes(K, SWEEP_PER_CLIENT, (784,))} bytes)")
        policy, cell = RandomScheme(16 / K, K), CellConfig(num_clients=K)
        runner = make_sparse_runner(mlp_loss, mlp_accuracy, store, test,
                                    policy, cell, cfg)
        sparse_out = timed(runner, h, f"K={K} sparse", (SWEEP_T, SWEEP_T, 0))
        if K == SWEEP_K[0]:
            clients = [Dataset(store.x[k], store.y[k], 10) for k in range(K)]
            dense = make_runner(mlp_loss, mlp_accuracy, clients, test, policy,
                                cell, dataclasses.replace(
                                    cfg, participation="dense"))
            dense_out = timed(dense, h, f"K={K} dense baseline",
                              (SWEEP_T, 0, 0))
            traced(dense, h, f"K={K} dense baseline")
            worst = held_to(np, sparse_out, dense_out)
            log(f"[sweep] K={K}: sparse = dense (worst {worst:.3f} of the "
                f"tolerance)")
            del clients, dense
        if K == SWEEP_K[-1]:
            traced(runner, h, f"K={K} sparse")
            data_key = data_stream_key(0, device="cuda")
            part = torch.sort(torch.randint(0, K, (SWEEP_T, SWEEP_BUCKET),
                                            device="cuda"), dim=1).values
            ms = time_ms(torch, lambda: gather_participant_rounds(
                store, data_key, part, 5, 10), None, iters=20, l2="warm")
            log(f"[sweep] K={K}: participant gather alone ({SWEEP_T} x "
                f"{SWEEP_BUCKET} x 5 x 10 x 784 float32, "
                f"{SWEEP_T * SWEEP_BUCKET * 50 * 785 * 4 / 1e6:.0f} MB): "
                f"{ms:.3f} ms")
        if K == SWEEP_CPU_K:
            cpu_store = DeviceDataStore(*(t.cpu() for t in store))
            t0 = time.perf_counter()
            ref = make_sparse_runner(
                mlp_loss, mlp_accuracy, cpu_store,
                Dataset(test.x.cpu(), test.y.cpu(), 10), policy, cell, cfg,
                device="cpu")([{k: v.cpu() for k, v in layer.items()}
                               for layer in params], h.cpu())
            worst = held_to(np, sparse_out, ref)
            log(f"[sweep] K={K}: card = CPU: masks, last_tx, eval rounds "
                f"equal; energy, acc, loss, model within rtol {SLICE_RTOL} "
                f"atol {SLICE_ATOL} (worst {worst:.3f}); cpu wall="
                f"{time.perf_counter() - t0:.2f} s")
            del cpu_store
        del store, h, runner
        torch.cuda.empty_cache()
    built = train_trace_count() - builds
    if built != 1:
        raise AssertionError(f"phase B built {built} times over the sweep")
    log(f"[sweep] phase B built once for the sweep "
        f"(train_trace_count() +{built}); phase 3c (b) in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 3d
# ---------------------------------------------------------------------------

# benchmarks/bench_faults.py's FAULTS and GUARDS (:44-48), its policy
# (:90) and its full severity sweep
FAULT_KW = dict(p_fail=0.1, p_recover=0.5, diurnal_amp=0.5, p_crash=0.05,
                p_loss=0.2, max_retries=1, backoff=2.0, p_corrupt=0.2)
GUARD_KW = dict(quarantine=True, clip_norm=10.0, staleness_power=0.5)
FAULT_P, FAULT_RATES = 0.5, (0.0, 0.25, 0.5, 0.75, 1.0)
# benchmarks/fig6_7_schemes.py's fig6_k10 setting, its non-FULL branch
SCHEME_T, SCHEME_TRAIN, SCHEME_SEEDS, SEVERITIES = 16, 5_000, (0, 1), (2, 5)
# benchmarks/bench_engine.py's K 10 matrix (bench_matrix); the scenario
# matrix runs 1 of its 3 uniform lanes (the chip's time), and neither
# matrix runs its 2 near/far lanes
ENGINE_T, ENGINE_TRAIN, ENGINE_LANES = 16, 5_000, 3
ENGINE_RHOS = (0.01, 0.05, 0.2)


class PoisonedRows:
    """While active, wraps ``repro_torch.kernels.ops``' three K1 entry
    points to count, for every launch on the card, the non-finite delta
    rows it reduces: in the plain and subset modes by whether the row's
    weight is 0, in the weighted mode by launch.  It reads the rows before
    the launch and changes nothing: K1's own launch counters are the
    wrappers'."""

    def __init__(self, torch):
        from repro_torch.kernels import ops
        self.torch, self.ops = torch, ops
        self.n = dict(plain_w1=0, plain_w0=0, plain_launches=0,
                      subset_w1=0, subset_w0=0, weighted_rows=0,
                      weighted_launches=0)

    def _bad(self, d):
        return ~self.torch.isfinite(d).all(dim=1)

    def __enter__(self):
        ops, n = self.ops, self.n
        self.saved = (ops.fl_aggregate, ops.fl_aggregate_subset,
                      ops.fl_aggregate_guarded)
        plain, subset, guarded = self.saved

        def spy_plain(g, d, mask):
            if g.is_cuda:
                bad = self._bad(d)
                w1 = int((bad & (mask != 0)).sum())
                w0 = int((bad & (mask == 0)).sum())
                n["plain_w1"] += w1
                n["plain_w0"] += w0
                n["plain_launches"] += bool(w1 + w0)
            return plain(g, d, mask)

        def spy_subset(g, d, valid, num_clients):
            if g.is_cuda:
                bad = self._bad(d)
                n["subset_w1"] += int((bad & (valid != 0)).sum())
                n["subset_w0"] += int((bad & (valid == 0)).sum())
            return subset(g, d, valid, num_clients)

        def spy_guarded(g, d, weights):
            if g.is_cuda:
                rows = int(self._bad(d).sum())
                n["weighted_rows"] += rows
                n["weighted_launches"] += bool(rows)
            return guarded(g, d, weights)

        ops.fl_aggregate = spy_plain
        ops.fl_aggregate_subset = spy_subset
        ops.fl_aggregate_guarded = spy_guarded
        return self

    def __exit__(self, *exc):
        (self.ops.fl_aggregate, self.ops.fl_aggregate_subset,
         self.ops.fl_aggregate_guarded) = self.saved
        return False


def held_nan(np, got, ref, fields=("participation", "delivered",
                                   "corrupted", "eval_rounds")) -> float:
    """Faulty runs: ``fields`` and ``last_tx`` equal bit for bit; energy,
    accuracy, loss and the model's own parameters within the slice
    tolerance, NaN in the same places.  Returns the worst finite float as
    a share of its tolerance."""
    for name in fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
    np.testing.assert_array_equal(got.state.last_tx.cpu().numpy(),
                                  ref.state.last_tx.cpu().numpy())
    layout = got.state.layout
    pairs = [(getattr(got, n), getattr(ref, n), n) for n in (
        "energy_per_client", "energy_timeline", "test_acc", "test_loss")]
    pairs.append((got.state.global_params.cpu().numpy()[:layout.size],
                  ref.state.global_params.cpu().numpy()[:layout.size],
                  "global model"))
    return max(held_floats(np, a, b, name) for a, b, name in pairs)


def held_floats(np, a, b, name) -> float:
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                  err_msg=f"{name}: NaN positions")
    np.testing.assert_allclose(a, b, rtol=SLICE_RTOL, atol=SLICE_ATOL,
                               equal_nan=True, err_msg=name)
    ok = np.isfinite(a) & np.isfinite(b)
    if not ok.any():
        return 0.0
    return float(np.max(np.abs(a[ok] - b[ok])
                        / (SLICE_ATOL + SLICE_RTOL * np.abs(b[ok]))))


def fault_runs(torch, world):
    """(a) single faulty runs on phase 3's world; returns K1's launches as
    (plain, subset, weighted) and the poisoned rows they reduced."""
    import numpy as np

    from repro_torch.core.selection import RandomScheme
    from repro_torch.fl import (FaultConfig, GuardConfig, SimConfig,
                                run_simulation)
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1
    from repro_torch.models.small import mlp_accuracy, mlp_loss

    t_sub = time.perf_counter()
    cell, h = world["cell"], world["h"]
    base = SimConfig(rounds=T, local_iters=5, batch_size=10, eval_every=4)
    guards = GuardConfig(**GUARD_KW)

    def faulty(mode, **kw):
        return dataclasses.replace(
            base, faults=FaultConfig(**FAULT_KW, corrupt_mode=mode), **kw)

    def participants(engine, **kw):
        return faulty("nan", participant_bucket=8, participation=engine,
                      **SPARSE_KW, **kw)

    runs = [  # name, config, K1's mode
        ("dense unguarded nan", faulty("nan"), "plain"),
        ("dense guarded nan", faulty("nan", guards=guards), "weighted"),
        ("dense guarded inf", faulty("inf", guards=guards), "weighted"),
        ("dense guarded scale", faulty("scale", guards=guards), "weighted"),
        ("sparse guarded nan", participants("sparse", guards=guards),
         "weighted"),
        ("dense guarded nan (participants)",
         participants("dense", guards=guards), "weighted"),
        ("sparse unguarded nan", participants("sparse"), "subset"),
        ("dense unguarded nan (participants)", participants("dense"),
         "plain")]
    policy = RandomScheme(p_bar=FAULT_P, num_clients=K)
    card = {}
    zero_k1(k1)
    with PoisonedRows(torch) as spy:
        for name, cfg, mode in runs:
            before = k1_counts(k1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_simulation(world["params"], mlp_loss, mlp_accuracy,
                                 world["clients"], world["test"], policy, h,
                                 cell, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = [a - b for a, b in zip(k1_counts(k1), before)]
            sparse = cfg.participation == "sparse"
            want = [T, T * (mode == "subset"), T * (mode == "weighted")]
            if n != want or (out.state.client_params is None) != sparse:
                raise AssertionError(f"{name}: K1 launches (all, subset, "
                                     f"weighted) {n}, not {want}")
            if out.corrupted is None or out.corrupted.sum() < 1:
                raise AssertionError(f"{name}: no delivery was corrupted")
            finite = bool(torch.isfinite(out.state.global_params).all())
            if finite != (mode == "weighted"):
                raise AssertionError(f"{name}: final model finite={finite}")
            card[name] = out
            log(f"[faults] {name:35s} card: decided="
                f"{int(out.participation.sum())} delivered="
                f"{int(out.delivered.sum())} corrupted="
                f"{int(out.corrupted.sum())} final_loss="
                f"{out.test_loss[-1]:.4f} final_acc={out.test_acc[-1]:.4f} "
                f"model finite={finite} energy="
                f"{out.energy_per_client.sum():.4f} J wall={wall:.2f} s K1 "
                f"launches={n[0]}, subset={n[1]}, weighted={n[2]}")
    counts = np.asarray(k1_counts(k1))
    p = spy.n
    if min(p["plain_w1"], p["subset_w1"], p["weighted_launches"]) < 1:
        raise AssertionError(f"K1 reduced no poisoned row in a mode: {p}")
    log(f"[faults] K1 reduced real non-finite rows: plain mode "
        f"{p['plain_w1']} of weight 1 and {p['plain_w0']} of weight 0 in "
        f"{p['plain_launches']} launches; subset mode {p['subset_w1']} of "
        f"weight > 0 and {p['subset_w0']} of weight 0; weighted (guarded) "
        f"mode {p['weighted_rows']} rows in {p['weighted_launches']} "
        f"launches (of {int(counts[2])}); K1 launches plain "
        f"{int(counts[0] - counts[1] - counts[2])}, subset {int(counts[1])}, "
        f"weighted {int(counts[2])}")
    for guard in ("guarded", "unguarded"):
        worst = held_nan(np, card[f"sparse {guard} nan"],
                         card[f"dense {guard} nan (participants)"])
        log(f"[faults] sparse {guard} = dense on the card under faults: "
            f"masks, deliveries, corruptions, last_tx equal; NaN in the same "
            f"places; floats within rtol {SLICE_RTOL} atol {SLICE_ATOL} "
            f"(worst {worst:.3f})")
    for name, cfg, _ in runs:
        t0 = time.perf_counter()
        ref = run_simulation(world["c_params"], mlp_loss, mlp_accuracy,
                             world["c_clients"], world["c_test"], policy,
                             h.cpu(), cell, cfg, device="cpu")
        worst = held_nan(np, card[name], ref)
        log(f"[faults] {name:35s} cpu: masks, deliveries, corruptions, "
            f"last_tx equal; NaN in the same places; floats within rtol "
            f"{SLICE_RTOL} atol {SLICE_ATOL} (worst {worst:.3f}); cpu "
            f"wall={time.perf_counter() - t0:.2f} s")
    log(f"[faults] (a) in {time.perf_counter() - t_sub:.1f} s")
    return counts, p


def fault_matrix_runs(torch, world):
    """(b) run_fault_matrix over bench_faults.py's rates; returns K1's
    launches."""
    import numpy as np

    from repro_torch.core.selection import RandomScheme
    from repro_torch.fl import (FaultConfig, GuardConfig, SimConfig,
                                run_fault_matrix)
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1
    from repro_torch.models.small import mlp_accuracy, mlp_loss

    t_sub = time.perf_counter()
    cfg = SimConfig(rounds=T, local_iters=5, batch_size=10, eval_every=4,
                    faults=FaultConfig(**FAULT_KW, corrupt_mode="nan"))
    policy = RandomScheme(p_bar=FAULT_P, num_clients=K)
    args = (mlp_loss, mlp_accuracy)
    zero_k1(k1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run_fault_matrix(world["params"], *args, world["clients"],
                           world["test"], policy, world["h"], world["cell"],
                           cfg, FAULT_RATES, guard=GuardConfig(**GUARD_KW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = np.asarray(k1_counts(k1))
    lanes = 2 * len(FAULT_RATES)
    if tuple(counts) != (lanes * T, 0, len(FAULT_RATES) * T):
        raise AssertionError(f"fault matrix: K1 launches {tuple(counts)}")
    t0 = time.perf_counter()
    ref = run_fault_matrix(world["c_params"], *args, world["c_clients"],
                           world["c_test"], policy, world["h"].cpu(),
                           world["cell"], cfg, FAULT_RATES,
                           guard=GuardConfig(**GUARD_KW), device="cpu")
    cpu_wall = time.perf_counter() - t0
    worst = 0.0
    for name in ("unguarded", "guarded"):
        for field in ("delivered", "finite_final"):
            np.testing.assert_array_equal(getattr(got, field)[name],
                                          getattr(ref, field)[name],
                                          err_msg=f"{name} {field}")
        for field in ("energy", "acc", "loss"):
            worst = max(worst, held_floats(np, getattr(got, field)[name],
                                           getattr(ref, field)[name],
                                           f"{name} {field}"))
    mass = got.delivered["guarded"].sum(axis=(1, 2))
    if not (got.finite_final["guarded"].all()
            and got.finite_final["unguarded"][0]
            and (np.diff(mass) <= 0).all()):
        raise AssertionError(f"fault matrix: guarded finite "
                             f"{got.finite_final['guarded']}, unguarded "
                             f"{got.finite_final['unguarded']}, delivered "
                             f"mass {mass}")
    for r, rate in enumerate(got.rates):
        log(f"[faults] matrix rate {rate:.2f}: delivered "
            f"{int(mass[r])}, final acc guarded "
            f"{got.acc['guarded'][r, -1]:.4f} / unguarded "
            f"{got.acc['unguarded'][r, -1]:.4f}, finite guarded "
            f"{bool(got.finite_final['guarded'][r])} / unguarded "
            f"{bool(got.finite_final['unguarded'][r])}, energy guarded "
            f"{got.energy['guarded'][r].sum():.4f} J")
    log(f"[faults] (b) run_fault_matrix, {lanes} lanes ({len(FAULT_RATES)} "
        f"rates x unguarded/guarded): card {wall:.2f} s "
        f"({wall / lanes:.3f} s a lane), cpu {cpu_wall:.2f} s "
        f"({cpu_wall / lanes:.3f} s a lane); card = CPU on every lane "
        f"(worst {worst:.3f}); delivered mass falls with the rate; K1 "
        f"launches={int(counts[0])}, weighted={int(counts[2])}; (b) in "
        f"{time.perf_counter() - t_sub:.1f} s")
    return counts


def matrix_world(torch, n_train, rounds, lanes, severities=None):
    """benchmarks' matrix worlds on the card: MNIST-like data from key 0
    (1,000 test examples), d = 5 shards (or one set a severity, padded to
    a shared cap), the full MLP from key 4."""
    from repro_torch import random as jr
    from repro_torch.core import CellConfig
    from repro_torch.core.channel import channel_gains, sample_positions
    from repro_torch.data import (from_client_datasets, make_mnist_like,
                                  shard_noniid)
    from repro_torch.models.small import init_mlp

    train, test = make_mnist_like(jr.PRNGKey(0), n_train=n_train,
                                  n_test=1_000)
    cell = CellConfig(num_clients=K)
    w = dict(test=test, cell=cell, params=init_mlp(jr.PRNGKey(4)))
    if severities is None:   # bench_engine.py: build() and lane_gains()
        w["clients"] = shard_noniid(jr.PRNGKey(1), train, K, d=5)
        w["h"] = torch.stack([channel_gains(
            jr.PRNGKey(200 + s, device="cuda"),
            sample_positions(jr.PRNGKey(100 + s, device="cuda"), cell),
            rounds).T for s in range(lanes)])
    else:                    # fig6_7_schemes.py: build_matrix_world()
        sev = [shard_noniid(jr.PRNGKey(1), train, K, d=d)
               for d in severities]
        pad = max(int(c.y.shape[0]) for cs in sev for c in cs)
        w["stores"] = [from_client_datasets(cs, pad_to=pad) for cs in sev]
        w["severity_clients"] = sev
        pos = sample_positions(jr.PRNGKey(2, device="cuda"), cell)
        w["h"] = torch.stack([channel_gains(jr.PRNGKey(3 + s, device="cuda"),
                                            pos, rounds).T
                              for s in range(lanes)])
    return w


def on_cpu(w):
    """The card world's tensors on the host CPU."""
    from repro_torch.data import Dataset, DeviceDataStore

    def ds(d):
        return Dataset(d.x.cpu(), d.y.cpu(), d.num_classes)

    out = dict(test=ds(w["test"]), h=w["h"].cpu(),
               params=[{k: v.cpu() for k, v in layer.items()}
                       for layer in w["params"]])
    if "clients" in w:
        out["clients"] = [ds(c) for c in w["clients"]]
    if "stores" in w:
        out["stores"] = [DeviceDataStore(*(t.cpu() for t in s))
                         for s in w["stores"]]
    return out


def held_matrix(np, got, ref, fields) -> float:
    np.testing.assert_array_equal(got.participation, ref.participation)
    np.testing.assert_array_equal(got.eval_rounds, ref.eval_rounds)
    return max(held_floats(np, getattr(got, f), getattr(ref, f), f)
               for f in fields)


def solved_once(fn):
    """A state-free policy that solves each distinct ``(t, h)`` once (its
    answer depends on them alone): the matched panel's probe and the dense
    and sparse matrices on the card then share each seed lane's (P1')
    solve, with the bits of solving it again."""
    cache = {}

    def memo(t, h_t, state=None):
        key = (h_t.device.type, tuple(h_t.shape),
               h_t.cpu().numpy().tobytes(), repr(t.tolist()
                                                 if hasattr(t, "tolist")
                                                 else t))
        if key not in cache:
            cache[key] = fn(t, h_t, state)
        return cache[key]

    memo.state_free = True
    return memo


def scheme_matrix_runs(torch):
    """(c) run_scheme_matrix at fig6_7_schemes.py's fig6_k10 setting, dense
    and sparse on the card, dense on the CPU; returns K1's launches."""
    import numpy as np

    from repro_torch.core import ProblemSpec
    from repro_torch.core.selection import (age_aware_policy,
                                            average_participants,
                                            csma_policy, online_policy,
                                            random_policy)
    from repro_torch.fl import (AggregatorConfig, SchemeSpec, SimConfig,
                                make_runner, run_scheme_matrix,
                                train_trace_count)
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1
    from repro_torch.models.small import mlp_accuracy, mlp_loss

    t_sub = time.perf_counter()
    w = matrix_world(torch, SCHEME_TRAIN, SCHEME_T, len(SCHEME_SEEDS),
                     SEVERITIES)
    cell = w["cell"]
    spec = ProblemSpec(cell=cell, rho=0.05, num_rounds=SCHEME_T)
    # fig6_7_schemes.py: matched_panel
    proposed = solved_once(online_policy(spec))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg = average_participants(proposed, w["h"][0])
    solve_s = time.perf_counter() - t0
    k, p_bar = max(1, round(avg)), min(avg / K, 1.0)
    panel = [
        SchemeSpec("paper", proposed, AggregatorConfig(kind="paper")),
        SchemeSpec("fedasync-hinge", random_policy(p_bar, K),
                   AggregatorConfig(kind="fedasync", staleness_fn="hinge")),
        SchemeSpec("fedasync-poly", random_policy(p_bar, K),
                   AggregatorConfig(kind="fedasync", staleness_fn="poly")),
        SchemeSpec("csmaafl", csma_policy(k, K),
                   AggregatorConfig(kind="csmaafl")),
        SchemeSpec("age-aware", age_aware_policy(k, K),
                   AggregatorConfig(kind="age"))]
    cfg = SimConfig(rounds=SCHEME_T, local_iters=5, batch_size=10, lr=0.01,
                    eval_every=max(SCHEME_T // 8, 1), **SPARSE_KW)
    lanes = len(SEVERITIES) * len(panel) * len(SCHEME_SEEDS)
    log(f"[schemes] fig6_k10: K={K}, {SCHEME_TRAIN} train examples, "
        f"severities d={list(SEVERITIES)} padded to "
        f"{w['stores'][0].x.shape[1]}, T={SCHEME_T}, seeds "
        f"{list(SCHEME_SEEDS)}; matched avg={avg:.4f} clients/round, k={k} "
        f"(solve {solve_s:.2f} s); {lanes} lanes a path, the (P1') solve "
        f"of a seed lane shared by the matched panel and both paths")
    args = (w["params"], mlp_loss, mlp_accuracy, w["stores"], w["test"],
            panel, w["h"], cell, cfg, SCHEME_SEEDS)
    card, counts = {}, np.zeros(3, int)
    for path in ("dense", "sparse"):
        built = train_trace_count()
        zero_k1(k1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card[path] = run_scheme_matrix(*args, participation=path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = np.asarray(k1_counts(k1))
        counts += n
        built = train_trace_count() - built
        if tuple(n) != (lanes * SCHEME_T, 0, lanes * SCHEME_T) or \
                built != (path == "sparse"):
            raise AssertionError(f"scheme matrix {path}: K1 launches "
                                 f"{tuple(n)}, phase B built {built} times")
        res = card[path]
        log(f"[schemes] {path:6s} card: {wall:.2f} s ({wall / lanes:.3f} s "
            f"a lane), final acc by scheme (mean over lanes) "
            + ", ".join(f"{s} {res.acc[:, i, :, -1].mean():.4f}"
                        for i, s in enumerate(res.schemes))
            + f"; K1 launches={n[0]} (weighted {n[2]})"
            + (f"; phase B built once (train_trace_count() +{built})"
               if path == "sparse" else ""))
    fields = ("energy", "energy_timeline", "acc", "loss")
    worst = held_matrix(np, card["sparse"], card["dense"], fields)
    log(f"[schemes] sparse = dense on the card: masks equal, floats within "
        f"rtol {SLICE_RTOL} atol {SLICE_ATOL} (worst {worst:.3f})")
    # one lane against single runs: the dense engine (the same bits) and
    # the sparse one (last_tx too)
    v, l, s = 1, 3, 1
    zero_k1(k1)
    single = {}
    for path in ("dense", "sparse"):
        single[path] = make_runner(
            mlp_loss, mlp_accuracy, w["severity_clients"][v], w["test"],
            panel[l].policy, cell, dataclasses.replace(
                cfg, aggregator=panel[l].aggregator, participation=path))(
            w["params"], w["h"][s], seed=SCHEME_SEEDS[s])
    counts += np.asarray(k1_counts(k1))
    d, one = card["dense"], single["dense"]
    np.testing.assert_array_equal(d.participation[v, l, s],
                                  one.participation)
    worst = max(held_floats(np, a[v, l, s], getattr(one, field), field)
                for field, a in (("test_acc", d.acc), ("test_loss", d.loss),
                                 ("energy_per_client", d.energy)))
    worst_sp = held_to(np, single["sparse"], one)
    log(f"[schemes] lane (d={SEVERITIES[v]}, {panel[l].name}, seed "
        f"{SCHEME_SEEDS[s]}) = a single make_runner run: masks equal, "
        f"floats within tolerance (worst {worst:.3f}); its sparse run = its "
        f"dense run: masks, last_tx, eval rounds equal, floats (worst "
        f"{worst_sp:.3f})")
    c = on_cpu(w)
    t0 = time.perf_counter()
    ref = run_scheme_matrix(c["params"], mlp_loss, mlp_accuracy,
                            c["stores"], c["test"], panel, c["h"], cell, cfg,
                            SCHEME_SEEDS, participation="dense", device="cpu")
    cpu_wall = time.perf_counter() - t0
    worst = held_matrix(np, card["dense"], ref, fields)
    log(f"[schemes] dense cpu: {cpu_wall:.2f} s ({cpu_wall / lanes:.3f} s "
        f"a lane); card = CPU on all {lanes} lanes: masks equal, floats "
        f"within rtol {SLICE_RTOL} atol {SLICE_ATOL} (worst {worst:.3f}); "
        f"(c) in {time.perf_counter() - t_sub:.1f} s")
    return counts


def engine_matrix_runs(torch):
    """(d) run_seed_matrix and run_scenario_matrix at bench_engine.py's
    K 10 setting, card against CPU; returns K1's launches."""
    import numpy as np

    from repro_torch.core import ProblemSpec
    from repro_torch.core.selection import (AgeBasedScheme, GreedyScheme,
                                            ProposedOnline, RandomScheme,
                                            average_participants)
    from repro_torch.fl import (SimConfig, run_scenario_matrix,
                                run_seed_matrix)
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1
    from repro_torch.models.small import mlp_accuracy, mlp_loss

    t_sub = time.perf_counter()
    w = matrix_world(torch, ENGINE_TRAIN, ENGINE_T, ENGINE_LANES)
    c = on_cpu(w)
    cell = w["cell"]
    spec = ProblemSpec(cell=cell, rho=0.05, num_rounds=ENGINE_T)
    cfg = SimConfig(rounds=ENGINE_T, local_iters=5, batch_size=10,
                    eval_every=max(ENGINE_T // 4, 1), eval_batch=512)
    avg = average_participants(ProposedOnline(spec), w["h"][0])
    k = max(1, round(avg))
    seeds = list(range(ENGINE_LANES))
    fields = ("energy", "e_round", "acc", "loss")
    counts = np.zeros(3, int)
    runs = [(p.name, p) for p in (RandomScheme(min(avg / K, 1.0), K),
                                  GreedyScheme(k, K), AgeBasedScheme(k, K))]
    runs.append((f"proposed rho {list(ENGINE_RHOS)}", None))
    for name, policy in runs:
        zero_k1(k1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if policy is None:
            got = run_scenario_matrix(w["params"], mlp_loss, mlp_accuracy,
                                      w["clients"], w["test"], spec,
                                      w["h"][:1], ENGINE_RHOS, cfg, [0])
        else:
            got = run_seed_matrix(w["params"], mlp_loss, mlp_accuracy,
                                  w["clients"], w["test"], policy, w["h"],
                                  cell, cfg, seeds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = np.asarray(k1_counts(k1))
        lanes = int(np.prod(got.participation.shape[:-2]))
        if tuple(n) != (lanes * ENGINE_T, 0, 0):
            raise AssertionError(f"{name}: K1 launches {tuple(n)}")
        counts += n
        t0 = time.perf_counter()
        if policy is None:
            ref = run_scenario_matrix(c["params"], mlp_loss, mlp_accuracy,
                                      c["clients"], c["test"], spec,
                                      c["h"][:1], ENGINE_RHOS, cfg, [0],
                                      device="cpu")
        else:
            ref = run_seed_matrix(c["params"], mlp_loss, mlp_accuracy,
                                  c["clients"], c["test"], policy, c["h"],
                                  cell, cfg, seeds, device="cpu")
        cpu_wall = time.perf_counter() - t0
        worst = held_matrix(np, got, ref, fields)
        log(f"[engine-matrix] {name:28s} {lanes} lanes "
            f"{tuple(got.participation.shape[:-2])}: card {wall:.2f} s, cpu "
            f"{cpu_wall:.2f} s; final acc {got.acc[..., -1].ravel()}; card "
            f"= CPU (worst {worst:.3f}); K1 launches={n[0]}")
    log(f"[engine-matrix] matched avg={avg:.4f}, k={k}; (d) in "
        f"{time.perf_counter() - t_sub:.1f} s")
    return counts


def faults_and_matrices(torch, world):
    """Phase 3d: (a)-(d); returns K1's launches (plain, subset, weighted)
    and the poisoned rows of (a)."""
    counts, poison = fault_runs(torch, world)
    counts = counts + fault_matrix_runs(torch, world)
    counts = counts + scheme_matrix_runs(torch)
    counts = counts + engine_matrix_runs(torch)
    return counts, poison


# ---------------------------------------------------------------------------
# phase 3e
# ---------------------------------------------------------------------------

# benchmarks/bench_data.py's world (build_world, bench): K 16, 8,000/1,000
# MNIST-like examples, d 5, RandomScheme(0.15), B 10, eval_batch 512,
# eval_every T/4, stream_chunk max(T/8, 16); L 5 at T 50, L 1 above
DATA_K, DATA_TRAIN, DATA_P = 16, 8_000, 0.15
DATA_HORIZONS = ((50, 5, 2), (500, 1, 2), (1000, 1, 1))   # T, L, runs
DATA_PATHS = ("prestack", "device", "stream")
# the one run dropped to keep phase 3e within its 120 s: the longest
# horizon's prestack stack (0.5 GB on the host at T 1000, then on the card)
# and run; that horizon is cut from T 2000 to 1000 to make room for phase 9
DATA_CUT = {(1000, "prestack")}
# Adam's model after ADAM_ROUNDS quickstart rounds from the initial models
# of ADAM_SEEDS: the card-CPU relative L2 gap limit, between one-ulp nudges
# of the initial weights on the CPU and planted faults on the card
ADAM_ROUNDS, ADAM_REL_L2, ADAM_SEEDS = 4, 5e-3, (4, 5, 6)
TRACE_ROUNDS = 8     # the traced runs at L 1 (~0.3 s of profiling a round)
RESUME_EVERY = 3


def data_world(torch):
    """bench_data.py's build_world on the card, gains for its longest T."""
    from repro_torch import random as jr
    from repro_torch.core import CellConfig
    from repro_torch.core.channel import channel_gains, sample_positions
    from repro_torch.data import make_mnist_like, shard_noniid
    from repro_torch.models.small import init_mlp

    train, test = make_mnist_like(jr.PRNGKey(0), n_train=DATA_TRAIN,
                                  n_test=1_000)
    cell = CellConfig(num_clients=DATA_K)
    T = max(t for t, _, _ in DATA_HORIZONS)
    return dict(
        clients=shard_noniid(jr.PRNGKey(1), train, DATA_K, d=5), test=test,
        cell=cell, params=init_mlp(jr.PRNGKey(4)),
        h=channel_gains(jr.PRNGKey(3, device="cuda"), sample_positions(
            jr.PRNGKey(2, device="cuda"), cell), T).T)


def data_config(T, L):
    from repro_torch.fl import SimConfig
    return SimConfig(rounds=T, local_iters=L, batch_size=10,
                     eval_every=max(T // 4, 1), eval_batch=512,
                     stream_chunk=max(T // 8, 16))


def same_bits(np, torch, got, ref, what):
    """Masks, energy, the global row, accuracy and loss equal bit for
    bit."""
    for name in ("participation", "energy_per_client", "energy_timeline",
                 "test_acc", "test_loss", "eval_rounds"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=f"{what}: {name}")
    if not torch.equal(got.state.global_params, ref.state.global_params):
        raise AssertionError(f"{what}: the global rows differ")


def data_path_runs(torch, w):
    """(a) bench_data.py's three paths at T 50, 500 and 1000 on the card,
    less ``DATA_CUT``; returns the T 50 device result and its runner's
    config."""
    import resource

    import numpy as np

    from repro_torch.core.selection import RandomScheme
    from repro_torch.fl import make_runner
    from repro_torch.models.small import mlp_accuracy, mlp_loss

    policy = RandomScheme(DATA_P, DATA_K)
    t_sub = time.perf_counter()
    flat = {p: set() for p in ("device", "stream")}
    keep = {}
    for T, L, runs in DATA_HORIZONS:
        cfg = data_config(T, L)
        h = w["h"][:, :T]
        out = {}
        for path in DATA_PATHS:
            if (T, path) in DATA_CUT:
                continue
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            runner = make_runner(mlp_loss, mlp_accuracy, w["clients"],
                                 w["test"], policy, w["cell"], cfg,
                                 data_path=path)
            torch.cuda.synchronize()
            prep = time.perf_counter() - t0
            data_bytes = torch.cuda.memory_allocated() - before
            host = ""
            if path == "stream":   # two chunks in flight, the steady state
                s = runner.sampler
                C = min(cfg.stream_chunk, T)
                t0 = time.perf_counter()
                held = [s.chunk(0, C), s.chunk(C, min(2 * C, T))]
                torch.cuda.synchronize()
                gather = time.perf_counter() - t0
                data_bytes = torch.cuda.memory_allocated() - before
                exact = sum(t.numel() * t.element_size()
                            for pair in held for t in pair)
                # the allocator rounds each large block up to 2 MiB
                if not exact <= data_bytes <= exact + 4 * (2 << 20):
                    raise AssertionError(f"T={T}: {data_bytes} B on the "
                                         f"card for {exact} B of chunks")
                del held
                host = (f" pinned host blocks {s.nbytes_host / 1e6:.1f} MB; "
                        f"two chunks of {C} rounds gathered and copied in "
                        f"{gather * 1e3:.2f} ms")
            elif path == "prestack":
                host = (f" (stacked on the host first: "
                        f"{data_bytes / 1e6:.1f} MB)")
            walls = []
            for _ in range(runs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = runner(w["params"], h)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            if path in flat:
                flat[path].add(data_bytes if path == "device"
                               else (data_bytes, exact, L,
                                     min(cfg.stream_chunk, T), T))
            out[path] = res
            del runner
            warm = (f"warm {walls[1]:.3f} s ({walls[1] / T * 1e3:.2f} ms a "
                    "round)" if runs > 1 else "one run")
            log(f"[data] T={T:5d} L={L} {path:8s} prep {prep:.3f} s, cold "
                f"{walls[0]:.3f} s, {warm}; device data "
                f"{data_bytes / 1e6:.1f} MB;{host} final_acc="
                f"{res.test_acc[-1]:.4f}")
        same_bits(np, torch, out["stream"], out["device"], f"T={T} stream")
        prestack = ""
        if "prestack" in out:
            np.testing.assert_array_equal(out["prestack"].participation,
                                          out["device"].participation)
            prestack = " prestack masks = device masks;"
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        log(f"[data] T={T}: stream = device bit for bit (masks, energy, the "
            f"global row, acc, loss);{prestack} host peak RSS so far "
            f"{rss:.2f} GB")
        if T == DATA_HORIZONS[0][0]:
            keep = dict(out, cfg=cfg)
    dev = flat["device"]
    if len(dev) != 1:
        raise AssertionError(f"device-store bytes change with T: {dev}")
    per_step = {e / (min(2 * C, t) * L)
                for _, e, L, C, t in flat["stream"]}
    if len(per_step) != 1:
        raise AssertionError(f"stream bytes are not two chunks: {flat}")
    log(f"[data] device store {dev.pop() / 1e6:.1f} MB at every T; stream "
        f"{sorted(round(b / 1e6, 1) for b, *_ in flat['stream'])} MB "
        f"on the card = two chunks of {per_step.pop() / 1e6:.4f} MB a "
        f"round-step (T enters only through stream_chunk = max(T/8, 16)); "
        f"(a) on the card in {time.perf_counter() - t_sub:.1f} s")
    return keep


def trace_data_paths(torch, w):
    """(a) where the device path's extra time a round goes: a warm
    ``TRACE_ROUNDS``-round run at L 1 on the device and stream paths under
    ``torch.profiler``, and what the device path does there that the
    stream path does on the host: each round's index draw
    (:func:`round_indices`) alone."""
    from repro_torch.core.selection import RandomScheme
    from repro_torch.data import data_stream_key, from_client_datasets
    from repro_torch.data.device import round_indices
    from repro_torch.fl import make_runner
    from repro_torch.models.small import mlp_accuracy, mlp_loss

    R = TRACE_ROUNDS
    cfg = data_config(R, 1)
    h = w["h"][:, :R]
    per = {}
    for path in ("device", "stream"):
        runner = make_runner(mlp_loss, mlp_accuracy, w["clients"], w["test"],
                             RandomScheme(DATA_P, DATA_K), w["cell"], cfg,
                             data_path=path)
        runner(w["params"], h)                          # warm
        per[path] = trace_window(torch, f"T={R} L=1 {path} run (warm)",
                                 lambda: runner(w["params"], h))
        del runner
    store = from_client_datasets(w["clients"])
    key = data_stream_key(cfg.seed, device="cuda")
    def draws():
        for t in range(R):
            round_indices(key, t, store.lengths, 1, cfg.batch_size)
    draws()                                             # warm
    per["draw"] = trace_window(torch, f"{R} rounds of the device path's "
                               f"index draw alone", draws)
    if all(per.values()):
        (dw, db, de), (sw, sb, se), (gw, gb, ge) = (
            per[p] for p in ("device", "stream", "draw"))
        log(f"[data] a round at L 1, traced: device {dw / R:.3f} ms wall, "
            f"{db / R:.3f} ms busy, {de / R:.1f} device events; stream "
            f"{sw / R:.3f} ms, {sb / R:.3f} ms, {se / R:.1f}; the gap "
            f"{(dw - sw) / R:.3f} ms wall and {(de - se) / R:.1f} events; "
            f"the index draw alone {gw / R:.3f} ms wall, {gb / R:.3f} ms "
            f"busy, {ge / R:.1f} events")


def data_path_cpu(torch, w, card):
    """(a) the T 50 runs on the CPU: card = CPU on all three paths."""
    import numpy as np

    from repro_torch.core.selection import RandomScheme
    from repro_torch.data import Dataset
    from repro_torch.fl import make_runner
    from repro_torch.models.small import mlp_accuracy, mlp_loss

    t0 = time.perf_counter()
    clients = [Dataset(c.x.cpu(), c.y.cpu(), 10) for c in w["clients"]]
    test = Dataset(w["test"].x.cpu(), w["test"].y.cpu(), 10)
    params = [{k: v.cpu() for k, v in layer.items()} for layer in w["params"]]
    cfg = card["cfg"]
    for path in DATA_PATHS:
        ref = make_runner(mlp_loss, mlp_accuracy, clients, test,
                          RandomScheme(DATA_P, DATA_K), w["cell"], cfg,
                          device="cpu", data_path=path)(
            params, w["h"][:, :cfg.rounds].cpu())
        worst = held_to(np, card[path], ref)
        log(f"[data] T={cfg.rounds} {path:8s} card = CPU: masks, eval "
            f"rounds, last_tx equal; floats within rtol {SLICE_RTOL} atol "
            f"{SLICE_ATOL} (worst {worst:.3f})")
    log(f"[data] CPU runs in {time.perf_counter() - t0:.1f} s")


def planning_checks(torch, w, card):
    """(b) choose_data_path with the card's own budget; the auto-resolved
    stream runner against the device runner."""
    import numpy as np

    from repro_torch.core.selection import RandomScheme
    from repro_torch.data import (choose_data_path, device_memory_budget,
                                  estimate_store_bytes, store_bytes)
    from repro_torch.fl import make_runner
    from repro_torch.models.small import mlp_accuracy, mlp_loss

    budget = device_memory_budget()
    need = estimate_store_bytes(w["clients"])
    million = store_bytes(10 ** 6, 8, (784,))
    over = int(0.5 * budget) + 1
    before = torch.cuda.memory_allocated()
    got = (choose_data_path(w["clients"]), choose_data_path(million),
           choose_data_path(over))
    if got != ("device", "device", "stream"):
        raise AssertionError(f"choose_data_path on the card: {got}")
    if torch.cuda.memory_allocated() != before:
        raise AssertionError("planning allocated device memory")
    cfg = card["cfg"]
    runner = make_runner(mlp_loss, mlp_accuracy, w["clients"], w["test"],
                         RandomScheme(DATA_P, DATA_K), w["cell"], cfg,
                         data_path="auto", data_budget_bytes=need)
    if not hasattr(runner, "sampler"):
        raise AssertionError("auto below the store did not stream")
    res = runner(w["params"], w["h"][:, :cfg.rounds])
    same_bits(np, torch, res, card["device"], "auto-stream")
    log(f"[plan] budget {budget / 1e9:.3f} GB (the card's memory): bench_data "
        f"store {need / 1e6:.1f} MB -> device; the 10^6-client store "
        f"{million / 1e9:.3f} GB -> device; {over / 1e9:.3f} GB -> stream "
        f"(no allocation); auto under a {need / 1e6:.1f} MB budget -> the "
        "stream runner, = the device runner bit for bit")


def resume_runs(torch, world):
    """(c) phase 3d (a)'s guarded world, resumable, kill and resume, replay
    evals, a fingerprint mismatch."""
    import tempfile

    import numpy as np

    from repro_torch.core.selection import RandomScheme
    from repro_torch.fl import (FaultConfig, GuardConfig, SimConfig,
                                make_runner, read_segment_manifest,
                                run_resumable)
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1
    from repro_torch.models.small import mlp_accuracy, mlp_loss
    from repro_torch.obs.telemetry import get_telemetry

    t_sub = time.perf_counter()
    cfg = SimConfig(rounds=T, local_iters=5, batch_size=10, eval_every=4,
                    faults=FaultConfig(**FAULT_KW, corrupt_mode="nan"),
                    guards=GuardConfig(**GUARD_KW),
                    checkpoint_every=RESUME_EVERY)
    policy = RandomScheme(p_bar=FAULT_P, num_clients=K)
    args = (world["params"], mlp_loss, mlp_accuracy, world["clients"],
            world["test"], policy, world["h"], world["cell"])
    direct = make_runner(mlp_loss, mlp_accuracy, world["clients"],
                         world["test"], policy, world["cell"], cfg)(
        world["params"], world["h"])

    def launches(fn):
        before = k1.guarded_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, k1.guarded_launches - before, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as d:
        whole, n_whole, s_whole = launches(
            lambda: run_resumable(*args, cfg, f"{d}/whole"))
        same_bits(np, torch, whole, direct, "resumable")
        np.testing.assert_array_equal(whole.delivered, direct.delivered)
        np.testing.assert_array_equal(whole.corrupted, direct.corrupted)
        killed, n_kill, s_kill = launches(
            lambda: run_resumable(*args, cfg, f"{d}/kill",
                                  stop_after_segment=2))
        if killed is not None:
            raise AssertionError("the killed run returned a result")
        resumed, n_res, s_res = launches(
            lambda: run_resumable(*args, cfg, f"{d}/kill"))
        same_bits(np, torch, resumed, whole, "killed and resumed")
        np.testing.assert_array_equal(resumed.delivered, whole.delivered)
        np.testing.assert_array_equal(resumed.corrupted, whole.corrupted)
        for f in ("client_params", "anchor_params", "last_tx", "round"):
            if not torch.equal(getattr(resumed.state, f),
                               getattr(whole.state, f)):
                raise AssertionError(f"resumed state {f} differs")
        if (n_whole, n_kill + n_res) != (T, T):
            raise AssertionError(f"K1 weighted launches {n_whole}, "
                                 f"{n_kill} + {n_res}, not {T}")
        segs = [e["segment"] for e in read_segment_manifest(f"{d}/kill")]
        rep_cfg = dataclasses.replace(cfg, eval_mode="replay")
        rep, _, s_rep = launches(
            lambda: run_resumable(*args, rep_cfg, f"{d}/replay"))
        if not torch.equal(rep.state.global_params,
                           whole.state.global_params):
            raise AssertionError("replay changed the model")
        common = sorted(set(rep.eval_rounds) & set(whole.eval_rounds))
        a = [rep.test_acc[list(rep.eval_rounds).index(t)] for t in common]
        b = [whole.test_acc[list(whole.eval_rounds).index(t)]
             for t in common]
        la = [rep.test_loss[list(rep.eval_rounds).index(t)] for t in common]
        lb = [whole.test_loss[list(whole.eval_rounds).index(t)]
              for t in common]
        worst = max(held_floats(np, a, b, "replay acc"),
                    held_floats(np, la, lb, "replay loss"))
        try:
            run_resumable(*args, dataclasses.replace(cfg, seed=99),
                          f"{d}/kill")
        except ValueError as e:
            if "different run" not in str(e):
                raise
        else:
            raise AssertionError("a fingerprint mismatch was accepted")
    span = get_telemetry().span_stats("resume.segment")
    log(f"[resume] T={T} every {RESUME_EVERY}: resumable = make_runner bit "
        f"for bit ({s_whole:.2f} s, K1 weighted {n_whole}); killed after "
        f"segment 2 ({s_kill:.2f} s, {n_kill} launches) and resumed "
        f"({s_res:.2f} s, {n_res}) = uninterrupted bit for bit, fault "
        f"state and deliveries included; segments run {segs}; replay evals "
        f"at {rep.eval_rounds.tolist()} ({s_rep:.2f} s) = in-loop at "
        f"{[int(t) for t in common]} "
        f"(worst {worst:.3f}); a fingerprint mismatch raised; "
        f"resume.segment mean {span['mean_s'] * 1e3:.1f} ms; (c) in "
        f"{time.perf_counter() - t_sub:.1f} s")


def planted_adam(torch, kind: str, lr: float = 0.01):
    """Adam with a planted fault, to show that the gap limit catches one:
    ``"no-bias-correction"`` drops ``1 - b^t``; ``"state-carried"`` keeps
    its moments across rounds instead of starting each round afresh."""
    from repro_torch.optim import Optimizer, adam

    if kind == "no-bias-correction":
        def init(p):
            return torch.zeros_like(p), torch.zeros_like(p)

        def update(g, state, p):
            m, v = state
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            return -lr * m / (torch.sqrt(v) + 1e-8), (m, v)
        return Optimizer(init, update)
    base, kept = adam(lr), {}

    def init(p):
        state = kept.get(tuple(p.shape))
        return base.init(p) if state is None else state

    def update(g, state, p):
        upd, state = base.update(g, state, p)
        kept[tuple(p.shape)] = state
        return upd, state
    return Optimizer(init, update)


def rel_gap(a, b) -> float:
    """``||a - b|| / ||b||`` of two flat models, on the CPU."""
    a, b = a.cpu().double(), b.cpu().double()
    return float((a - b).norm() / b.norm())


def optim_partition_runs(torch, world):
    """(d) momentum and Adam runs, the partitioners; card = CPU.

    Adam at lr 0.01 on the quickstart amplifies a last-ulp difference: its
    step is about ``lr · sign(g)`` wherever ``|g|`` is well above ``eps``,
    so a gradient that rounds to the other side of 0 moves a weight by
    2·lr, and such flips compound over rounds; after 12 rounds a one-ulp
    nudge of the initial weights moves the model as far as the card lies
    from the CPU.  So the model is held where the chaos has not yet grown:
    after one round at the slice tolerance, after ``ADAM_ROUNDS`` by a
    relative L2 gap under ``ADAM_REL_L2`` from three initial models, a
    limit the run checks against one-ulp nudges on the CPU (below it) and
    planted faults on the card (above it).  The quickstart's 12 rounds
    are held bit for bit where the model does not enter (masks, eval
    rounds, ``last_tx``), and Adam's steps bit for bit on the same
    gradients."""
    import numpy as np

    from repro_torch import random as jr
    from repro_torch.core.selection import RandomScheme
    from repro_torch.data import (Dataset, dirichlet_store,
                                  make_mnist_like, shard_store)
    from repro_torch.fl import SimConfig, run_simulation
    from repro_torch.models.small import init_mlp, mlp_accuracy, mlp_loss
    from repro_torch.optim import adam, momentum

    policy = RandomScheme(p_bar=0.1, num_clients=K)

    def config(rounds):
        return SimConfig(rounds=rounds, local_iters=5, batch_size=10,
                         eval_every=4)

    def card_run(opt, rounds=T, params=None):
        return run_simulation(params or world["params"], mlp_loss,
                              mlp_accuracy, world["clients"], world["test"],
                              policy, world["h"][:, :rounds], world["cell"],
                              config(rounds), opt=opt)

    def cpu_run(opt, rounds=T, params=None):
        return run_simulation(params or world["c_params"], mlp_loss,
                              mlp_accuracy, world["c_clients"],
                              world["c_test"], policy,
                              world["h"][:, :rounds].cpu(), world["cell"],
                              config(rounds), opt=opt, device="cpu")

    def nudged(seed, toward):
        """The initial weights with half the ``w`` entries one ulp off."""
        gen = torch.Generator().manual_seed(seed)
        out = []
        for layer in world["c_params"]:
            new = dict(layer)
            w = layer["w"]
            pick = torch.rand(w.shape, generator=gen) < 0.5
            new["w"] = torch.where(pick, torch.nextafter(
                w, torch.full_like(w, toward)), w)
            out.append(new)
        return out

    for name, make in (("momentum", momentum), ("adam", adam)):
        t0 = time.perf_counter()
        got = card_run(make(0.01))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = cpu_run(make(0.01))
        c_wall = time.perf_counter() - t0
        if name == "momentum":
            worst = held_to(np, got, ref)
            log(f"[optim] {name:8s} card {wall:.2f} s, CPU {c_wall:.2f} s: "
                f"card = CPU (worst {worst:.3f}); final_loss="
                f"{got.test_loss[-1]:.4f}")
            continue
        for field in ("participation", "eval_rounds"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(ref, field))
        np.testing.assert_array_equal(got.state.last_tx.cpu().numpy(),
                                      ref.state.last_tx.cpu().numpy())
        held_floats(np, got.energy_per_client, ref.energy_per_client,
                    "energy")
        gap_T = rel_gap(got.state.global_params, ref.state.global_params)
        # one round: the whole run at the slice tolerance
        one = held_to(np, card_run(make(0.01), 1), cpu_run(make(0.01), 1))
        # ADAM_ROUNDS rounds: the model's relative L2 gap card-CPU under the
        # limit on three initial models, with the sound readings (one-ulp
        # nudges on the CPU) below it and the planted faults above
        R = ADAM_ROUNDS
        want = cpu_run(make(0.01), R)
        gaps = []
        for seed in ADAM_SEEDS:
            params = (world["params"] if seed == 4
                      else init_mlp(jr.PRNGKey(seed)))
            c_params = [{k: v.cpu() for k, v in layer.items()}
                        for layer in params]
            short = card_run(make(0.01), R, params)
            ref_s = want if seed == 4 else cpu_run(make(0.01), R, c_params)
            np.testing.assert_array_equal(short.participation,
                                          ref_s.participation)
            gaps.append(rel_gap(short.state.global_params,
                                ref_s.state.global_params))
        sound = [rel_gap(cpu_run(make(0.01), R, nudged(seed, toward))
                         .state.global_params, want.state.global_params)
                 for seed in (0, 1) for toward in (np.inf, -np.inf)]
        planted = {kind: rel_gap(card_run(opt, R).state.global_params,
                                 want.state.global_params)
                   for kind, opt in (
                       ("b2 0.99", make(0.01, b2=0.99)),
                       ("no-bias-correction",
                        planted_adam(torch, "no-bias-correction")),
                       ("state-carried", planted_adam(torch, "state-carried")))}
        if not max(sound) < ADAM_REL_L2 < min(planted.values()):
            raise AssertionError(f"adam: the limit {ADAM_REL_L2} does not "
                                 f"part one-ulp nudges {sound} from planted "
                                 f"faults {planted}")
        if not max(gaps) <= ADAM_REL_L2:
            raise AssertionError(f"adam: card-CPU relative L2 gaps {gaps} "
                                 f"after {R} rounds, limit {ADAM_REL_L2}")
        # the optimizer alone: Adam's steps on the same gradients
        gen = torch.Generator().manual_seed(19)
        grads = [torch.randn(K, MAIN_M, generator=gen) for _ in range(8)]
        rows = []
        for dev in (got.state.global_params.device, "cpu"):
            opt = make(0.01)
            p = torch.zeros(K, MAIN_M, device=dev)
            st = opt.init(p)
            for g in grads:
                upd, st = opt.update(g.to(dev), st, p)
                p = p + upd
            rows.append(p.cpu())
        if not torch.equal(*rows):
            raise AssertionError("adam's steps differ between card and CPU")
        faults = ", ".join(f"{k} {v:.4g}" for k, v in planted.items())
        log(f"[optim] {name:8s} card {wall:.2f} s, CPU {c_wall:.2f} s: "
            f"{T} rounds: masks, eval rounds, last_tx equal, energy within "
            f"tolerance, the model's card-CPU relative L2 gap {gap_T:.4g} "
            f"(not held); 1 round: card = CPU within rtol {SLICE_RTOL} atol "
            f"{SLICE_ATOL} (worst {one:.3f}); {R} rounds: relative L2 gaps "
            f"{', '.join(f'{x:.4g}' for x in gaps)} (initial models "
            f"{ADAM_SEEDS}) <= {ADAM_REL_L2} (one-ulp nudges on the CPU "
            f"{', '.join(f'{x:.4g}' for x in sound)}; planted faults on the "
            f"card {faults}); 8 steps on the same [{K}, {MAIN_M}] gradients "
            f"card = CPU bit for bit; final acc {got.test_acc[-1]:.4f} / "
            f"{ref.test_acc[-1]:.4f} (card / CPU)")
    train, _ = make_mnist_like(jr.PRNGKey(0))                     # 60,000
    c_train = Dataset(train.x.cpu(), train.y.cpu(), 10)
    for name, fn, args in (("shard_store K 10 d 5", shard_store, (10, 5)),
                           ("dirichlet_store K 100 a 0.3", dirichlet_store,
                            (100, 0.3))):
        walls = {}
        stores = {}
        for dev, ds in (("cuda", train), ("cpu", c_train)):
            if dev == "cuda":   # the card's first launches, untimed
                fn(jr.PRNGKey(7, device=dev), ds, *args)
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            stores[dev] = fn(jr.PRNGKey(7, device=dev), ds, *args)
            if dev == "cuda":
                torch.cuda.synchronize()
            walls[dev] = time.perf_counter() - t0
        for a, b in zip(stores["cuda"], stores["cpu"]):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"{name}: card and CPU differ")
        lens = stores["cpu"].lengths
        log(f"[partition] {name}: card {walls['cuda'] * 1e3:.1f} ms, CPU "
            f"{walls['cpu'] * 1e3:.1f} ms, card = CPU bit for bit (cap "
            f"{int(lens.max())}, smallest client {int(lens.min())})")


def data_and_resume(torch, world):
    """Phase 3e: (a)-(d); returns K1's launches (all, subset, weighted)."""
    import numpy as np

    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1

    zero_k1(k1)
    steps = []

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        steps.append(f"{name} {time.perf_counter() - t0:.1f}")
        return out

    w = step("world", data_world, torch)
    card = step("(a)", data_path_runs, torch, w)
    step("trace", trace_data_paths, torch, w)
    step("(b)", planning_checks, torch, w, card)
    step("(c)", resume_runs, torch, world)
    step("(d)", optim_partition_runs, torch, world)
    counts = np.asarray(k1_counts(k1))
    step("(a) on the CPU", data_path_cpu, torch, w, card)
    log(f"[data] phase 3e's steps in s: {', '.join(steps)}")
    log(f"[data] K1 launches in phase 3e: {int(counts[0])} (subset "
        f"{int(counts[1])}, weighted {int(counts[2])})")
    return counts


# ---------------------------------------------------------------------------
# phase 3f
# ---------------------------------------------------------------------------

# benchmarks/bench_obs.py's world (bench :67-74 with bench_sparse.py's
# build_store, test_set and gains), the paper's MLP in place of its DIM-8
# stand-in: E 6 expected transmitters, T 40, L 2, B 4, 4 examples a client
OBS_E, OBS_T, OBS_PER, OBS_REPS = 6, 40, 4, 5
OBS_KD, OBS_KS = 128, 4_096          # its dense and sparse populations
OBS_BOUND = 1.10                     # bench_obs.py:39, a JAX CPU bound
# tests/golden/harness.py's world and panel (golden_world, scheme_panel)
GOLDEN_K, GOLDEN_T, GOLDEN_DIM = 5, 8, 16
GOLDEN_PATHS = ("dense", "legacy", "sparse")


def held_taps(np, got, ref, what) -> float:
    """Integer taps bit for bit, float taps within the slice tolerance, the
    same taps present; returns the worst float as a share of its
    tolerance."""
    worst = 0.0
    for name in type(ref)._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if (a is None) != (b is None):
            raise AssertionError(f"{what}: tap {name} on one side only")
        if a is None:
            continue
        if a.dtype != b.dtype:
            raise AssertionError(f"{what}: tap {name} {a.dtype} {b.dtype}")
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")
        else:
            worst = max(worst, held_floats(np, a, b, f"{what}: {name}"))
    return worst


def run_bits(np, torch, got, ref, what):
    """:func:`same_bits` and, under faults, deliveries, corruptions and
    ``last_tx``."""
    same_bits(np, torch, got, ref, what)
    for name in ("delivered", "corrupted"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=f"{what}: {name}")
    if not torch.equal(got.state.last_tx, ref.state.last_tx):
        raise AssertionError(f"{what}: last_tx differs")


def sim_path(path, world, cfg, policy, cpu=False):
    """One quickstart run on ``path``: the dense or sparse engine through
    ``run_simulation``, or the legacy host loop; on the card or, with
    ``cpu``, on the host from the same data."""
    import dataclasses as dc

    from repro_torch.fl import run_simulation, run_simulation_legacy
    from repro_torch.models.small import mlp_accuracy, mlp_loss

    c = "c_" if cpu else ""
    args = (world[c + "params"], mlp_loss, mlp_accuracy,
            world[c + "clients"], world[c + "test"], policy,
            world["h"].cpu() if cpu else world["h"], world["cell"])
    dev = "cpu" if cpu else None
    if path == "legacy":
        return run_simulation_legacy(*args, cfg, device=dev)
    return run_simulation(*args, dc.replace(cfg, participation=path),
                          device=dev)


def obs_three_paths(torch, world):
    """(a) the dense engine, the legacy loop and the sparse engine under
    every tap, phase 3d (a)'s fault cocktail, the guards and the fedasync
    aggregator; returns K1's launches (all, subset, weighted)."""
    import numpy as np

    from repro_torch.core.selection import RandomScheme
    from repro_torch.fl import (AggregatorConfig, FaultConfig, GuardConfig,
                                SimConfig)
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1
    from repro_torch.obs import MetricsSpec, metrics_summary

    tapped = SimConfig(
        rounds=T, local_iters=5, batch_size=10, eval_every=4,
        participant_bucket=8, faults=FaultConfig(**FAULT_KW,
                                                 corrupt_mode="nan"),
        guards=GuardConfig(**GUARD_KW),
        aggregator=AggregatorConfig(kind="fedasync", staleness_fn="poly"),
        metrics=MetricsSpec(), **SPARSE_KW)
    untapped = dataclasses.replace(tapped, metrics=None)
    policy = RandomScheme(p_bar=FAULT_P, num_clients=K)
    card, total = {}, np.zeros(3, int)
    for path in GOLDEN_PATHS:
        walls = []
        for cfg in (tapped, untapped):
            before = k1_counts(k1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sim_path(path, world, cfg, policy)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            n = np.subtract(k1_counts(k1), before)
            if tuple(n) != (T, 0, T):
                raise AssertionError(f"{path}: K1 launches (all, subset, "
                                     f"weighted) {tuple(n)}, not {(T, 0, T)}")
            if (out.state.client_params is None) != (path == "sparse"):
                raise AssertionError(f"{path}: another engine ran")
            total += n
            card[path, cfg.metrics is not None] = out
        on, off = card[path, True], card[path, False]
        if off.metrics is not None or on.metrics is None:
            raise AssertionError(f"{path}: the taps' presence is wrong")
        run_bits(np, torch, on, off, f"{path} tapped vs untapped")
        s = metrics_summary(on.metrics)
        if s["tx_total"] != int(on.participation.sum()) or \
                s["guard_quarantined"] < 1:
            raise AssertionError(f"{path}: taps disagree with the run: {s}")
        log(f"[obs] {path:6s} card: tapped = untapped bit for bit (masks, "
            f"deliveries, energy, acc, loss, model, last_tx); tapped "
            f"{walls[0]:.2f} s, untapped {walls[1]:.2f} s; K1 launches="
            f"{T} (weighted {T}) each; taps: tx_total={s['tx_total']} "
            f"stale_hist={s['stale_hist']} energy voluntary/forced/retry="
            f"{s['energy_voluntary']:.4f}/{s['energy_forced']:.4f}/"
            f"{s['energy_retry_overhead']:.4f} J guard quarantined/"
            f"clipped/capped={s['guard_quarantined']}/{s['guard_clipped']}/"
            f"{s['guard_stale_capped']} weight entropy mean "
            f"{s['weight_entropy_mean']:.4f} max {s['weight_max']:.4f}")
    ref = card["dense", True].metrics
    for path in GOLDEN_PATHS[1:]:
        got = card[path, True].metrics
        for name in ("tx_count", "stale_hist", "guard_events", "rounds",
                     "agg_rounds"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(ref, name),
                                          err_msg=f"{path} vs dense: {name}")
    log("[obs] integer taps equal across the three paths on the card "
        "(tx_count, stale_hist, guard_events, rounds, agg_rounds)")
    for path in GOLDEN_PATHS:
        t0 = time.perf_counter()
        cpu = sim_path(path, world, tapped, policy, cpu=True)
        got = card[path, True]
        worst = max(held_nan(np, got, cpu),
                    held_taps(np, got.metrics, cpu.metrics, path))
        log(f"[obs] {path:6s} cpu: masks, deliveries, corruptions, last_tx "
            f"and integer taps equal; floats, float taps and the model "
            f"within rtol {SLICE_RTOL} atol {SLICE_ATOL} (worst "
            f"{worst:.3f}); cpu wall={time.perf_counter() - t0:.2f} s")
    return total


def golden_setup(torch):
    """tests/golden/harness.py's golden world built by the port on the
    card (K 5, T 8, 600/200 examples cut to 16 features, a 16-8-10 MLP),
    its copy on the host, and its five-scheme panel."""
    from repro_torch import random as jr
    from repro_torch.core import CellConfig
    from repro_torch.core.channel import channel_gains, sample_positions
    from repro_torch.core.selection import (age_aware_policy, csma_policy,
                                            random_policy)
    from repro_torch.data import Dataset, make_mnist_like, shard_noniid
    from repro_torch.fl import AggregatorConfig
    from repro_torch.models.small import init_mlp

    n = GOLDEN_K
    tr, te = make_mnist_like(jr.PRNGKey(0), n_train=600, n_test=200)
    clients = [Dataset(c.x[:, :GOLDEN_DIM], c.y, c.num_classes)
               for c in shard_noniid(jr.PRNGKey(1), tr, n, d=2)]
    test = Dataset(te.x[:, :GOLDEN_DIM], te.y, te.num_classes)
    cell = CellConfig(num_clients=n)
    h = channel_gains(jr.PRNGKey(3, device="cuda"), sample_positions(
        jr.PRNGKey(2, device="cuda"), cell), GOLDEN_T).T
    params = init_mlp(jr.PRNGKey(4), dims=(GOLDEN_DIM, 8, 10))

    def cpu(ds):
        return Dataset(ds.x.cpu(), ds.y.cpu(), ds.num_classes)

    panel = {
        "paper": (random_policy(0.4, n), AggregatorConfig(kind="paper")),
        "fedasync-hinge": (random_policy(0.4, n), AggregatorConfig(
            kind="fedasync", staleness_fn="hinge")),
        "fedasync-poly": (random_policy(0.4, n), AggregatorConfig(
            kind="fedasync", staleness_fn="poly")),
        "csmaafl": (csma_policy(2, n), AggregatorConfig(kind="csmaafl")),
        "age-aware": (age_aware_policy(2, n), AggregatorConfig(kind="age")),
    }
    return dict(clients=clients, test=test, cell=cell, h=h, params=params,
                c_clients=[cpu(c) for c in clients], c_test=cpu(test),
                c_params=[{k: v.cpu() for k, v in layer.items()}
                          for layer in params]), panel


def golden_trace(np, res) -> dict:
    """tests/golden/harness.py's ``_trace``."""
    import hashlib
    mask = np.asarray(res.participation)
    return {"mask_sha256": hashlib.sha256(
                mask.astype(np.uint8).tobytes()).hexdigest(),
            "eval_rounds": np.asarray(res.eval_rounds).astype(int).tolist(),
            "loss": np.asarray(res.test_loss, np.float64),
            "acc": np.asarray(res.test_acc, np.float64),
            "energy_timeline": np.asarray(res.energy_timeline, np.float64)}


def golden_traces(torch):
    """(b) the 15 golden scheme × path traces on the card and on the host
    CPU, held by tests/golden/harness.py's ``compare_traces`` rule; returns
    K1's launches."""
    import numpy as np

    from repro_torch.fl import SimConfig
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1

    world, panel = golden_setup(torch)
    total, worst, walls = np.zeros(3, int), 0.0, [0.0, 0.0]
    for name, (policy, agg) in panel.items():
        cfg = SimConfig(rounds=GOLDEN_T, local_iters=1, batch_size=4,
                        eval_every=2, aggregator=agg, **SPARSE_KW)
        masks = []
        for path in GOLDEN_PATHS:
            before = k1_counts(k1)
            t0 = time.perf_counter()
            card = sim_path(path, world, cfg, policy)
            walls[0] += time.perf_counter() - t0
            n = np.subtract(k1_counts(k1), before)
            if tuple(n) != (GOLDEN_T, 0, GOLDEN_T):
                raise AssertionError(f"{name}/{path}: K1 launches {tuple(n)}")
            total += n
            t0 = time.perf_counter()
            cpu = sim_path(path, world, cfg, policy, cpu=True)
            walls[1] += time.perf_counter() - t0
            a, b = golden_trace(np, card), golden_trace(np, cpu)
            if a["mask_sha256"] != b["mask_sha256"] or \
                    a["eval_rounds"] != b["eval_rounds"]:
                raise AssertionError(f"{name}/{path}: masks or the eval grid "
                                     f"differ between the card and the CPU")
            for field in ("loss", "acc", "energy_timeline"):
                worst = max(worst, held_floats(np, a[field], b[field],
                                               f"{name}/{path}: {field}"))
            masks.append(a["mask_sha256"])
        if len(set(masks)) != 1:
            raise AssertionError(f"{name}: the three paths' masks differ")
    log(f"[golden] 15 scheme x path traces (5 schemes x dense, legacy, "
        f"sparse): card = CPU under compare_traces' rule (mask sha256 and "
        f"eval grid equal, loss, acc, energy timeline within rtol "
        f"{SLICE_RTOL} atol {SLICE_ATOL}, worst {worst:.3f}); the three "
        f"paths' masks equal for every scheme; K1 launches {int(total[0])} "
        f"(weighted {int(total[2])}); card {walls[0]:.1f} s, cpu "
        f"{walls[1]:.1f} s")
    return total


def obs_bench(torch, world):
    """(c) bench_obs.py's overhead pairs on the card, and bench_engine.py's
    legacy-loop baseline on the quickstart world; returns K1's launches."""
    import numpy as np

    from repro_torch import random as jr
    from repro_torch.core import CellConfig
    from repro_torch.core.selection import RandomScheme, participant_bucket
    from repro_torch.data import Dataset, DeviceDataStore
    from repro_torch.fl import SimConfig, make_runner, make_sparse_runner
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1
    from repro_torch.models.small import init_mlp, mlp_accuracy, mlp_loss
    from repro_torch.obs import MetricsSpec

    gen = torch.Generator(device="cuda").manual_seed(99)
    test = Dataset(torch.randn(64, 784, generator=gen, device="cuda"),
                   torch.arange(64, dtype=torch.int32, device="cuda") % 10,
                   10)
    params = init_mlp(jr.PRNGKey(4))
    base = SimConfig(rounds=OBS_T, local_iters=2, batch_size=4,
                     eval_every=OBS_T, eval_batch=64, **SPARSE_KW)
    total = np.zeros(3, int)

    def world_of(n):
        g = torch.Generator(device="cuda").manual_seed(n)
        store = DeviceDataStore(
            torch.randn(n, OBS_PER, 784, generator=g, device="cuda"),
            (torch.arange(OBS_PER, dtype=torch.int32, device="cuda")
             % 10).repeat(n, 1),
            torch.full((n,), OBS_PER, dtype=torch.int32, device="cuda"))
        h = torch.rand(n, OBS_T, generator=g, device="cuda") \
            * (1e-12 - 1e-14) + 1e-14
        return store, h

    def timed(runner, h, expect):
        nonlocal total
        warm, out = [], None
        for rep in range(1 + OBS_REPS):          # a cold call, then warm
            before = k1_counts(k1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = runner(params, h)
            torch.cuda.synchronize()
            if rep:
                warm.append(time.perf_counter() - t0)
            n = np.subtract(k1_counts(k1), before)
            if tuple(n) != expect:
                raise AssertionError(f"K1 launches {tuple(n)}, not {expect}")
            total += n
        return min(warm) / OBS_T * 1e3, out

    for label, n in (("dense", OBS_KD), ("sparse", OBS_KS)):
        store, h = world_of(n)
        policy, cell = RandomScheme(OBS_E / n, n), CellConfig(num_clients=n)
        ms, outs = {}, {}
        for spec in (None, MetricsSpec()):
            if label == "dense":
                cfg = dataclasses.replace(base, participation="dense",
                                          metrics=spec)
                runner = make_runner(mlp_loss, mlp_accuracy, store, test,
                                     policy, cell, cfg)
                expect = (OBS_T, 0, 0)
            else:
                cfg = dataclasses.replace(
                    base, participation="sparse", metrics=spec,
                    participant_bucket=participant_bucket(OBS_E, cap=n))
                runner = make_sparse_runner(mlp_loss, mlp_accuracy, store,
                                            test, policy, cell, cfg)
                expect = (OBS_T, OBS_T, 0)
            ms[spec is not None], outs[spec is not None] = timed(
                runner, h, expect)
        np.testing.assert_array_equal(outs[True].participation,
                                      outs[False].participation)
        if not torch.equal(outs[True].state.global_params,
                           outs[False].state.global_params):
            raise AssertionError(f"{label}: the taps moved the model")
        R = n if label == "dense" else cfg.participant_bucket
        log(f"[obs-bench] {label} K={n}: warm {ms[False]:.3f} ms a round "
            f"untapped, {ms[True]:.3f} tapped, ratio "
            f"{ms[True] / ms[False]:.3f} (JAX's CPU bound {OBS_BOUND}: a "
            f"finding, not a gate); tapped = untapped bit for bit; K1 at R "
            f"{R} ({'plain' if label == 'dense' else 'subset'}), "
            f"{OBS_T} launches a run; best of {OBS_REPS} warm")
        del store

    # bench_engine.py's baseline: the legacy host loop against the dense
    # runner, on the quickstart world (random p̄ = 0.1, T 12 × 5 × 10)
    cfg = SimConfig(rounds=T, local_iters=5, batch_size=10, eval_every=4)
    policy = RandomScheme(p_bar=0.1, num_clients=K)
    ms, outs = {}, {}
    for path in ("dense", "legacy"):
        walls = []
        for _ in range(3):                      # a cold call, then warm
            before = k1_counts(k1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[path] = sim_path(path, world, cfg, policy)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            n = np.subtract(k1_counts(k1), before)
            if tuple(n) != (T, 0, 0):
                raise AssertionError(f"{path}: K1 launches {tuple(n)}")
            total += n
        ms[path] = min(walls[1:]) / T * 1e3
    worst = held_to(np, outs["legacy"], outs["dense"])
    log(f"[obs-bench] quickstart random(0.1): legacy loop {ms['legacy']:.3f} "
        f"ms a round warm, dense runner {ms['dense']:.3f} (legacy/dense "
        f"{ms['legacy'] / ms['dense']:.3f}); masks, last_tx equal, floats "
        f"within rtol {SLICE_RTOL} atol {SLICE_ATOL} (worst {worst:.3f}); "
        f"best of 2 warm")
    return total


def obs_telemetry(torch, world):
    """(d) manifests through ``runs.jsonl`` and ``repro_torch.obs.report``,
    a profiled tapped round, ``memory_snapshot`` and ``timed_compile`` on
    the card; returns K1's launches."""
    import os
    import tempfile

    import numpy as np

    from repro_torch.core.selection import RandomScheme
    from repro_torch.fl import SimConfig, make_runner, run_resumable
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1
    from repro_torch.models.small import mlp_accuracy, mlp_loss
    from repro_torch.obs import (MetricsSpec, maybe_profile, timed_compile,
                                 validate_manifest)
    from repro_torch.obs.telemetry import get_telemetry

    tel = get_telemetry()
    bad = [p for m in tel.manifests for p in validate_manifest(m)]
    kinds = sorted({m["kind"] for m in tel.manifests})
    if bad or not {"make_runner", "make_sparse_runner"} <= set(kinds):
        raise AssertionError(f"manifests: {bad}, kinds {kinds}")
    log(f"[obs-tel] the last {len(tel.manifests)} manifests of this run "
        f"valid ({', '.join(kinds)})")
    before = k1_counts(k1)
    policy = RandomScheme(p_bar=0.5, num_clients=K)
    cfg = SimConfig(rounds=2, local_iters=5, batch_size=10, eval_every=1,
                    metrics=MetricsSpec(), data_path="device")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_OBS_DIR"] = tmp
        try:
            args = (mlp_loss, mlp_accuracy, world["clients"], world["test"],
                    policy, world["cell"])
            runner = make_runner(*args, cfg)
            runner = timed_compile(runner, world["params"],
                                   world["h"][:, :2], label="obs.runner")
            with tel.span("obs.runner.execute"):
                runner(world["params"], world["h"][:, :2])
            make_runner(*args, dataclasses.replace(
                cfg, participation="sparse", **SPARSE_KW))(
                world["params"], world["h"][:, :2])
            run_resumable(world["params"], mlp_loss, mlp_accuracy,
                          world["clients"], world["test"], policy,
                          world["h"][:, :2], world["cell"], cfg,
                          os.path.join(tmp, "ckpt"))
        finally:
            del os.environ["REPRO_OBS_DIR"]
        runs = os.path.join(tmp, "runs.jsonl")
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.report", "--validate",
             runs, "--summary", runs], capture_output=True, text=True,
            timeout=120, env={**os.environ, "PYTHONPATH": str(SRC)})
        if proc.returncode != 0 or "3/3 manifests valid" not in proc.stdout:
            raise AssertionError(f"report: rc {proc.returncode}\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        lines = proc.stdout.strip().splitlines()
        log(f"[obs-tel] python -m repro_torch.obs.report --validate "
            f"--summary on runs.jsonl: {lines[0]}; {lines[1]}; "
            + "; ".join(" ".join(ln.split()) for ln in lines
                        if "backend=" in ln))
        one = dataclasses.replace(cfg, rounds=1)
        runner = make_runner(*args, one)
        with maybe_profile(os.path.join(tmp, "profile")) as d:
            runner(world["params"], world["h"][:, :1])
        files = os.listdir(d)
        if len(files) != 1:
            raise AssertionError(f"maybe_profile left {files}")
        size = os.path.getsize(os.path.join(d, files[0]))
        log(f"[obs-tel] one tapped round under maybe_profile: "
            f"{files[0]} ({size} bytes)")
    snap = tel.memory_snapshot()
    if not snap[0]["bytes_in_use"] or \
            snap[0]["peak_bytes_in_use"] < snap[0]["bytes_in_use"]:
        raise AssertionError(f"memory_snapshot: {snap}")
    compile_s = tel.span_stats("obs.runner.compile")["total_s"]
    exec_s = tel.span_stats("obs.runner.execute")["total_s"]
    log(f"[obs-tel] memory_snapshot: {snap[0]['device']} "
        f"{snap[0]['bytes_in_use']} bytes in use, peak "
        f"{snap[0]['peak_bytes_in_use']}; timed_compile: obs.runner.compile "
        f"{compile_s:.3f} s (first call), obs.runner.execute {exec_s:.3f} s")
    return np.subtract(k1_counts(k1), before)


def observability(torch, world):
    """Phase 3f: (a)-(d); returns K1's launches (all, subset, weighted)."""
    steps, total = [], None
    for name, fn, args in (("(a)", obs_three_paths, (torch, world)),
                           ("(b)", golden_traces, (torch,)),
                           ("(c)", obs_bench, (torch, world)),
                           ("(d)", obs_telemetry, (torch, world))):
        t0 = time.perf_counter()
        n = fn(*args)
        total = n if total is None else total + n
        steps.append(f"{name} {time.perf_counter() - t0:.1f}")
    log(f"[obs] phase 3f's steps in s: {', '.join(steps)}; K1 launches "
        f"{int(total[0])} (subset {int(total[1])}, weighted "
        f"{int(total[2])})")
    return total


# ---------------------------------------------------------------------------
# phase 3g
# ---------------------------------------------------------------------------

# examples/mnist_fl_schemes.py at 12 rounds, cut from its default 200 for
# time: each round of the proposed scheme is a (P1') solve on the card
FIG6_ROUNDS = 12
# the CNN at the paper's data scale: make_cifar_like's defaults (50,000 /
# 10,000 x 32x32x3), K 10, d 5, init_cnn's default widths, T 12 x L 5 x B 10
CNN_T = 12
CNN_GAP = 1e-2      # the 12-round model, card against CPU (cnn_runs)
# benchmarks/bench_serve.py's --quick setting (bench :113-115, _session
# :48-55), the paper's 784-200-10 MLP in place of its dim-16 linear model.
# Cut from its full setting (K 4,000, 2,000 uploads, 8 workers), which
# took 312.4 s on an H100 80GB HBM3 at 700 W, past phase 3g's 150 s:
# each (P1') re-solve of the control plane held the interpreter lock
# against the submitters for 27.5 s on average.  Cut again to 200 of the
# --quick setting's 500 uploads, to make room for phase 9 (PR 22)
SERVE = dict(K=1000, uploads=200, workers=4)
SERVE_CUT = ("bench_serve's --quick setting with 200 uploads of its 500: "
             "its full K 4,000, 2,000 uploads, 8 workers took 312.4 s")
# tests/test_serve.py's manual sessions (:136-160): plain, and guards with
# the csmaafl aggregator, on its toy world (dim 8, 4 classes, 6 examples)
MANUAL = (("plain", 16, 40, dict(max_batch=8, min_bucket=2)),
          ("guarded+csmaafl", 12, 24, dict(max_batch=4, min_bucket=2)))


def example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` is the entry)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quietly(fn, *args):
    """``fn(*args)`` with its printed lines swallowed (the CPU reruns)."""
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def timed(torch, fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def entry_points(torch):
    """(a) the quickstart, the train CLI at its defaults (random and
    proposed, ``--ckpt`` written and loaded back) and the Fig.-6 driver at
    12 rounds, each on the card and on the CPU."""
    import os
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch import train

    qs = example("quickstart_torch")
    card, wall = timed(torch, qs.main, [])
    cpu, cpu_wall = timed(torch, quietly, qs.main, ["--device", "cpu"])
    for key in ("p", "w"):
        np.testing.assert_allclose(card[key], cpu[key], rtol=SLICE_RTOL,
                                   atol=SLICE_ATOL, err_msg=key)
    worst = max(held_to(np, card["runs"][n], cpu["runs"][n])
                for n in card["runs"])
    log(f"[entry] quickstart_torch.main: card {wall:.2f} s, cpu "
        f"{cpu_wall:.2f} s; p*, w* and both runs card = CPU (masks, last_tx "
        f"bit for bit; worst float {worst:.3f} of the tolerance)")

    with tempfile.TemporaryDirectory() as tmp:
        for scheme in ("random", "proposed"):
            path = os.path.join(tmp, scheme)
            got, wall = timed(torch, train.main,
                              ["--scheme", scheme, "--ckpt", path])
            layout, row = got.state.layout, got.state.global_params
            restored, meta = load_checkpoint(path, layout.unflatten(row))
            if not torch.equal(layout.flatten(restored), row) or \
                    meta["scheme"] != scheme:
                raise AssertionError(f"train --ckpt {scheme}: the checkpoint "
                                     "does not load back to the model")
            ref, cpu_wall = timed(torch, quietly, train.main,
                                  ["--scheme", scheme, "--device", "cpu"])
            # T 30 x 5 local steps: the model's summation-order drift
            # passes atol 1e-5 on a few near-zero weights (1.2e-5 on an
            # H100 80GB HBM3), so it is measured here; the masks, last_tx,
            # eval rounds, accuracy, loss and energy are held
            worst = held_to_cpu(np, got, ref)
            np.testing.assert_array_equal(got.eval_rounds, ref.eval_rounds)
            np.testing.assert_array_equal(got.state.last_tx.cpu().numpy(),
                                          ref.state.last_tx.numpy())
            a = got.state.global_params.cpu().numpy()
            b = ref.state.global_params.numpy()
            log(f"[entry] train.main --scheme {scheme} (K 10, 5,000 "
                f"examples, d 5, T 30): card {wall:.2f} s, cpu "
                f"{cpu_wall:.2f} s; checkpoint loaded back bit for bit; "
                f"card = CPU: masks, last_tx, eval rounds equal, acc, loss, "
                f"energy within the tolerance (worst {worst:.3f} of it); the "
                f"model, measured: max |card - cpu| "
                f"{float(np.max(np.abs(a - b))):.3e}, relative L2 "
                f"{float(np.linalg.norm(a - b) / np.linalg.norm(b)):.3e}")

    fig6 = example("mnist_fl_schemes_torch")
    argv = ["--rounds", str(FIG6_ROUNDS)]
    card, wall = timed(torch, fig6.main, argv)
    cpu, cpu_wall = timed(torch, quietly, fig6.main, argv + ["--device",
                                                             "cpu"])
    if card["k"] != cpu["k"]:
        raise AssertionError(f"fig6: matched k {card['k']} != {cpu['k']}")
    np.testing.assert_allclose(card["avg"], cpu["avg"], rtol=SLICE_RTOL)
    worst = max(held_to(np, a["result"], b["result"])
                for a, b in zip(card["rows"], cpu["rows"]))
    log(f"[entry] mnist_fl_schemes_torch.main --rounds {FIG6_ROUNDS} (cut "
        f"from 200 for time): card {wall:.2f} s, cpu {cpu_wall:.2f} s; "
        f"matched k {card['k']} and the four schemes card = CPU (worst "
        f"{worst:.3f} of the tolerance): "
        + "; ".join(f"{r['scheme']} acc {r['final_acc']:.3f} energy "
                    f"{r['energy_j']:.2f} J acc/J {r['acc_per_j']:.4f} gini "
                    f"{r['gini']:.3f}" for r in card["rows"]))


def cnn_runs(torch):
    """(b) the CNN at the paper's data scale: RandomScheme(0.1) then
    ProposedOnline, K1 plain once a round at R 10 x M 620,364, a warm
    round timed, each run held against the CPU's."""
    import numpy as np

    from repro_torch import random as jr
    from repro_torch.core import CellConfig, ProblemSpec
    from repro_torch.core.channel import channel_gains, sample_positions
    from repro_torch.core.selection import ProposedOnline, RandomScheme
    from repro_torch.data import Dataset, make_cifar_like, shard_noniid
    from repro_torch.fl import SimConfig, run_simulation
    from repro_torch.fl.state import ParamLayout
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1
    from repro_torch.models.small import cnn_accuracy, cnn_loss, init_cnn

    (train, test), wall = timed(torch, make_cifar_like, jr.PRNGKey(0))
    nbytes = sum(t.numel() * t.element_size()
                 for t in (train.x, train.y, test.x, test.y))
    clients = shard_noniid(jr.PRNGKey(1), train, K, d=5)
    cell = CellConfig(num_clients=K)
    spec = ProblemSpec(cell=cell, rho=0.05, lam=0.01, num_rounds=CNN_T)
    h = channel_gains(jr.PRNGKey(3, device="cuda"),
                      sample_positions(jr.PRNGKey(2, device="cuda"), cell),
                      CNN_T).T
    params = init_cnn(jr.PRNGKey(4))
    layout = ParamLayout.of(params)
    if (layout.size, layout.width) != (620_362, CNN_M):
        raise AssertionError(f"CNN row {layout.size}/{layout.width}")
    log(f"[cnn] make_cifar_like on the card in {wall:.2f} s: "
        f"{train.x.shape[0]} / {test.x.shape[0]} x {tuple(train.x.shape[1:])} "
        f"float32 ({nbytes / 1e9:.3f} GB), K={K} shards of "
        f"{[c.y.shape[0] for c in clients]}; init_cnn {layout.size} params, "
        f"W {layout.width}")
    cfg = SimConfig(rounds=CNN_T, local_iters=5, batch_size=10, eval_every=4)
    runs = (("random", RandomScheme(p_bar=0.1, num_clients=K)),
            ("proposed", ProposedOnline(spec)))
    card = {}
    for name, policy in runs:
        before = k1.launches - k1.subset_launches - k1.guarded_launches
        out, wall = timed(torch, run_simulation, params, cnn_loss,
                          cnn_accuracy, clients, test, policy, h, cell, cfg)
        n = k1.launches - k1.subset_launches - k1.guarded_launches - before
        if n != CNN_T or ("plain", "float32", K, CNN_M) not in k1.shapes:
            raise AssertionError(f"cnn {name}: K1 plain launched {n} times in "
                                 f"{CNN_T} rounds")
        if not all(np.isfinite(a).all() for a in (out.test_acc, out.test_loss,
                                                   out.energy_per_client)):
            raise AssertionError(f"cnn {name}: non-finite result")
        card[name] = out
        log(f"[cnn] {name:8s} card: final_acc={out.test_acc[-1]:.4f} "
            f"final_loss={out.test_loss[-1]:.4f} energy="
            f"{out.energy_per_client.sum():.4f} J uploads="
            f"{int(out.participation.sum())} wall={wall:.2f} s K1 plain "
            f"launches={n} (= T) at R {K} x M {CNN_M}")
    _, warm = timed(torch, run_simulation, params, cnn_loss, cnn_accuracy,
                    clients, test, runs[0][1], h, cell, cfg)
    log(f"[cnn] warm random run {warm:.2f} s: {warm / CNN_T * 1e3:.1f} ms a "
        f"round (5 local steps of 10 clients x 10 images, evals at "
        f"{card['random'].eval_rounds.tolist()} of 2048 test images)")

    def cpu(ds):
        return Dataset(ds.x.cpu(), ds.y.cpu(), ds.num_classes)

    c_clients, c_test = [cpu(c) for c in clients], cpu(test)
    c_params = [{k: v.cpu() for k, v in layer.items()} for layer in params]
    # the CNN's local SGD is chaotic at this scale: on a host CPU,
    # tools/cnn_sensitivity.py finds a one-ulp nudge of the initial weights
    # moving the 12-round model by a relative L2 of 1.3e-3-1.9e-3, planted
    # faults of 0.1-1 % (lr, one layer's gradient) by 2.1e-3-2.4e-3, and
    # the flatten in NCHW order by 4.3e-2.  So the 12-round model is held
    # to CNN_GAP, which catches layout faults only; the arithmetic is held
    # a step at a time by tests/test_torch_cuda_serve.py, and the nudge is
    # measured here beside the card's gap
    nudged = [{k: torch.nextafter(v, torch.full_like(v, float("inf")))
               for k, v in layer.items()} for layer in c_params]
    ulp, _ = timed(torch, run_simulation, nudged, cnn_loss, cnn_accuracy,
                   c_clients, c_test, runs[0][1], h.cpu(), cell, cfg, None,
                   "cpu")
    for name, policy in runs:
        ref, wall = timed(torch, run_simulation, c_params, cnn_loss,
                          cnn_accuracy, c_clients, c_test, policy, h.cpu(),
                          cell, cfg, None, "cpu")
        got = card[name]
        np.testing.assert_array_equal(got.participation, ref.participation)
        np.testing.assert_array_equal(got.eval_rounds, ref.eval_rounds)
        np.testing.assert_array_equal(got.state.last_tx.cpu().numpy(),
                                      ref.state.last_tx.numpy())
        for field in ("energy_per_client", "energy_timeline"):
            np.testing.assert_allclose(getattr(got, field),
                                       getattr(ref, field), rtol=SLICE_RTOL,
                                       atol=SLICE_ATOL, err_msg=field)
        a, b = got.state.global_params.cpu(), ref.state.global_params
        gap = float((a - b).norm() / b.norm())
        if not gap < CNN_GAP:
            raise AssertionError(f"cnn {name}: the card's model is {gap:.3e} "
                                 f"(relative L2) from the CPU's")
        line = (f"[cnn] {name:8s} cpu: masks, last_tx, eval rounds equal, "
                f"energy within rtol {SLICE_RTOL} atol {SLICE_ATOL}; the "
                f"model {gap:.3e} from the CPU's (relative L2, limit "
                f"{CNN_GAP}); loss card {got.test_loss.tolist()} cpu "
                f"{ref.test_loss.tolist()}; acc card {got.test_acc.tolist()} "
                f"cpu {ref.test_acc.tolist()}; cpu wall={wall:.2f} s")
        if name == "random":
            u = ulp.state.global_params
            line += (f"; the CPU's own run from weights nudged one ulp: "
                     f"{float((u - b).norm() / b.norm()):.3e}, acc "
                     f"{ulp.test_acc.tolist()}")
        log(line)
    del train, test, clients
    torch.cuda.empty_cache()


def serve_world(K: int, device=None):
    """bench_serve's world with the paper's MLP: toy_world's cluster draw
    at dim 784 (K clients x 8 examples), init_mlp's params."""
    from repro_torch import random as jr
    from repro_torch.models.small import init_mlp, mlp_accuracy, mlp_loss
    from repro_torch.serve import toy_world
    _, store, _, _ = toy_world(K, dim=784, classes=10, n_per=8, seed=0,
                               device=device)
    return init_mlp(jr.PRNGKey(4), device=device), store, mlp_loss, \
        mlp_accuracy


def flush_ceiling(torch, K: int, reps: int = 20) -> None:
    """bench_serve's ``_flush_ceiling``: a full 64-row bucket of pending
    updates, warm flushes timed (each ends when the card has finished)."""
    from repro_torch.serve import AggregationServer, ServeConfig
    params, _, _, _ = serve_world(K)
    cfg = ServeConfig(num_clients=K, queue_capacity=256, max_batch=64,
                      min_bucket=8)
    server = AggregationServer(params, cfg, start=False)
    d = torch.zeros(server.layout.width, device="cuda")

    def fill():
        for k in range(cfg.max_batch):
            server.submit(k, d, server.version)

    fill()
    server.flush()
    times = []
    for _ in range(reps):
        fill()
        t0 = time.perf_counter()
        server.flush()
        times.append(time.perf_counter() - t0)
    server.close()
    best = min(times)
    log(f"[serve] flush ceiling (K {K}, W {server.layout.width}): warm "
        f"64-row flush {best * 1e3:.3f} ms (median "
        f"{statistics.median(times) * 1e3:.3f}), "
        f"{cfg.max_batch / best:.0f} uploads/s")


def client_step_alone(torch, K: int, steps: int = 100) -> None:
    """One client's upload computation (``make_client_step``: the index
    draw, the gather, local SGD on a width-1 lane) timed alone on the
    card, with no server thread running: what a load-generator worker
    pays per upload before it contends for the interpreter lock."""
    from repro_torch.fl.state import ParamLayout
    from repro_torch.serve import make_client_step
    params, store, loss_fn, _ = serve_world(K)
    layout = ParamLayout.of(params)
    step = make_client_step(store, loss_fn, 1, 10, 0, layout=layout)
    g = layout.flatten(params)
    for k in range(5):
        step(g, k, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(steps):
        step(g, k % K, 1)
    torch.cuda.synchronize()
    log(f"[serve] client step alone (L 1, B 10, the MLP): "
        f"{(time.perf_counter() - t0) / steps * 1e3:.3f} ms an upload on "
        f"the card, one thread, no control plane running")


def serve_session(torch, K: int, uploads: int, workers: int,
                  respect_probs: bool) -> dict:
    """bench_serve's ``_session`` on the card: online_policy at rho 0.05
    on 64 rounds of gains, a warm-up burst of 128 uploads, ``uploads`` on
    ``workers`` threads, then ``verify_replay``."""
    from collections import Counter

    from repro_torch import random as jr
    from repro_torch.core import CellConfig
    from repro_torch.core.channel import channel_gains, sample_positions
    from repro_torch.core.selection import ProblemSpec, online_policy
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1
    from repro_torch.serve import (AggregationServer, LoadGenConfig,
                                   ServeConfig, run_loadgen, verify_replay)
    params, store, loss_fn, acc_fn = serve_world(K)
    cell = CellConfig(num_clients=K)
    pos = sample_positions(jr.PRNGKey(0, device="cuda"), cell)
    gains = channel_gains(jr.PRNGKey(1, device="cuda"), pos, 64)
    pol = online_policy(ProblemSpec(cell=cell, rho=0.05, num_rounds=64))
    cfg = ServeConfig(num_clients=K, queue_capacity=max(256, workers * 8),
                      max_batch=64, min_bucket=8, flush_interval_s=0.002,
                      policy_refresh_min_interval_s=2.0)
    before = k1.subset_launches
    server = AggregationServer(params, cfg, policy_fn=pol, gains=gains,
                               cell=cell, start=True)
    run_loadgen(server, store, loss_fn, LoadGenConfig(
        uploads=max(cfg.max_batch * 2, 128), workers=workers, seed=100,
        respect_probs=False, timeout_s=300.0))
    server.reset_stats()
    report = run_loadgen(server, store, loss_fn, LoadGenConfig(
        uploads=uploads, workers=workers, seed=0, rate_sigma=1.0,
        respect_probs=respect_probs, timeout_s=300.0))
    server.close(drain=True)
    flushes = k1.subset_launches - before
    if flushes != server.version:
        raise AssertionError(f"{server.version} flushes launched K1's subset "
                             f"mode {flushes} times")
    t0 = time.perf_counter()
    parity = verify_replay(server, store, params, loss_fn, acc_fn)
    torch.cuda.synchronize()
    report["replay"] = parity
    report["replay_s"] = time.perf_counter() - t0
    report["buckets"] = dict(sorted(Counter(
        rec.bucket for rec in server.log.records).items()))
    return report


def drive_manual(server, step, uploads: int, seed: int = 1):
    """tests/test_serve.py's ``_drive``: ``uploads`` client deltas,
    flushing whenever dedup blocks, then close."""
    import numpy as np
    K = server.cfg.num_clients
    rng = np.random.default_rng(seed)
    seqs = np.zeros((K,), np.int64)
    done = 0
    while done < uploads:
        k = int(rng.integers(K))
        version, g = server.pull_row()
        seq = int(seqs[k])
        tk = server.submit(k, step(g, k, seq), version, seq=seq,
                           energy_j=float(k + 1) * 0.25)
        if tk.admitted:
            seqs[k] += 1
            done += 1
        else:
            server.flush()
    server.close()


def manual_sessions(torch):
    """tests/test_serve.py's two manual sessions on the card and the CPU:
    equal decision logs and ledgers, models within tolerance, replay on
    the card."""
    import numpy as np

    from repro_torch.fl import AggregatorConfig, GuardConfig
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1
    from repro_torch.serve import (AggregationServer, ServeConfig,
                                   make_client_step, toy_world,
                                   verify_replay)
    for name, K, uploads, kw in MANUAL:
        if name != "plain":
            kw = dict(kw, guards=GuardConfig(quarantine=True, clip_norm=5.0,
                                             staleness_power=0.5),
                      aggregator=AggregatorConfig(kind="csmaafl",
                                                  staleness_fn="poly"))
        cfg = ServeConfig(num_clients=K, local_iters=1, batch_size=3,
                          lr=0.05, seed=0, **kw)
        servers = {}
        for device in ("cuda", "cpu"):
            params, store, loss_fn, acc_fn = toy_world(
                K, dim=8, classes=4, n_per=6, device=device)
            server = AggregationServer(params, cfg, start=False,
                                       device=device)
            step = make_client_step(store, loss_fn, 1, 3, 0, lr=0.05,
                                    layout=server.layout)
            before = k1_counts(k1)
            drive_manual(server, step, uploads)
            n = np.subtract(k1_counts(k1), before)
            servers[device] = (server, store, params, loss_fn, acc_fn, n)
        card, cpu = servers["cuda"][0], servers["cpu"][0]
        if [r.to_dict() for r in card.log.records] != \
                [r.to_dict() for r in cpu.log.records]:
            raise AssertionError(f"manual {name}: the card's decision log "
                                 "differs from the CPU's")
        for key in ("last_tx", "tx_count", "energy"):
            np.testing.assert_array_equal(card.ledger_snapshot()[key],
                                          cpu.ledger_snapshot()[key])
        a = card.global_row().cpu().numpy()
        b = cpu.global_row().numpy()
        np.testing.assert_allclose(a, b, rtol=SLICE_RTOL, atol=SLICE_ATOL)
        rep = verify_replay(*servers["cuda"][:5])
        n = servers["cuda"][5]
        mode = "weighted" if name != "plain" else "subset"
        if n[0] != card.version or n[2 if name != "plain" else 1] != n[0]:
            raise AssertionError(f"manual {name}: {card.version} flushes, K1 "
                                 f"launches {tuple(n)}")
        log(f"[serve] manual {name} session (K {K}, {uploads} uploads, "
            f"{card.version} flushes, K1 {mode} mode): card decision log = "
            f"CPU's record for record, ledgers equal, model within rtol "
            f"{SLICE_RTOL} atol {SLICE_ATOL} (max |card - cpu| "
            f"{float(np.max(np.abs(a - b))):.2e}); verify_replay on the card "
            f"passed (max |err| {rep['model_max_abs_err']:.2e})")


def serve_runs(torch):
    """(c) the serve front door: the flush ceiling, the throughput and
    paper load modes, their spans and K1's buckets, then the manual
    sessions."""
    from repro_torch.obs.telemetry import get_telemetry

    tel = get_telemetry()
    tel.reset()
    K = SERVE["K"]
    flush_ceiling(torch, K)
    client_step_alone(torch, K)
    modes = {}
    for mode, respect in (("throughput", False), ("paper", True)):
        modes[mode] = serve_session(torch, K, SERVE["uploads"],
                                    SERVE["workers"], respect)
    for mode, rep in modes.items():
        occ = rep["occupancy"]
        log(f"[serve] {mode} (K {K}, {SERVE['uploads']} uploads on "
            f"{SERVE['workers']} workers after 128 warm-up; {SERVE_CUT}): "
            f"{rep['uploads_per_second']:.1f} uploads/s, {rep['batches']} "
            f"batches, admission p50 {rep['admit_ms']['p50']:.2f} ms p95 "
            f"{rep['admit_ms']['p95']:.2f} ms, occupancy mean "
            f"{occ['mean']:.3f} (mean batch {occ['mean_batch']:.1f}), "
            f"skipped {rep['skipped_bernoulli']} by p_k, "
            f"{rep['skipped_busy']} busy, rejected {rep['rejected']}; K1 "
            f"subset launches by bucket {rep['buckets']}; verify_replay on "
            f"the card passed ({rep['replay']['n_batches']} batches, "
            f"{rep['replay']['n_uploads']} uploads, max |err| "
            f"{rep['replay']['model_max_abs_err']:.2e}, {rep['replay_s']:.2f} "
            f"s)")
    for name in ("serve.flush", "serve.policy_refresh", "serve.loadgen"):
        st = tel.span_stats(name)
        log(f"[serve] span {name}: " + (
            "none" if st is None else
            f"{st['count']} x mean {st['mean_s'] * 1e3:.3f} ms, max "
            f"{st['max_s'] * 1e3:.3f} ms, total {st['total_s']:.2f} s"))
    log(f"[serve] counters: " + ", ".join(
        f"{k}={v}" for k, v in sorted(tel.counters.items())
        if k.startswith("serve.")))
    manual_sessions(torch)


def serve_and_entry(torch):
    """Phase 3g: (a)-(c); returns K1's launches (all, subset, weighted)."""
    import numpy as np

    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1

    zero_k1(k1)
    steps = []
    for name, fn in (("(a)", entry_points), ("(b)", cnn_runs),
                     ("(c)", serve_runs)):
        t0 = time.perf_counter()
        fn(torch)
        steps.append(f"{name} {time.perf_counter() - t0:.1f}")
    counts = np.asarray(k1_counts(k1))
    log(f"[serve] phase 3g's steps in s: {', '.join(steps)}; K1 launches "
        f"{int(counts[0])} (plain {int(counts[0] - counts[1] - counts[2])}, "
        f"subset {int(counts[1])}, weighted {int(counts[2])})")
    return counts


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

# the slice's attention shape: llama3.2-1b's heads at batch 4, prompt 1024
MAIN_ATTN = (4, 1024, 32, 8, 64)
# Jamba's attention layer at the period's prefill: 64 heads, 8 KV, hd 128
JAMBA_ATTN = (4, 1024, 64, 8, 128)


def attn_inputs(torch, B, S, H, KV, hd, dtype, gen):
    return [torch.randn(B, S, n, hd, generator=gen, device="cuda").to(dtype)
            for n in (H, KV, KV)]


def check_flash(torch):
    """K2 against its plain version over every case; returns the max
    |kernel - plain| at the slice's shape."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device="cuda").manual_seed(2)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    cases = []
    for dname in dtypes:
        for shape in ((1, 128, 2, 2, 64), (2, 256, 4, 2, 64),
                      (1, 256, 8, 2, 128), (1, 512, 4, 1, 64)):
            cases.append((dname, shape, True, None))
        for window in (32, 128):
            cases.append((dname, (1, 256, 2, 2, 64), True, window))
            cases.append((dname, (2, 300, 8, 2, 128), False, window))
        for S in (1, 77, 1000):
            cases.append((dname, (2, S, 8, 2, 64), True, None))
            cases.append((dname, (1, S, 4, 4, 128), False, None))
        # the bf16 kernel's edges: S past a multiple of its 128-row query
        # tile and 128-key K/V tile, windows inside one tile, Jamba's G = 8
        # at hd 128, and more work items than the persistent grid's blocks
        for hd in (64, 128):
            for S in (129, 200, 1000):
                cases.append((dname, (2, S, 8, 2, hd), True, None))
            for window in (1, 7, 100):
                cases.append((dname, (2, 300, 8, 2, hd), True, window))
                cases.append((dname, (1, 300, 4, 1, hd), False, window))
            cases.append((dname, (1, 300, 64, 8, hd), True, None))
            cases.append((dname, (8, 1000, 16, 4, hd), True, None))
        for hd in (64, 128):      # q, k, v as views of one fused buffer
            cases.append((dname, (2, 130, 8, 2, hd), "fused", None))
    cases.append(("bfloat16", MAIN_ATTN, True, None))
    cases.append(("bfloat16", JAMBA_ATTN, True, None))
    worst, main_err = {}, 0.0
    for dname, shape, causal, window in cases:
        if causal == "fused":
            B, S, H, KV, hd = shape
            fused = torch.randn(B, S, H + 2 * KV, hd, generator=gen,
                                device="cuda").to(dtypes[dname])
            q, k, v = fused.split([H, KV, KV], dim=2)
            causal = True
        else:
            q, k, v = attn_inputs(torch, *shape, dtypes[dname], gen)
        before = flash_attention_cuda.launches
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        if flash_attention_cuda.launches != before + 1:
            raise AssertionError("K2 did not launch")
        if out.dtype != q.dtype or out.shape != q.shape:
            raise AssertionError(f"bad output {out.dtype} {tuple(out.shape)}")
        torch.testing.assert_close(out.float(), want.float(), **TOL[dname],
                                   msg=lambda m: f"{shape} causal={causal} "
                                   f"window={window} {dname}: {m}")
        err = float((out.float() - want.float()).abs().max())
        worst[dname] = max(worst.get(dname, 0.0), err)
        if shape == MAIN_ATTN:
            main_err = err
    for dname, err in worst.items():
        log(f"[attn] {dname:8s} max |kernel - plain| = {err:.3e} (tolerance "
            f"atol {TOL[dname]['atol']}, rtol {TOL[dname]['rtol']})")
    q, k, v = attn_inputs(torch, 1, 128, 2, 2, 64, torch.float32, gen)
    torch.testing.assert_close(ops.flash_attention(q, k, v)[0, 0], v[0, 0],
                               atol=1e-5, rtol=0)
    log(f"[attn] {len(cases)} shape/mask/dtype cases within tolerance "
        f"(sweeps of tests/test_kernels.py, windows 1/7/32/100/128, "
        f"causal=False, S in 1/77/129/200/1000, G 8 at hd 64 and 128, B*H "
        f"up to 128, fused q/k/v views, the Jamba shape B4 S1024 H64 KV8 "
        f"hd128; B4 S1024 H32 KV8 hd64 bf16: max err {main_err:.3e}); the "
        f"first token attends only to itself")
    return main_err


def attn_bound(B, S, H, KV, hd, elem, peak, bandwidth):
    """(bound ms, 'bytes' | 'operations', flop, bytes) of causal attention:
    4·B·H·hd·S(S+1)/2 flop; q, k, v read and o written once."""
    flop = 4 * B * H * hd * S * (S + 1) / 2
    nbytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * elem
    t_ops, t_bytes = flop / peak * 1e3, nbytes / bandwidth * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flop, nbytes)


def time_flash(torch, bandwidth):
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(3)
    flush = torch.empty(256 * 2**20 // 4, device="cuda")   # 256 MB > L2
    rows = {}
    for shape, iters in ((MAIN_ATTN, 100), ((1, 4096, 32, 8, 64), 30),
                         ((1, 32768, 32, 8, 64), 5), (JAMBA_ATTN, 50)):
        B, S, H, KV, hd = shape
        q, k, v = attn_inputs(torch, *shape, torch.bfloat16, gen)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        t_kernel = time_ms(torch, lambda: ops.flash_attention(q, k, v),
                           flush, iters=iters, warmup=2)
        plain_note = ""
        try:
            t_lib = time_ms(torch, library, flush, iters=iters, warmup=2)
        except torch.cuda.OutOfMemoryError:   # a backend without GQA
            t_lib = None
            plain_note += " (sdpa ran out of memory)"
        if S <= 4096:
            t_plain = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v),
                              flush, iters=iters, warmup=2)
        else:
            t_plain = None
            plain_note = (f" (plain version not run: its [B,KV,G,S,S] fp32 "
                          f"scores would take {B * H * S * S * 4 / 1e9:.0f} "
                          f"GB)")
        bound, by, flop, nbytes = attn_bound(B, S, H, KV, hd, 2, BF16_PEAK,
                                             bandwidth)
        rows[shape] = dict(ms=t_kernel, plain_ms=t_plain, library_ms=t_lib,
                           bound_ms=bound, bound_by=by)
        plain_txt = "n/a" if t_plain is None else f"{t_plain:.4f} ms"
        log(f"[attn-time] B={B} S={S} H={H} KV={KV} hd={hd} bf16 causal: "
            f"kernel {t_kernel:.4f} ms, plain {plain_txt}, sdpa "
            f"{'n/a' if t_lib is None else f'{t_lib:.4f} ms'}, bound {bound:.4f} ms ({by}: "
            f"{flop / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), kernel at "
            f"{flop / t_kernel / 1e9:.1f} TFLOP/s = "
            f"{100 * bound / t_kernel:.1f}% of the bound{plain_note}")
        del q, k, v, qt, kt, vt
    host_time_flash(torch, gen)
    return rows


def host_time_flash(torch, gen, calls=200):
    """The wrapper's host time per call at the main shape: bf16 (three
    tensor maps encoded a call) against float32 (no maps), median of
    ``calls`` calls on the host clock, each into an idle stream (a full
    launch queue would make the host wait for the card)."""
    from repro_torch.kernels import ops
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = attn_inputs(torch, *MAIN_ATTN, dtype, gen)
        for _ in range(5):
            ops.flash_attention(q, k, v)
        times = []
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ops.flash_attention(q, k, v)
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        log(f"[attn-host] {str(dtype).split('.')[1]}: wrapper host time "
            f"{statistics.median(times) * 1e6:.1f} us a call (median of "
            f"{calls}; bf16 encodes three tensor maps a call, float32 none)")
        del q, k, v


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

GEN_ARGS = ["--arch", "llama3.2-1b", "--batch", "4", "--prompt-len", "1024",
            "--new-tokens", "32"]
PREFILL_TOL, DECODE_TOL = 2e-2, 5e-2        # tests/test_models.py
BF16_TOL = 0.1
DEPTH2_TOL = 1e-4


def generate_full_width(torch):
    """(a): the main path, through the entry point a user calls."""
    from repro_torch.configs import get
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch import generate
    from repro_torch.obs.telemetry import get_telemetry

    cfg = get("llama3.2-1b")
    get_telemetry().reset()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fl_aggregate_cuda.launches = 0
    flash_attention_cuda.launches = 0
    out = generate.main(GEN_ARGS)
    launches = flash_attention_cuda.launches
    k1 = fl_aggregate_cuda.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    if launches != cfg.n_layers:
        raise AssertionError(f"K2 launched {launches} times in a prefill of "
                             f"{cfg.n_layers} layers")
    tokens = out["tokens"]
    if tokens.shape != (4, 32) or not bool(((tokens >= 0)
                                            & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"malformed tokens {tuple(tokens.shape)}")
    init = get_telemetry().span_stats("serve.init")["total_s"]
    log(f"[llm] {cfg.name} full width and depth ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, vocab "
        f"{cfg.vocab}), bf16, batch 4, prompt 1024, 32 new tokens: init "
        f"{init:.2f} s, prefill {out['prefill_s'] * 1e3:.1f} ms, decode "
        f"{out['decode_s_per_token'] * 1e3:.2f} ms/token, peak memory "
        f"{peak:.2f} GB; K2 launches={launches} (= n_layers), K1 "
        f"launches={k1}")
    return launches


def decode_rounded(p, cfg, x, cache):
    """``attention.attn_decode`` with one change: the attention output is
    rounded to ``x.dtype`` before ``wo``, as forward rounds it.  A side
    computation of phase 5b, to show what the bf16 tolerance absorbs; the
    port's decode is not changed."""
    import torch

    from repro_torch.models import attention as A
    B, C = x.shape[0], cache.k.shape[1]
    positions = torch.full((B, 1), cache.pos, dtype=torch.int64,
                           device=x.device)
    q, k, v = A._qkv(p, cfg, x, positions)
    slot = cache.pos % C
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    scores = A._gqa_scores(q, cache.k, cfg)
    valid = torch.arange(C, device=x.device) <= min(cache.pos, C - 1)
    out = A._attend(scores, cache.v, valid)
    y = (out.reshape(B, 1, -1).to(x.dtype) @ p.wo).to(x.dtype)
    return y, A.KVCache(k=cache.k, v=cache.v, pos=cache.pos + 1)


@contextlib.contextmanager
def swapped(module, name, value):
    """Set ``module.name`` to ``value`` for the block, then restore it."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def decode_against_forward(T, model, toks, P, N, full, tols):
    """prefill(t[:P]) then N - 1 decode steps, each step's logits held
    against forward's at its position: (worst share of the tolerance for
    the prefill step and for the decode steps, max |diff|, worst relative
    L2, argmax agreements)."""
    lg, caches = T.prefill(model, tokens=toks[:, :P], capacity=P + N)
    steps = [lg[:, 0]]
    for i in range(P, P + N - 1):
        lg, caches = T.decode_step(model, toks[:, i:i + 1], caches)
        steps.append(lg[:, 0])
    worst, err, rel, agree = [0.0, 0.0], 0.0, 0.0, 0
    for j, got in enumerate(steps):
        want = full[:, P - 1 + j]
        tol = tols[j > 0]
        ratio = float(((got - want).abs() / (tol + tol * want.abs())).max())
        worst[j > 0] = max(worst[j > 0], ratio)
        err = max(err, float((got - want).abs().max()))
        rel = max(rel, float((got - want).norm() / want.norm()))
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
    return worst, err, rel, agree


def prefill_decode_parity(torch, dtype: str):
    """(b): prefill(t[:P]) + decode steps reproduce forward(t) on the card
    (decode through the plain cache attention, forward at S = 1056 through
    K2's ragged last tile), at full width and depth.  In float32 the
    tolerances are tests/test_models.py's.  In bfloat16 they are 0.1, the
    size of bf16 rounding at the logits of this network at full width and
    depth: two correct bf16 forwards, through K2 and through its plain
    version, lie about 0.09 apart on an H100.  The bf16 run measures that
    distance beside the decode gap, and the gap again with the two known
    differences of rounding taken away (decode rounding the attention
    output to bf16 before ``wo`` as forward does; forward through the
    plain version, whose P·V is float32 as decode's is)."""
    from repro_torch import random as jr
    from repro_torch.configs import get
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get("llama3.2-1b"), dtype=dtype)
    tols = (PREFILL_TOL, DECODE_TOL) if dtype == "float32" else (BF16_TOL,
                                                                  BF16_TOL)
    model = T.init_params(jr.PRNGKey(1), cfg)
    B, P, N = 4, 1024, 32
    toks = jr.randint(jr.PRNGKey(2), (B, P + N), 0, cfg.vocab, device="cuda")
    with torch.inference_mode():
        T.prefill(model, tokens=toks[:, :P], capacity=P + N)   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.prefill(model, tokens=toks[:, :P], capacity=P + N)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        full, _ = T.forward(model, tokens=toks)
        worst, err, rel, agree = decode_against_forward(T, model, toks, P, N,
                                                        full, tols)
        scale = float(full[:, P - 1:].abs().mean())
        log(f"[llm] {dtype}: on the card, prefill(t[:{P}]) + {N - 1} decode "
            f"steps against forward(t) at S={P + N}: prefill logits within "
            f"{tols[0]} (worst {worst[0]:.3f} of it), decode within "
            f"{tols[1]} (worst {worst[1]:.3f}); max |diff| {err:.3e}, worst "
            f"relative L2 {rel:.3e}, mean |logit| {scale:.3f}; argmax equal "
            f"at {agree} of {B * N}; warm prefill {warm * 1e3:.1f} ms")
        if max(worst) > 1.0:
            raise AssertionError(f"{dtype}: prefill/decode logits differ "
                                 f"from forward beyond the tolerance "
                                 f"({max(worst):.3f} of it)")
        if dtype == "float32":
            return
        # Where the bf16 gap comes from (measured, not gated): decode again
        # with the attention output rounded to bf16 before wo, as forward
        # rounds it, against forward through K2 and then through K2's
        # plain version (float32 P·V, as decode computes it); and the two
        # forwards against each other.
        with swapped(A, "attn_decode", decode_rounded):
            rounded = decode_against_forward(T, model, toks, P, N, full,
                                             tols)
            with swapped(ops, "flash_attention", ref.flash_attention_ref):
                plain_full, _ = T.forward(model, tokens=toks)
                alike = decode_against_forward(T, model, toks, P, N,
                                               plain_full, tols)
        diff = full[:, P - 1:] - plain_full[:, P - 1:]
        floor_err = float(diff.abs().max())
        floor_rel = float(diff.norm() / plain_full[:, P - 1:].norm())
        del plain_full, diff
        for what, (_, err, rel, agree) in (
                ("decode rounded as forward, against forward through K2",
                 rounded),
                ("decode rounded as forward, against forward through K2's "
                 "plain version", alike)):
            log(f"[llm] bfloat16, {what}: max |diff| {err:.3e} "
                f"({err / DECODE_TOL:.3f} of tests/test_models.py's "
                f"{DECODE_TOL}), worst relative L2 {rel:.3e}; argmax equal "
                f"at {agree} of {B * N}")
        log(f"[llm] bfloat16, forward through K2 against forward through "
            f"its plain version (two correct forwards; K2 rounds P to bf16 "
            f"for P·V): max |diff| {floor_err:.3e}, relative L2 "
            f"{floor_rel:.3e}")
        del full
        trace_llm(torch, T, model, toks, P, 9)


def trace_window(torch, name, fn):
    """A torch.profiler window over ``fn``: wall time (host clock to
    synchronize, with the profiler on), device busy time (the summed time of
    the device's own events: one stream, so they do not overlap) and the
    kernels that take most of it.  Only the profiler's own start and stop
    may fail quietly; a fault of ``fn`` itself ends the run.  Returns
    ``(wall ms, busy ms, device events)``, or None when not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        """Device time of a kernel, memcpy or memset event; 0 for the host
        operations that launched them (counting both would count twice)."""
        if e.device_type == DeviceType.CPU:
            return 0
        return getattr(e, "self_device_time_total", 0) or 0

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as err:
        log(f"[trace] {name}: not measured (profiler start: {err})")
        prof = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    if prof is None:
        return
    try:
        prof.stop()
    except RuntimeError as err:
        log(f"[trace] {name}: not measured (profiler stop: {err})")
        return
    events = [e for e in prof.key_averages() if device_us(e) > 0]
    busy = sum(device_us(e) for e in events) / 1e3
    if busy == 0:
        log(f"[trace] {name}: wall {wall:.2f} ms; device time not "
            f"measured (the profiler saw no device activity)")
        return
    top = sorted(events, key=device_us, reverse=True)[:6]
    parts = ", ".join(f"{e.key[:48]} {device_us(e) / 1e3:.2f} ms "
                      f"x{e.count}" for e in top)
    n_events = sum(e.count for e in events)
    log(f"[trace] {name}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f} %, idle {100 - 100 * busy / wall:.1f}"
        f" %), {n_events} device events; top kernels: {parts}")
    return wall, busy, n_events


def trace_llm(torch, T, model, toks, P, N):
    """:func:`trace_window` over one prefill and then over N - 1 decode
    steps."""
    state = {}

    def run_prefill():
        state["lg"], state["caches"] = T.prefill(
            model, tokens=toks[:, :P], capacity=P + N)

    def run_decode():
        lg, caches = state["lg"], state["caches"]
        for i in range(P, P + N - 1):
            lg, caches = T.decode_step(model, toks[:, i:i + 1], caches)

    with torch.inference_mode():
        trace_window(torch, "prefill B4 x 1024", run_prefill)
        trace_window(torch, f"decode {N - 1} steps", run_decode)


def greedy(torch, T, model, prompts, new_tokens):
    with torch.inference_mode():
        lg, caches = T.prefill(model, tokens=prompts,
                               capacity=prompts.shape[1] + new_tokens)
        logits, toks = [lg], [lg.argmax(-1)]
        for _ in range(new_tokens - 1):
            lg, caches = T.decode_step(model, toks[-1], caches)
            logits.append(lg)
            toks.append(lg.argmax(-1))
    return torch.cat(toks, 1).cpu(), torch.cat(logits, 1).cpu()


def depth2_card_vs_cpu(torch):
    """(c): full width at depth 2 in float32, TF32 off, on the card and on
    the CPU from the same weights.  Tolerance rtol = atol = 1e-4: float32 on
    both sides, the sums taken in other orders (cuBLAS against the CPU's
    BLAS, K2's streaming softmax against the plain one), each ~1e-6
    relative, grown through two layers and the 2048-wide unembedding."""
    from repro_torch import random as jr
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get("llama3.2-1b"), n_layers=2,
                              dtype="float32")
    model = T.init_params(jr.PRNGKey(5), cfg)
    prompts = jr.randint(jr.PRNGKey(6), (4, 128), 0, cfg.vocab,
                         device="cuda")
    before = flash_attention_cuda.launches
    tok_card, lg_card = greedy(torch, T, model, prompts, 8)
    if flash_attention_cuda.launches != before + cfg.n_layers:
        raise AssertionError("depth-2 prefill did not run K2 per layer")
    cpu = T.Transformer(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    del model
    t0 = time.perf_counter()
    tok_cpu, lg_cpu = greedy(torch, T, cpu, prompts.cpu(), 8)
    wall = time.perf_counter() - t0
    if not torch.equal(tok_card, tok_cpu):
        raise AssertionError(f"greedy tokens differ:\n{tok_card}\n"
                             f"{tok_cpu}")
    torch.testing.assert_close(lg_card, lg_cpu, rtol=DEPTH2_TOL,
                               atol=DEPTH2_TOL)
    err = float((lg_card - lg_cpu).abs().max())
    log(f"[llm] depth 2, full width, float32 (TF32 off), batch 4, prompt "
        f"128, 8 new tokens: greedy tokens on the card equal the CPU's; "
        f"logits max |card - cpu| = {err:.3e} (tolerance rtol = atol = "
        f"{DEPTH2_TOL}); cpu {wall:.2f} s")


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------

# the slice's scan shape: Jamba's d_inner and state at batch 4, prompt 1024
MAIN_SCAN = (4, 1024, 16384, 16)
SCAN_TOL = dict(atol=1e-4, rtol=1e-3)     # tests/test_kernels.py, float32


def sfu_rate(torch) -> tuple[float, str]:
    """Exponentials a second: 16 a clock per SM × SMs × the card's maximum
    SM clock (``nvidia-smi``)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 16 * sms * mhz * 1e6, f"{sms} SMs x 16 x {mhz:.0f} MHz"


def scan_inputs(torch, B, S, d, N, x_dtype, dt_dtype, gen):
    """tests/test_kernels.py's distributions on the card: x, B, C normal,
    dt = softplus(normal − 1), A = −exp(0.3·normal), D normal."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    xc = randn(B, S, d).to(x_dtype)
    dt = torch.nn.functional.softplus(randn(B, S, d) - 1).to(dt_dtype)
    Bm, Cm = randn(B, S, N), randn(B, S, N)
    A = -torch.exp(randn(d, N) * 0.3)
    return xc, dt, Bm, Cm, A, randn(d)


def check_scan(torch):
    """K3 against its plain version over every case, y and the final state;
    returns the max |kernel - plain| of y at the slice's shape."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    gen = torch.Generator(device="cuda").manual_seed(4)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(shape, dt, dt) for dt in (f32, bf16)
             for shape in ((1, 64, 128, 16), (2, 256, 512, 16),
                           (1, 128, 256, 8))]
    cases += [(shape, f32, f32) for shape in (
        (3, 77, 1000, 16), (1, 1, 130, 8), (2, 100, 300, 8),
        (1, 33, 64, 16), (1, 2000, 256, 16))]
    # the kernel's edges: d past a multiple of its 64-channel block, S past
    # a multiple of its 32-step chunk, N 8 and 16, every x/dt dtype mix
    cases += [(shape, x_dtype, dt_dtype)
              for shape in ((2, 70, 100, 16), (1, 65, 130, 8))
              for x_dtype in (f32, bf16) for dt_dtype in (f32, bf16)]
    cases += [((2, 70, 256, 16), bf16, f32), (MAIN_SCAN, bf16, f32)]
    worst_y = worst_h = main_err = 0.0
    for shape, x_dtype, dt_dtype in cases:
        xc, dt, Bm, Cm, A, D = scan_inputs(torch, *shape, x_dtype, dt_dtype,
                                           gen)
        if x_dtype != dt_dtype:    # the model's call: B, C column slices
            B, S, _, N = shape
            proj = torch.randn(B, S, 3 * N, generator=gen, device="cuda")
            _, Bm, Cm = proj.split([N, N, N], dim=-1)
        before = selective_scan_cuda.launches
        y, h = ops.selective_scan(xc, dt, Bm, Cm, A, D)
        want_y, want_h = ref.selective_scan_ref(xc, dt, Bm, Cm, A, D)
        torch.cuda.synchronize()
        if selective_scan_cuda.launches != before + 1:
            raise AssertionError("K3 did not launch")
        for got, want in ((y, want_y), (h, want_h)):
            torch.testing.assert_close(got, want, **SCAN_TOL,
                                       msg=lambda m: f"{shape} {x_dtype} "
                                       f"{dt_dtype}: {m}")
        err = float((y - want_y).abs().max())
        worst_y = max(worst_y, err)
        worst_h = max(worst_h, float((h - want_h).abs().max()))
        if shape == MAIN_SCAN:
            main_err = err
        del xc, dt, Bm, Cm, y, h, want_y, want_h
    log(f"[scan] {len(cases)} shape/dtype cases within tolerance (atol "
        f"{SCAN_TOL['atol']}, rtol {SCAN_TOL['rtol']}, tests/test_kernels.py's "
        f"float32 one, also for bf16 inputs: both sides read the same "
        f"values): the sweeps of tests/test_kernels.py in fp32 and bf16, "
        f"ragged S and d, N 8 and 16, S 2000 over 63 staged chunks, the four "
        f"x/dt dtype mixes at d 100 and 130, bf16 x with fp32 dt and strided "
        f"B, C; max |kernel - plain| y "
        f"{worst_y:.3e}, final state {worst_h:.3e}; B4 S1024 d16384 N16 "
        f"(bf16 x): {main_err:.3e}")
    return main_err


def scan_bound(B, S, d, N, x_elem, bandwidth, sfu):
    """(bound ms, 'bytes' | 'operations', bytes, exponentials, flop) of the
    scan: x, dt (float32), B, C, A, D read once, y and h_last written once;
    one exponential and 6 flop per (b, t, c, n), 3 flop per (b, t, c)."""
    nbytes = (B * S * d * (x_elem + 4 + 4) + 2 * B * S * N * 4 + d * N * 4
              + d * 4 + B * d * N * 4)
    exps = B * S * d * N
    flop = 6 * exps + 3 * B * S * d
    t_bytes = nbytes / bandwidth * 1e3
    t_ops = max(exps / sfu, flop / FP32_PEAK) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, exps, flop)


def time_scan(torch, bandwidth, sfu):
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    flush = torch.empty(256 * 2**20 // 4, device="cuda")   # 256 MB > L2
    rows = {}
    for shape, iters in ((MAIN_SCAN, 50), ((1, 4096, 16384, 16), 20),
                         ((1, 32768, 16384, 16), 5)):
        B, S, d, N = shape
        args = scan_inputs(torch, B, S, d, N, torch.bfloat16, torch.float32,
                           gen)
        t_kernel = time_ms(torch, lambda: ops.selective_scan(*args), flush,
                           iters=iters, warmup=2)
        if S <= 4096:
            t_plain = time_ms(torch, lambda: ref.selective_scan_ref(*args),
                              flush, iters=3, warmup=1)
            note = ""
        else:
            t_plain = None
            note = (f" (plain version not run: {S} steps of ~8 launches "
                    f"each)")
        bound, by, nbytes, exps, flop = scan_bound(B, S, d, N, 2, bandwidth,
                                                   sfu)
        rows[shape] = dict(ms=t_kernel, plain_ms=t_plain, library_ms=None,
                           bound_ms=bound, bound_by=by)
        plain_txt = "n/a" if t_plain is None else f"{t_plain:.4f} ms"
        log(f"[scan-time] B={B} S={S} d={d} N={N} bf16 x, fp32 dt: kernel "
            f"{t_kernel:.4f} ms, plain {plain_txt}, library none (no single "
            f"PyTorch call), bound {bound:.4f} ms ({by}: "
            f"{exps / 1e9:.3f} G exp at {sfu / 1e12:.3f} T/s = "
            f"{exps / sfu * 1e3:.4f} ms, {nbytes / 1e6:.1f} MB = "
            f"{nbytes / bandwidth * 1e3:.4f} ms, {flop / 1e9:.2f} GFLOP = "
            f"{flop / FP32_PEAK * 1e3:.4f} ms), kernel at "
            f"{100 * bound / t_kernel:.1f}% of the bound{note}")
        del args
    return rows


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------

JAMBA = "jamba-1.5-large-398b"
# bf16 noise of the period's logits at full width: two correct bf16
# forwards (through K2 and K3 or their plain versions; a batch of 4 or each
# sequence alone) lie 0.117 apart on an H100, as far as decode lies from
# forward (0.125); the limit is about twice that.  float32 is held to
# tests/test_models.py's limits.
JAMBA_BF16_TOL = 0.25


def jamba_period_config():
    """One 8-layer period of Jamba at full width, without experts: every
    layer takes the config's dense SwiGLU (d_ff = the expert width)."""
    from repro_torch.configs import get
    return dataclasses.replace(get(JAMBA), n_layers=8, moe=None)


def jamba_period(torch):
    """(a): the period through generate's function; returns (K3 launches,
    K2 launches) of that run, and the model for (b)."""
    from repro_torch.configs import get
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    from repro_torch.launch import generate
    from repro_torch.models.mamba import _dims
    from repro_torch.obs.telemetry import get_telemetry

    full, cfg = get(JAMBA), jamba_period_config()
    di, dt_rank, N, k = _dims(cfg)
    plan = full.layer_plan()
    n_moe = sum(f == "moe" for _, f in plan)
    expert_gb = (n_moe * full.moe.num_experts * 3 * full.d_model
                 * full.moe.d_ff_expert * 2 / 1e9)
    n_mamba = sum(m == "mamba" for m, _ in plan)
    log(f"[jamba] config {JAMBA} cut: depth {full.n_layers} -> "
        f"{cfg.n_layers} (one period: {n_mamba} mamba layers, attention at "
        f"index {full.mixer_pattern.index('attn')}); experts -> none (the "
        f"{n_moe} MoE layers of a period hold {expert_gb:.1f} GB of expert "
        f"weights in bf16; each layer takes the dense SwiGLU, d_ff "
        f"{cfg.d_ff}); widths as published: d {cfg.d_model}, d_inner {di}, "
        f"N {N}, conv {k}, dt_rank {dt_rank}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads hd {cfg.hd}, vocab {cfg.vocab}; bf16, random weights from "
        f"seed 0")
    get_telemetry().reset()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for kernel in (fl_aggregate_cuda, flash_attention_cuda,
                   selective_scan_cuda):
        kernel.launches = 0
    out = generate.generate(cfg, batch=4, prompt_len=1024, new_tokens=32,
                            seed=0)
    k3, k2 = selective_scan_cuda.launches, flash_attention_cuda.launches
    k1 = fl_aggregate_cuda.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    model = out.pop("model")
    params = sum(p.numel() for p in model.parameters())
    if k3 != n_mamba or k2 != 1:
        raise AssertionError(f"a prefill of the period launched K3 {k3} "
                             f"times (expected {n_mamba}) and K2 {k2} times "
                             f"(expected 1)")
    tokens = out["tokens"]
    if tokens.shape != (4, 32) or not bool(((tokens >= 0)
                                            & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"malformed tokens {tuple(tokens.shape)}")
    init = get_telemetry().span_stats("serve.init")["total_s"]
    log(f"[jamba] period at full width: {params / 1e9:.2f} B params "
        f"({params * 2 / 1e9:.1f} GB bf16), batch 4, prompt 1024, 32 new "
        f"tokens: init {init:.2f} s, prefill (cold) "
        f"{out['prefill_s'] * 1e3:.1f} ms, decode "
        f"{out['decode_s_per_token'] * 1e3:.2f} ms/token, peak memory "
        f"{peak:.2f} GB; K3 launches={k3} (= mamba layers), K2 "
        f"launches={k2} (= attention layers), K1 launches={k1}")
    return k3, model


def jamba_decode_parity(torch, model, dtype):
    """(b): on the card, prefill(t[:1024]) + 31 decode steps against
    forward(t) at S = 1056, for the period at full width.  float32: within
    tests/test_models.py's 2e-2 / 5e-2.  bfloat16: within JAMBA_BF16_TOL,
    printed beside the two distances between correct bf16 forwards that
    set it, measured again in this run (through K2 and K3 against through
    their plain versions; the batch of 4 against each sequence alone, which
    changes only how cuBLAS tiles and rounds the projections, as decode's
    M = 4 does).  Then, in bf16,
    the warm prefill and the profiler window over one prefill and 8 decode
    steps."""
    from repro_torch import random as jr
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as T

    cfg = model.cfg
    tols = (PREFILL_TOL, DECODE_TOL) if dtype == "float32" else (
        JAMBA_BF16_TOL, JAMBA_BF16_TOL)
    B, P, N = 4, 1024, 32
    toks = jr.randint(jr.PRNGKey(2), (B, P + N), 0, cfg.vocab, device="cuda")
    with torch.inference_mode():
        T.prefill(model, tokens=toks[:, :P], capacity=P + N)   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.prefill(model, tokens=toks[:, :P], capacity=P + N)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        full, _ = T.forward(model, tokens=toks)
        worst, err, rel, agree = decode_against_forward(T, model, toks, P, N,
                                                        full, tols)
        log(f"[jamba] {dtype}: on the card, prefill(t[:{P}]) + {N - 1} "
            f"decode steps against forward(t) at S={P + N}: prefill logits "
            f"within {tols[0]} (worst {worst[0]:.3f} of it), decode within "
            f"{tols[1]} (worst {worst[1]:.3f}); max |diff| {err:.3e}, worst "
            f"relative L2 {rel:.3e}, mean |logit| "
            f"{float(full[:, P - 1:].abs().mean()):.3f}; argmax equal at "
            f"{agree} of {B * N}; warm prefill {warm * 1e3:.1f} ms")
        if dtype == "bfloat16":
            tail = full[:, P - 1:]
            with swapped(ops, "flash_attention", ref.flash_attention_ref), \
                    swapped(ops, "selective_scan", ref.selective_scan_ref):
                other, _ = T.forward(model, tokens=toks)
            diff = tail - other[:, P - 1:]
            log(f"[jamba] bfloat16, two correct forwards, through K2 and K3 "
                f"against through their plain versions: max |diff| "
                f"{float(diff.abs().max()):.3e}, relative L2 "
                f"{float(diff.norm() / tail.norm()):.3e}")
            other = torch.cat([T.forward(model, tokens=toks[b:b + 1])[0]
                               for b in range(B)])
            diff = tail - other[:, P - 1:]
            log(f"[jamba] bfloat16, two correct forwards, the batch of {B} "
                f"against each sequence alone: max |diff| "
                f"{float(diff.abs().max()):.3e}, relative L2 "
                f"{float(diff.norm() / tail.norm()):.3e}")
            del other, diff, tail
        del full
        if max(worst) > 1.0:
            raise AssertionError(f"{dtype}: prefill/decode logits differ "
                                 f"from forward beyond the tolerance "
                                 f"({max(worst):.3f} of it)")
        if dtype == "bfloat16":
            trace_llm(torch, T, model, toks, P, 9)


def jamba_float32(torch):
    """(b) in float32: the period at full width (36 GB), seed 1."""
    from repro_torch import random as jr
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(jamba_period_config(), dtype="float32")
    t0 = time.perf_counter()
    model = T.init_params(jr.PRNGKey(1), cfg)
    torch.cuda.synchronize()
    log(f"[jamba] float32 period initialised in "
        f"{time.perf_counter() - t0:.2f} s")
    jamba_decode_parity(torch, model, "float32")


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------

JAMBA_CPU_TOL = dict(rtol=1e-4, atol=5e-5)   # tests/test_torch_transformer.py


def jamba_card_vs_cpu(torch):
    """Reduced Jamba (the whole published plan: 7 Mamba layers, attention,
    MoE with 4 experts on every other layer) in float32, TF32 off, on the
    card and on the CPU from the same weights.  Tolerance rtol 1e-4, atol
    5e-5, the CPU tests' against JAX for this stack: float32 on both sides,
    sums in other orders through eight layers."""
    from repro_torch import random as jr
    from repro_torch.configs import get
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    from repro_torch.models import transformer as T

    cfg = get(JAMBA).reduced()
    model = T.init_params(jr.PRNGKey(7), cfg)
    prompts = jr.randint(jr.PRNGKey(8), (4, 128), 0, cfg.vocab,
                         device="cuda")
    before = selective_scan_cuda.launches
    tok_card, lg_card = greedy(torch, T, model, prompts, 8)
    n_mamba = sum(m == "mamba" for m, _ in cfg.layer_plan())
    if selective_scan_cuda.launches != before + n_mamba:
        raise AssertionError("the reduced prefill did not run K3 per Mamba "
                             "layer")
    cpu = T.Transformer(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    t0 = time.perf_counter()
    tok_cpu, lg_cpu = greedy(torch, T, cpu, prompts.cpu(), 8)
    wall = time.perf_counter() - t0
    if not torch.equal(tok_card, tok_cpu):
        raise AssertionError(f"greedy tokens differ:\n{tok_card}\n"
                             f"{tok_cpu}")
    torch.testing.assert_close(lg_card, lg_cpu, **JAMBA_CPU_TOL)
    err = float((lg_card - lg_cpu).abs().max())
    log(f"[jamba] reduced ({cfg.n_layers} layers, d {cfg.d_model}, MoE "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}), float32 (TF32 "
        f"off), batch 4, prompt 128, 8 new tokens: greedy tokens on the card "
        f"equal the CPU's; logits max |card - cpu| = {err:.3e} (tolerance "
        f"rtol {JAMBA_CPU_TOL['rtol']}, atol {JAMBA_CPU_TOL['atol']}); K3 "
        f"launches={n_mamba} in the prefill; cpu {wall:.2f} s")


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------

XLSTM = "xlstm-125m"
LLAMA = "llama3.2-1b"
# launch.train --arch at K 4 clients, B 2 sequences of S 64 tokens each, 3
# rounds (the CLI's defaults but the rounds): replica mode, one local step
TRAIN_ARGV = ["--rounds", "3", "--clients", "4", "--per-client-batch", "2",
              "--seq-len", "64"]
TRAIN_ROUNDS, TRAIN_K = 3, 4
# reduced float32 configurations, card against CPU (TF32 off): the sums of
# a few layers' products in another order (tests/test_torch_transformer.py
# holds reduced Jamba's logits at atol 5e-5 for the same reason)
TRAIN_CPU_TOL = dict(rtol=1e-4, atol=5e-5)
COLUMN_CHUNK = 1 << 27   # K1's plain version a slice of columns at a time
K1_ULPS = 1   # K1 against its plain version in bf16: inv_k against / K


def kernel_counters():
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    return fl_aggregate_cuda, flash_attention_cuda, selective_scan_cuda


def zero_counts() -> None:
    k1, k2, k3 = kernel_counters()
    k1.launches = k1.subset_launches = k1.guarded_launches = 0
    k2.launches = k3.launches = 0


def read_counts() -> tuple:
    return tuple(k.launches for k in kernel_counters())


@contextlib.contextmanager
def k1_inputs_seen():
    """Keep the inputs and output of the last eq.-3 call of the round
    (``ops.fl_aggregate``, K1's plain mode), to hold K1 at that shape
    after the run."""
    from repro_torch.kernels import ops
    seen, plain_mode = {}, ops.fl_aggregate

    def keep(g, d, mask):
        out = plain_mode(g, d, mask)
        seen.update(g=g, d=d, mask=mask, out=out)
        return out

    ops.fl_aggregate = keep
    try:
        yield seen
    finally:
        ops.fl_aggregate = plain_mode


def train_cli(torch, arch: str):
    """``launch.train.main(["--arch", arch, ...])`` on the card, with every
    kernel count zeroed just before and read just after; returns the final
    state, the rounds' metrics, the wall time, the counts (K1, K2, K3) and
    the peak memory in GB."""
    from repro_torch.launch import train
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    state, rounds = train.main(["--arch", arch] + TRAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if len(rounds) != TRAIN_ROUNDS or not all(
            math.isfinite(r["loss"]) and 0 <= r["participants"] <= TRAIN_K
            for r in rounds):
        raise AssertionError(f"{arch}: malformed rounds {rounds}")
    return state, rounds, wall, counts, peak


def local_step_ms(torch, cfg, state) -> float:
    """One client's forward and backward (``loss_and_grads``) on its row at
    the rounds' batch shape, B 2 × S 64: the median of 3 after a warm-up,
    synchronized host time."""
    from repro_torch.fl.distributed import loss_and_grads
    gen = torch.Generator(device="cuda").manual_seed(13)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                                     device="cuda", dtype=torch.int32)}
    rows = tuple(c[0] for c in state.client_params)
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_and_grads(cfg, rows, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def layer_times(torch, model, cfg):
    """(a): one mLSTM and one sLSTM layer of the generation's model alone,
    forward at batch 4 × 1024 tokens in bf16 (CUDA events, 3 calls)."""
    from repro_torch.models import xlstm
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = (torch.randn(4, 1024, cfg.d_model, generator=gen, device="cuda")
         * 0.5).to(torch.bfloat16)
    out = {}
    with torch.inference_mode():
        for i, fn in ((0, xlstm.mlstm_forward), (1, xlstm.slstm_forward)):
            p = model.layers[i].mixer
            fn(p, cfg, x)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                y = fn(p, cfg, x)
            end.record()
            torch.cuda.synchronize()
            if not bool(torch.isfinite(y).all()):
                raise AssertionError(f"layer {i}: non-finite output")
            out[model.layers[i].mixer_kind] = start.elapsed_time(end) / 3
    return out


def xlstm_full_width(torch):
    """(a) xLSTM-125M, nothing cut: generation through
    ``launch.generate.generate``, its mixers alone, then 3 FL rounds through
    ``launch.train``; returns K1's launches in the rounds."""
    from repro_torch.configs import get
    from repro_torch.fl.distributed import param_count, row_layout
    from repro_torch.launch import generate
    from repro_torch.obs.telemetry import get_telemetry

    cfg = get(XLSTM)
    layout = row_layout(cfg)
    get_telemetry().reset()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    out = generate.generate(cfg, batch=4, prompt_len=1024, new_tokens=32,
                            seed=0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = out["tokens"]
    if tokens.shape != (4, 32) or not bool(((tokens >= 0)
                                            & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"malformed tokens {tuple(tokens.shape)}")
    init = get_telemetry().span_stats("serve.init")["total_s"]
    log(f"[xlstm] {XLSTM} at full width and depth ({cfg.n_layers} layers "
        f"mLSTM/sLSTM, d {cfg.d_model}, {cfg.n_heads} heads, vocab "
        f"{cfg.vocab}; {param_count(cfg):,} params by param_count, rows "
        f"{dict(zip((str(d) for d in layout.dtypes), layout.sizes))}), "
        f"bf16, batch 4, prompt 1024, 32 new tokens: init {init:.2f} s, "
        f"prefill {out['prefill_s'] * 1e3:.1f} ms, decode "
        f"{out['decode_s_per_token'] * 1e3:.2f} ms/token, peak memory "
        f"{peak:.2f} GB; kernel launches (K1, K2, K3) = {counts} (no xLSTM "
        f"kernel, as in JAX)")
    ms = layer_times(torch, out.pop("model"), cfg)
    log(f"[xlstm] one layer alone at B 4 x S 1024 bf16: mLSTM (chunks of "
        f"256) {ms['mlstm']:.2f} ms, sLSTM (1,024 eager steps) "
        f"{ms['slstm']:.2f} ms")
    state, rounds, wall, counts, peak = train_cli(torch, XLSTM)
    k1 = counts[0]
    if k1 != TRAIN_ROUNDS * len(layout.dtypes) or counts[1:] != (0, 0):
        raise AssertionError(f"xLSTM rounds launched (K1, K2, K3) {counts}")
    step = local_step_ms(torch, cfg, state)
    log(f"[xlstm] launch.train --arch {XLSTM} {' '.join(TRAIN_ARGV)}: "
        f"{wall:.2f} s ({wall / TRAIN_ROUNDS:.2f} s a round), peak memory "
        f"{peak:.2f} GB, losses {[round(r['loss'], 4) for r in rounds]}, "
        f"participants {[r['participants'] for r in rounds]}; K1 "
        f"launches={k1} (a round's bf16 and float32 rows); one client's "
        f"local step alone {step:.1f} ms")
    return k1


def llama_training(torch, bandwidth):
    """(b) Llama-3.2-1B FL rounds at full width through ``launch.train``,
    then K1 at the round's shape (R 4 × M 1,235,814,400, bf16) held against
    its plain version to one bf16 ulp on the round's own inputs and timed,
    and held so again on seeded weights and deltas of order 1; returns the
    launch counts and K1's row of the kernels line."""
    from repro_torch.configs import get
    from repro_torch.fl.distributed import mode_for, param_count
    from repro_torch.kernels import ref
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda

    cfg = get(LLAMA)
    P = param_count(cfg)
    mode = mode_for(cfg)
    if mode != "replica":
        raise AssertionError(f"mode_for({LLAMA}) = {mode}")
    with k1_inputs_seen() as seen:
        state, rounds, wall, counts, peak = train_cli(torch, LLAMA)
    k1, k2, k3 = counts
    want = (TRAIN_ROUNDS, TRAIN_ROUNDS * TRAIN_K * cfg.n_layers, 0)
    if counts != want:
        raise AssertionError(f"Llama rounds launched (K1, K2, K3) {counts}, "
                             f"expected {want}")
    log(f"[train] launch.train --arch {LLAMA} {' '.join(TRAIN_ARGV)} (full "
        f"width and depth, bf16, {P:,} params by param_count, mode_for = "
        f"{mode}): {wall:.2f} s ({wall / TRAIN_ROUNDS:.2f} s a round), peak "
        f"memory {peak:.2f} GB, losses "
        f"{[round(r['loss'], 4) for r in rounds]}, participants "
        f"{[r['participants'] for r in rounds]}, energy_j "
        f"{[round(r['energy_j'], 3) for r in rounds]}; K1 launches={k1} "
        f"(= rounds), K2 launches={k2} (= rounds x clients x layers)")
    log(f"[train] one client's local step alone (forward + backward, 16 K2 "
        f"launches and their recompute backward): "
        f"{local_step_ms(torch, cfg, state):.1f} ms")
    del state
    g, d, mask, out = seen["g"], seen["d"], seen["mask"], seen["out"]
    seen.clear()
    torch.cuda.empty_cache()
    R, M = d.shape
    if (R, M, d.dtype) != (TRAIN_K, P, torch.bfloat16):
        raise AssertionError(f"K1 ran at R {R} x M {M} {d.dtype}")
    w = mask.float().contiguous()
    again = fl_aggregate_cuda(g, d, w, 1.0 / R)
    if not torch.equal(again, out):
        raise AssertionError("two K1 launches at the round's shape differ")
    del again
    worst, ulps, n_diff = held_in_slices(torch, out, g, d, mask, "the round")
    log(f"[train] K1 at the round's shape, plain mode R {R} x M {M:,} bf16 "
        f"(R·M = {R * M:,} > 2^32), mask {w.tolist()}: two launches "
        f"bit-equal; against its plain version (in column slices of "
        f"{COLUMN_CHUNK:,}) max |kernel - plain| {worst:.3e}, {n_diff:,} "
        f"elements differ, by at most {ulps} bf16 ulp (limit {K1_ULPS})")
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    lw = (mask / R).to(d.dtype)
    lib = torch.addmv(g, d.T, lw)
    torch.testing.assert_close(lib.float(), out.float(), **TOL["bfloat16"])
    del lib
    t_kernel = time_ms(torch, lambda: fl_aggregate_cuda(g, d, w, 1.0 / R),
                       flush, iters=10, warmup=2)
    t_lib = time_ms(torch, lambda: torch.addmv(g, d.T, lw), flush, iters=10,
                    warmup=2)
    t_plain = time_ms(torch, lambda: ref.fl_aggregate_ref(g, d, mask), flush,
                      iters=3, warmup=1)
    nbytes = (R * M + 2 * M) * d.element_size() + R * 4
    t_bytes = nbytes / bandwidth * 1e3
    t_ops = 2 * R * M / FP32_PEAK * 1e3
    bound = max(t_bytes, t_ops)
    log(f"[kernel-time] plain R={R} M={M} bfloat16 (the Llama round; bound "
        f"{bound:.4f} ms = {nbytes / 1e9:.2f} GB): kernel {t_kernel:.4f} ms "
        f"({100 * bound / t_kernel:.1f}% of the bound), torch.addmv "
        f"{t_lib:.4f} ms, plain {t_plain:.4f} ms (L2 dirty)")
    del out, flush
    # The round's deltas lie far below one bf16 ulp of the weights they are
    # added to, so a kernel that read the wrong element past 2^32 or dropped
    # a row could still round to the same output.  Refill the same buffers
    # with deltas and weights of order 1 that differ in every element, and
    # hold K1 at the same shape, every row counted, to one bf16 ulp.
    gen = torch.Generator(device="cuda").manual_seed(22)
    g.normal_(generator=gen)
    for r in range(R):
        d[r].normal_(generator=gen)
    ones = torch.ones(R, device="cuda")
    out = fl_aggregate_cuda(g, d, ones, 1.0 / R)
    worst_o1, ulps_o1, n_diff_o1 = held_in_slices(torch, out, g, d, ones,
                                                  "deltas of order 1")
    log(f"[train] K1 at R {R} x M {M:,} bf16 on seeded N(0, 1) weights and "
        f"deltas, every row weighted 1: max |kernel - plain| "
        f"{worst_o1:.3e}, {n_diff_o1:,} elements differ, by at most "
        f"{ulps_o1} bf16 ulp (limit {K1_ULPS})")
    del g, d, out
    torch.cuda.empty_cache()
    return counts, dict(shape=f"plain R {R} x M {M} bfloat16",
                        round_launches=k1,
                        max_abs_err=max(worst, worst_o1),
                        max_ulps=max(ulps, ulps_o1),
                        elements_differ=n_diff + n_diff_o1,
                        ms=t_kernel, plain_ms=t_plain, bound_ms=bound,
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations", library_ms=t_lib)


def bf16_ulps(torch, a, b) -> int:
    """The largest distance between two bf16 tensors in bf16 ulps, counted
    on the ordered line of their bit patterns so that it holds across 0."""
    def ordered(x):
        bits = x.view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


def held_in_slices(torch, out, g, d, mask, what):
    """K1's bf16 output against ``ref.fl_aggregate_ref`` a slice of
    ``COLUMN_CHUNK`` columns at a time, each slice finite and within
    ``K1_ULPS``; returns (max |kernel - plain|, max ulps, elements that
    differ)."""
    from repro_torch.kernels import ref
    worst, ulps, n_diff = 0.0, 0, 0
    for c0 in range(0, out.shape[0], COLUMN_CHUNK):
        c1 = min(out.shape[0], c0 + COLUMN_CHUNK)
        plain = ref.fl_aggregate_ref(g[c0:c1], d[:, c0:c1], mask)
        got = out[c0:c1]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K1 on {what}: non-finite output in "
                                 f"columns {c0}:{c1}")
        gap = bf16_ulps(torch, got, plain)
        if gap > K1_ULPS:
            raise AssertionError(f"K1 on {what}: columns {c0}:{c1} differ "
                                 f"from the plain version by {gap} bf16 ulp")
        worst = max(worst, float((got.float() - plain.float()).abs().max()))
        ulps = max(ulps, gap)
        n_diff += int((got != plain).sum())
    return worst, ulps, n_diff


def reduced_batch(torch, cfg, K, B, S, seed):
    """A ``{name: [K, B, ...]}`` batch on the CPU from a seeded generator:
    tokens, or embeds and labels for an ``embeds_input`` configuration."""
    gen = torch.Generator().manual_seed(seed)
    if cfg.embeds_input:
        return {"embeds": torch.randn(K, B, S, cfg.d_model, generator=gen),
                "labels": torch.randint(0, cfg.vocab, (K, B, S),
                                        generator=gen, dtype=torch.int32)}
    return {"tokens": torch.randint(0, cfg.vocab, (K, B, S), generator=gen,
                                    dtype=torch.int32)}


def held_rows(torch, got, want, what):
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, **TRAIN_CPU_TOL, msg=what)
    return max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))


def reduced_training(torch):
    """(c) every reduced configuration, float32, on the card and the CPU
    from the same state and batch: ``loss`` and its gradients, one replica
    round (``fl_train_step``, K 2, mask [1, 0], 2 local steps) and one
    masked-dp round; returns the kernel launches on the card."""
    from repro_torch import random as jr
    from repro_torch.configs import get, names
    from repro_torch.fl import distributed as D

    K, B, S = 2, 2, 16
    totals = [0, 0, 0]
    t0 = time.perf_counter()
    worst = 0.0
    for name in names():
        cfg = get(name).reduced()
        batch = reduced_batch(torch, cfg, K, B, S, seed=len(name))
        mask = torch.tensor([1.0, 0.0])
        probs = torch.tensor([0.5, 0.25])
        runs = {}
        zero_counts()
        for dev in ("cuda", "cpu"):
            b = {n: x.to(dev) for n, x in batch.items()}
            state = D.init_dist_state(jr.PRNGKey(0), cfg, K, device=dev)
            loss, grads = D.loss_and_grads(
                cfg, state.global_params, {n: x[0] for n, x in b.items()})
            rep, m_rep = D.fl_train_step(
                D.DistFLState(*state), cfg, b, mask.to(dev), 0.01,
                local_iters=2)
            mdp_state = D.init_dist_state(jr.PRNGKey(0), cfg, K,
                                          mode="masked_dp", device=dev)
            mdp, m_mdp = D.fl_train_step_masked_dp(
                mdp_state, cfg, b, mask.to(dev), probs.to(dev), 0.01)
            runs[dev] = (loss, grads, rep, m_rep, mdp, m_mdp)
            if dev == "cuda":
                torch.cuda.synchronize()
                counts = read_counts()
        (lc, gc, rc, mrc, dc, mdc), (lp, gp, rp, mrp, dp, mdp_) = \
            runs["cuda"], runs["cpu"]
        torch.testing.assert_close(lc.cpu(), lp, **TRAIN_CPU_TOL)
        err = held_rows(torch, gc, gp, f"{name} gradients")
        for got, want in ((mrc, mrp), (mdc, mdp_)):
            if int(got["participants"]) != int(want["participants"]):
                raise AssertionError(f"{name}: participants differ")
            torch.testing.assert_close(got["loss"].cpu(), want["loss"],
                                       **TRAIN_CPU_TOL)
        err = max(err, held_rows(torch, rc.global_params, rp.global_params,
                                 f"{name} replica global"),
                  held_rows(torch, rc.client_params, rp.client_params,
                            f"{name} replica clients"),
                  held_rows(torch, dc.global_params, dp.global_params,
                            f"{name} masked-dp global"))
        worst = max(worst, err)
        mixers = {m for m, _ in cfg.layer_plan()}
        if counts[0] != len(D.row_layout(cfg).dtypes) or \
                ("attn" in mixers) != (counts[1] > 0) or \
                ("mamba" in mixers) != (counts[2] > 0):
            raise AssertionError(f"{name}: launches (K1, K2, K3) {counts}")
        totals = [a + c for a, c in zip(totals, counts)]
        log(f"[train-reduced] {cfg.name} ({'/'.join(sorted(mixers))}): loss, "
            f"gradients, a replica round and a masked-dp round card = CPU "
            f"(max |card - cpu| {err:.3e}); launches (K1, K2, K3) = {counts}")
    log(f"[train-reduced] all {len(names())} reduced configurations card = "
        f"CPU at rtol {TRAIN_CPU_TOL['rtol']}, atol {TRAIN_CPU_TOL['atol']} "
        f"(worst {worst:.3e}); launches (K1, K2, K3) = {tuple(totals)} in "
        f"{time.perf_counter() - t0:.1f} s")
    return tuple(totals)


def fwd_bwd_ms(torch, fn, inputs, grads, iters=5):
    """ms of ``fn`` forward alone and of forward + backward (CUDA events)."""
    def fwd():
        with torch.no_grad():
            fn(*inputs)

    def both():
        out = fn(*inputs)
        out = out if isinstance(out, tuple) else (out,)
        torch.autograd.grad(out, inputs, grads[:len(out)])

    times = []
    for step in (fwd, both):
        step()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return times


def training_bounds(kind, shape, elem, bandwidth, sfu):
    """(bound ms, 'bytes' | 'operations') of a kernel's forward and
    backward: every input, output and gradient moved once; K2's six
    matmuls over the kept pairs (two forward, four backward) at the
    tensor-core peak of its dtype; K3's exponentials once (on the SFU)
    and three times its forward flop."""
    if kind == "K2":
        B, S, H, KV, hd = shape
        flop = 3 * 4 * B * H * hd * S * (S + 1) / 2
        nbytes = (4 * B * S * H * hd + 4 * B * S * KV * hd) * elem
        t_ops = flop / (BF16_PEAK if elem == 2 else FP32_PEAK) * 1e3
    else:
        B, S, d, N = shape
        fwd_bytes = scan_bound(B, S, d, N, elem, bandwidth, sfu)[2]
        nbytes = 2 * fwd_bytes + B * S * d * 4 + B * d * N * 4
        exps = B * S * d * N
        t_ops = max(exps / sfu, 3 * (6 * exps + 3 * B * S * d)
                    / FP32_PEAK) * 1e3
    t_bytes = nbytes / bandwidth * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def sdpa_ms(torch, q, k, v, g):
    """``scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` on
    the same inputs (its ``[B, H, S, hd]`` layout: transposed views):
    forward, and forward + backward."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa(q_, k_, v_):
        return F.scaled_dot_product_attention(q_, k_, v_, is_causal=True,
                                              enable_gqa=True)
    return fwd_bwd_ms(torch, sdpa, (qt, kt, vt), (g.transpose(1, 2),))


def kernel_gradients(torch, bandwidth, sfu):
    """(c) K2's and K3's custom ops on the card against autograd through
    their plain versions on the same inputs (the forward within phase 4's
    and 6's tolerances, every input's gradient equal: the backward
    recomputes the same plain version), and what the recompute costs:
    forward, forward + backward through the op and through the plain
    version alone; for K2 SDPA's, for both the forward + backward bound."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(11)
    k1, k2, k3 = kernel_counters()
    report = {}
    for B, S, H, KV, hd, dname in ((2, 64, 32, 8, 64, "bfloat16"),
                                   (2, 1024, 32, 8, 64, "bfloat16"),
                                   (2, 16, 4, 1, 64, "float32")):
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device="cuda")
                   .to(dtype).requires_grad_() for n in (H, KV, KV))
        g = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dtype)
        before = k2.launches
        out = ops.flash_attention(q, k, v)
        got = torch.autograd.grad(out, (q, k, v), g)
        want_out = ref.flash_attention_ref(q, k, v)
        want = torch.autograd.grad(want_out, (q, k, v), g)
        if k2.launches != before + 1:
            raise AssertionError("K2's op did not launch K2")
        torch.testing.assert_close(out.float(), want_out.float(),
                                   **TOL[dname])
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        t_fn = fwd_bwd_ms(torch, ops.flash_attention, (q, k, v), (g,))
        t_plain = fwd_bwd_ms(torch, ref.flash_attention_ref, (q, k, v), (g,))
        # SDPA at the shapes the kernels line reports (bf16) only
        t_sdpa = sdpa_ms(torch, q, k, v, g) if dname == "bfloat16" \
            else None
        bound = training_bounds("K2", (B, S, H, KV, hd), q.element_size(),
                                bandwidth, sfu)
        report[("K2", B, S, dname)] = (t_fn, t_plain, t_sdpa, bound)
        log(f"[grad] K2 B {B} S {S} H {H} KV {KV} hd {hd} {dname}: forward "
            f"within tolerance, dq/dk/dv equal to the plain version's "
            f"autograd; forward {t_fn[0]:.3f} ms, forward + recompute "
            f"backward {t_fn[1]:.3f} ms (backward {t_fn[1] - t_fn[0]:.3f} "
            f"ms); plain forward {t_plain[0]:.3f} ms, plain forward + "
            f"backward {t_plain[1]:.3f} ms; "
            + (f"SDPA (is_causal, enable_gqa) forward {t_sdpa[0]:.4f} ms, "
               f"forward + backward {t_sdpa[1]:.4f} ms; " if t_sdpa else "")
            + f"forward + backward bound {bound[0]:.4f} ms ({bound[1]})")
    for B, S, d, N in ((2, 16, 512, 16), (2, 64, 512, 16)):
        xc, dt = (torch.randn(B, S, d, generator=gen, device="cuda")
                  * s for s in (1.0, 0.05))
        dt = dt.abs()
        Bm, Cm = (torch.randn(B, S, N, generator=gen, device="cuda")
                  for _ in range(2))
        A = -torch.arange(1, N + 1, device="cuda", dtype=torch.float32)[
            None].repeat(d, 1)
        D_ = torch.randn(d, generator=gen, device="cuda")
        inputs = tuple(t.requires_grad_() for t in (xc, dt, Bm, Cm, A, D_))
        gy = torch.randn(B, S, d, generator=gen, device="cuda")
        gh = torch.randn(B, d, N, generator=gen, device="cuda")
        before = k3.launches
        y, h = ops.selective_scan(*inputs)
        got = torch.autograd.grad((y, h), inputs, (gy, gh))
        wy, wh = ref.selective_scan_ref(*inputs)
        want = torch.autograd.grad((wy, wh), inputs, (gy, gh))
        if k3.launches != before + 1:
            raise AssertionError("K3's op did not launch K3")
        torch.testing.assert_close(y, wy, **SCAN_TOL)
        torch.testing.assert_close(h, wh, **SCAN_TOL)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        t_fn = fwd_bwd_ms(torch, ops.selective_scan, inputs, (gy, gh))
        t_plain = fwd_bwd_ms(torch, ref.selective_scan_ref, inputs, (gy, gh))
        bound = training_bounds("K3", (B, S, d, N), 4, bandwidth, sfu)
        report[("K3", B, S, "float32")] = (t_fn, t_plain, None, bound)
        log(f"[grad] K3 B {B} S {S} d {d} N {N} float32: y and h_last within "
            f"tolerance, all six gradients equal to the plain version's "
            f"autograd; forward {t_fn[0]:.3f} ms, forward + recompute "
            f"backward {t_fn[1]:.3f} ms (backward {t_fn[1] - t_fn[0]:.3f} "
            f"ms); plain forward {t_plain[0]:.3f} ms, plain forward + "
            f"backward {t_plain[1]:.3f} ms; forward + backward bound "
            f"{bound[0]:.4f} ms ({bound[1]})")
    return report


def training(torch, bandwidth, sfu):
    """Phase 9: (a) xLSTM-125M, (b) Llama-3.2-1B training at full width,
    (c) every reduced configuration card = CPU and K2/K3 under autograd;
    returns the launches on the phase's paths and K1's row at the Llama
    round's shape."""
    from repro_torch.configs import get
    from repro_torch.fl.distributed import param_count

    t0 = time.perf_counter()
    k1_shapes = kernel_counters()[0].shapes
    k1_shapes.clear()
    k1_xlstm = xlstm_full_width(torch)
    torch.cuda.empty_cache()
    (k1_llama, k2_llama, _), k1_row = llama_training(torch, bandwidth)
    reduced = reduced_training(torch)
    shapes = sorted(k1_shapes - {("plain", "bfloat16", TRAIN_K,
                                  param_count(get(LLAMA)))})
    gen = torch.Generator(device="cuda").manual_seed(12)
    worst = max(check_case(torch, mode, dname, R, M, 0, gen)
                for mode, dname, R, M in shapes)
    log(f"[kernel] phase 9 gave K1 {len(shapes) + 1} shapes: the Llama "
        f"round's (held above) and {shapes}, each held against the plain "
        f"version now (worst |kernel - plain| {worst:.3e})")
    grads = kernel_gradients(torch, bandwidth, sfu)
    k1 = k1_xlstm + k1_llama + reduced[0]
    log(f"[train] phase 9 in {time.perf_counter() - t0:.1f} s; launches on "
        f"its paths: K1 {k1} (xLSTM {k1_xlstm}, Llama {k1_llama}, reduced "
        f"{reduced[0]}), K2 {k2_llama + reduced[1]} (Llama {k2_llama}, "
        f"reduced {reduced[1]}), K3 {reduced[2]} (reduced)")
    return {"K1": k1, "K2": k2_llama + reduced[1], "K3": reduced[2],
            "k1_row": k1_row, "grads": grads}


#: phase 10's dry runs on fabricated worlds, on the card's host: one
#: program of each kind on the 16×16 mesh, one on the 2×16×16 mesh, one
#: process a mesh (--batch; --no-probe: the probes would triple them)
PHASE10_DRYRUNS = (("llama3.2-1b", "train_4k", False),
                   ("llama3.2-1b", "prefill_32k", False),
                   ("llama3.2-1b", "decode_32k", False),
                   ("xlstm-125m", "decode_32k", True))


def one_card_check(cfg, lo, hi):
    """Phase 10 (a): the one-rank prediction of Llama-3.2-1B's three
    programs against the same programs on the card, in a new process, and
    each program's outputs against the same program's on plain copies of
    its arguments; returns the record and K1's and K2's launches."""
    from repro_torch.launch import dryrun

    out = dryrun.fresh_check_one_card(LLAMA)
    k1 = sum(rec["measured"]["k1_launches"] for rec in out.values())
    k2 = sum(rec["measured"]["k2_launches"] for rec in out.values())
    record = {}
    for tag, rec in out.items():
        p, m = rec["predicted"], rec["measured"]
        args_p = p["memory"]["argument_allocated_bytes"]
        temp_p = p["memory"]["temp_size_in_bytes"]
        ratio = m["peak_temp_bytes"] / temp_p
        log(f"[launch] {LLAMA} {tag} on one rank: predicted args {args_p} "
            f"B, temp {temp_p} B (cuBLAS workspaces "
            f"{p['memory']['cublas_workspace_bytes']} B of it), "
            f"{p['cost']['flops']} FLOPs; the card args "
            f"{m['allocated_args']} B, peak temp {m['peak_temp_bytes']} B "
            f"(measured / predicted {ratio:.4f}, limit {lo}-{hi}), "
            f"{m['cost']['flops']} FLOPs, {m['seconds'] * 1e3:.1f} ms; "
            f"output {m['out']}; against the program on plain tensors "
            f"{m['plain']}")
        if m["allocated_args"] != args_p:
            raise AssertionError(f"{tag}: argument bytes {m['allocated_args']}"
                                 f" on the card, {args_p} predicted")
        if m["cost"]["flops"] != p["cost"]["flops"]:
            raise AssertionError(f"{tag}: {m['cost']['flops']} FLOPs on the "
                                 f"card, {p['cost']['flops']} predicted")
        if not lo <= ratio <= hi:
            raise AssertionError(f"{tag}: peak temp measured / predicted "
                                 f"{ratio:.4f} outside {lo}-{hi}")
        ints = m["out"]["int_range"]
        if not m["out"]["finite"] or not 0 <= ints[0] <= ints[1] < cfg.vocab:
            raise AssertionError(f"{tag}: malformed output {m['out']}")
        if not m["plain"]["within"]:
            raise AssertionError(f"{tag}: the 1x1-mesh program and the plain "
                                 f"one disagree: {m['plain']}")
        record[tag] = {"args_bytes": args_p, "flops": p["cost"]["flops"],
                       "temp_predicted": temp_p,
                       "temp_measured": m["peak_temp_bytes"],
                       "cublas_workspace_bytes":
                           p["memory"]["cublas_workspace_bytes"],
                       "ratio": ratio, "ms": m["seconds"] * 1e3,
                       "against_plain": m["plain"]}
    want = cfg.n_layers * (1 + TRAIN_K)     # prefill + K clients' forwards
    if k2 != want:
        raise AssertionError(f"K2 launched {k2} times in phase 10 (a), "
                             f"expected {want}")
    if k1 != 1:                  # the training round's one bf16 row
        raise AssertionError(f"K1 launched {k1} times in phase 10 (a), "
                             f"expected 1")
    return record, k1, k2


def launch_layer(torch):
    """Phase 10: the launch layer.  (a) The dry run on a world of one rank
    (a 1×1 mesh on the card) predicts three Llama-3.2-1B programs (prefill
    at B 4 × S 1024, one decode token for B 4 against a full cache of
    1,056, the training round at K 4, B 2, S 64; bf16, full width) and the
    same programs run on the card, in a new process whose allocator starts
    empty (``dryrun.fresh_check_one_card``): argument bytes = the
    allocator's (exactly: ``dryrun.allocator_bytes``), FLOPs =
    ``FlopCounterMode``'s on the card (exactly; K2 by its formula), peak
    temporary bytes (the cuBLAS workspaces of the program's threads
    included) measured over predicted inside ``dryrun.PEAK_RATIO_LIMIT``;
    outputs finite, tokens in range, and equal to the same program's on
    plain copies of its arguments (tokens exactly, floats within
    ``assert_close``'s defaults).  The training round is ``fl_train_step``
    itself, eq. 3 through K1.  (b) Dry runs on fabricated worlds of 256
    and 512 ranks on the card's host, one ``python -m
    repro_torch.launch.dryrun --batch`` process a mesh, run alongside
    (a)."""
    from repro_torch.configs import get
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    cfg = get(LLAMA)
    lo, hi = dryrun.PEAK_RATIO_LIMIT
    runs = []
    with tempfile.TemporaryDirectory() as out_dir:
        # (b) first, on the host's CPU while (a) runs on the card: one
        # process a mesh (torch 2.11 cannot open a second fake world in a
        # process), each running its combinations one after another
        procs = {multi: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--no-probe",
             "--out", out_dir, "--batch", json.dumps(
                 [c for c in PHASE10_DRYRUNS if c[2] == multi])],
            env=dict(os.environ, PYTHONPATH=str(SRC)), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for multi in sorted({c[2] for c in PHASE10_DRYRUNS})}
        try:
            record, k1, k2 = one_card_check(cfg, lo, hi)
        except BaseException:
            for proc in procs.values():
                proc.kill()
                proc.communicate()
            raise
        t1 = time.perf_counter()
        texts = {multi: proc.communicate()[0]
                 for multi, proc in procs.items()}
        for arch, shape, multi in PHASE10_DRYRUNS:
            proc, text = procs[multi], texts[multi]
            mesh = "2x16x16" if multi else "16x16"
            path = os.path.join(out_dir, f"{arch}_{shape}_{mesh}.json")
            rec = {}
            if os.path.exists(path):
                with open(path) as f:
                    rec = json.load(f)
            if proc.returncode != 0 or rec.get("status") != "ok":
                raise AssertionError(f"dry run {arch} x {shape} x {mesh} "
                                     f"failed:\n{text[-2000:]}\n"
                                     f"{rec.get('traceback', '')}")
            runs.append({"arch": arch, "shape": shape, "mesh": mesh,
                         "run_s": rec["run_s"], "flops": rec["cost"]["flops"],
                         "collective_bytes":
                             rec["collectives"]["total_bytes"]})
            log(f"[launch] dry run {arch} x {shape} x {mesh} on "
                f"{rec['devices']} fabricated ranks (torch "
                f"{torch.__version__}): {rec['status']}, build "
                f"{rec['build_s']} s, run {rec['run_s']} s, "
                f"{rec['cost']['flops']:.4e} FLOPs/device, args "
                f"{rec['memory']['argument_size_in_bytes']:.4e} B, temp "
                f"{rec['memory']['temp_size_in_bytes']:.4e} B, collectives "
                f"{rec['collectives']['counts']}")
    log(f"[launch] phase 10 in {time.perf_counter() - t0:.1f} s (one card "
        f"{t1 - t0:.1f} s; the fabricated worlds, run alongside, done "
        f"{time.perf_counter() - t1:.1f} s after); K1 launches={k1} (the "
        f"round's bf16 row), K2 launches={k2} (= {cfg.n_layers} x "
        f"(1 + {TRAIN_K}))")
    return {"k1_launches": k1, "launches": k2, "one_card": record,
            "dry_runs": runs}


# ---------------------------------------------------------------------------
# phase 11: the dense engine's client axis placed over several cards
# ---------------------------------------------------------------------------

PLACE_K, PLACE_T, PLACE_BLOCKS = 1_000, 12, 4
PLACE_SEGMENT = 2 << 20    # a block's allocation rounds up at most this far


@contextlib.contextmanager
def placed_over(engine, devices):
    """``make_runner`` places the client axis over ``devices`` (a repeated
    card gives virtual blocks) where it would build JAX's mesh."""
    from repro_torch.fl import ClientPlacement
    rule = engine._client_mesh
    engine._client_mesh = lambda k, device=None: ClientPlacement(
        tuple(devices), k)
    try:
        yield
    finally:
        engine._client_mesh = rule


def held_placed(np, torch, got, ref, label) -> float:
    """A placed run against the unplaced one: masks, ``last_tx``, eval
    rounds and energies bit for bit; accuracy, loss and the global, client
    and anchor rows within the golden tolerance, NaN in the same places
    (the rows compared on the card); returns the worst float as a share of
    its tolerance."""
    for field in ("participation", "eval_rounds", "energy_per_client",
                  "energy_timeline"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(ref, field),
                                      err_msg=f"{label}: {field}")
    np.testing.assert_array_equal(got.state.last_tx.cpu().numpy(),
                                  ref.state.last_tx.cpu().numpy())
    st = got.state.gathered()
    pairs = [(torch.from_numpy(got.test_acc), torch.from_numpy(ref.test_acc)),
             (torch.from_numpy(got.test_loss),
              torch.from_numpy(ref.test_loss))]
    pairs += [(getattr(st, f), getattr(ref.state, f))
              for f in ("global_params", "client_params", "anchor_params")]
    worst = 0.0
    for a, b in pairs:
        nan = torch.isnan(b)
        if not torch.equal(torch.isnan(a), nan):
            raise AssertionError(f"{label}: NaN in other places")
        share = torch.where(nan, 0.0, (a - b).abs()
                            / (SLICE_ATOL + SLICE_RTOL * b.abs()))
        worst = max(worst, float(share.max()) if share.numel() else 0.0)
    if worst > 1.0:
        raise AssertionError(f"{label}: placed differs from unplaced by "
                             f"{worst:.3f} of rtol {SLICE_RTOL} atol "
                             f"{SLICE_ATOL}")
    return worst


def client_placement(torch):
    """Phase 11: the dense engine's client axis placed over cards (JAX's
    ``shard_clients``).  (a) The paper's MLP at full width on phase 3c
    (b)'s world (K 1,000, 8 examples a client, the device path, T 12 x L
    5 x B 10, continuous mode): unplaced (``shard_clients=False``) and
    placed over 4 virtual blocks of the one card, a random run (eq. 3 = 4
    subset launches a round) and an age-aware run with the age aggregator
    and quarantine (4 weighted launches a round), each placed run held to
    its unplaced one; ms a round of warm runs in turns (unplaced, placed,
    placed, unplaced); K1 held against its plain version at the placed
    shapes.  (b) With two or more cards: ``make_runner``'s default over
    them, held the same way, with each card's ``memory_allocated`` of the
    client and anchor rows against 2·(K/d)·W·4 bytes.  Returns K1's
    launches in the phase's runs by mode."""
    import numpy as np

    import repro_torch.fl.engine as engine
    from repro_torch import random as jr
    from repro_torch.core import CellConfig
    from repro_torch.core.selection import AgeAwareScheme, RandomScheme
    from repro_torch.data import Dataset
    from repro_torch.fl import AggregatorConfig, GuardConfig, SimConfig
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1
    from repro_torch.models.small import init_mlp, mlp_accuracy, mlp_loss

    t_phase = time.perf_counter()
    K, T = PLACE_K, PLACE_T
    store, h = sweep_store(torch, K, "cuda")
    h = h[:, :T]
    gen = torch.Generator(device="cuda").manual_seed(99)
    test = Dataset(torch.randn(2048, 784, generator=gen, device="cuda"),
                   torch.arange(2048, dtype=torch.int32, device="cuda") % 10,
                   10)
    params = init_mlp(jr.PRNGKey(4))
    cell = CellConfig(num_clients=K)
    base = dict(rounds=T, local_iters=5, batch_size=10, eval_every=4,
                data_path="device")
    runs = {"random": (RandomScheme(16 / K, K), SimConfig(**base)),
            "age-aware+age+quarantine": (AgeAwareScheme(16, K), SimConfig(
                **base, aggregator=AggregatorConfig(kind="age"),
                guards=GuardConfig(quarantine=True)))}
    blocks = [torch.device("cuda", torch.cuda.current_device())] \
        * PLACE_BLOCKS
    total = np.zeros(3, int)
    k1.shapes.clear()

    def build(policy, cfg, devices):
        if devices is None:
            return engine.make_runner(mlp_loss, mlp_accuracy, store, test,
                                      policy, cell, cfg, shard_clients=False)
        with placed_over(engine, devices):
            return engine.make_runner(mlp_loss, mlp_accuracy, store, test,
                                      policy, cell, cfg)

    def run(runner, expect, label):
        nonlocal total
        zero_k1(k1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runner(params, h)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = k1_counts(k1)
        if n != expect:
            raise AssertionError(f"{label}: K1 launches (all, subset, "
                                 f"weighted) {n}, not {expect}")
        total += n
        return out, 1e3 * wall / T

    for name, (policy, cfg) in runs.items():
        weighted = cfg.aggregator is not None
        one = (T, 0, T) if weighted else (T, 0, 0)
        many = ((PLACE_BLOCKS * T, 0, PLACE_BLOCKS * T) if weighted
                else (PLACE_BLOCKS * T, PLACE_BLOCKS * T, 0))
        runners = {"unplaced": (build(policy, cfg, None), one),
                   "placed": (build(policy, cfg, blocks), many)}
        ms = {"unplaced": [], "placed": []}
        outs = {}
        for which in ("unplaced", "placed", "placed", "unplaced",
                      "placed", "unplaced"):
            runner, expect = runners[which]
            outs[which], t = run(runner, expect, f"{name} {which}")
            ms[which].append(t)
        placed_rows = outs["placed"].state.client_params
        if len(placed_rows) != PLACE_BLOCKS or any(
                b.shape[0] != K // PLACE_BLOCKS for b in placed_rows):
            raise AssertionError(f"{name}: the client rows are not in "
                                 f"{PLACE_BLOCKS} blocks of {K // PLACE_BLOCKS}")
        worst = held_placed(np, torch, outs["placed"], outs["unplaced"],
                            name)
        if not np.isfinite(outs["placed"].test_acc).all():
            raise AssertionError(f"{name}: non-finite accuracy")
        log(f"[place] (a) {name}, K {K} x T {T} x L 5 x B 10, 784-200-10 "
            f"MLP (W {MAIN_M}), device path: {PLACE_BLOCKS} virtual blocks "
            f"= unplaced: masks, last_tx, eval rounds, energy bit for bit; "
            f"acc, loss, global/client/anchor rows within rtol {SLICE_RTOL} "
            f"atol {SLICE_ATOL} (worst {worst:.3f}); K1 launches a run "
            f"(all, subset, weighted) unplaced {one}, placed {many}; warm "
            f"ms a round (first run cold) unplaced "
            f"{[round(v, 3) for v in ms['unplaced']]}, placed "
            f"{[round(v, 3) for v in ms['placed']]}; final_acc "
            f"{outs['placed'].test_acc[-1]:.4f}")
        del runners, outs, placed_rows
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(11)
    seen = sorted(k1.shapes)
    worst = max(check_case(torch, mode, dname, R, M, offset, gen)
                for mode, dname, R, M in seen for offset in (0, 1))
    log(f"[place] K1 at the placed shapes "
        f"{', '.join(f'{m} {d} R {r} M {c}' for m, d, r, c in seen)} "
        f"against its plain version at both alignments: worst "
        f"|kernel - plain| {worst:.3e}")

    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"[place] (b) did not run: {cards} card visible; "
            f"make_runner's default places the client axis only over two "
            f"or more")
    else:
        policy, cfg = runs["random"]
        place = engine._client_mesh(K)
        d = len(place.devices)
        unplaced_runner = build(policy, cfg, None)
        runner = engine.make_runner(mlp_loss, mlp_accuracy, store, test,
                                    policy, cell, cfg)
        ms = {"unplaced": [], "placed": []}
        for which in ("unplaced", "placed", "placed", "unplaced"):
            if which == "unplaced":
                ref, t = run(unplaced_runner, (T, 0, 0), "(b) unplaced")
            else:
                out, t = run(runner, (d * T, d * T, 0), "(b) placed")
            ms[which].append(round(t, 3))
        del unplaced_runner
        rows = out.state.client_params
        devices = [b.device for b in rows]
        if len(set(devices)) != d or devices != [
                torch.device(x) for x in place.devices]:
            raise AssertionError(f"(b): rows on {devices}, not "
                                 f"{place.devices}")
        worst = held_placed(np, torch, out, ref, "(b)")
        before = [torch.cuda.memory_allocated(x) for x in devices]
        row_bytes = 2 * (K // d) * MAIN_M * 4
        del out, rows
        after = [torch.cuda.memory_allocated(x) for x in devices]
        held = [b - a for b, a in zip(before, after)]
        for x, n in zip(devices[1:], held[1:]):
            if not row_bytes <= n <= row_bytes + 2 * PLACE_SEGMENT:
                raise AssertionError(f"(b) {x}: the rows took {n} bytes, "
                                     f"not 2 (K/d) W 4 = {row_bytes}")
        log(f"[place] (b) make_runner's default over {d} of {cards} cards "
            f"{[str(x) for x in devices]}: = unplaced (worst {worst:.3f}); "
            f"K1 launches {d * T} a run (= {d} x T, subset); ms a round "
            f"(first run cold) unplaced {ms['unplaced']}, placed "
            f"{ms['placed']}; "
            f"client + anchor rows on each card {held} bytes against "
            f"2 (K/d) W 4 = {row_bytes} (the first card also holds the "
            f"global row, the ledgers and the run's outputs)")
        del runner
    del store, h, test
    torch.cuda.empty_cache()
    log(f"[place] phase 11 in {time.perf_counter() - t_phase:.1f} s; K1 "
        f"launches (all, subset, weighted) {tuple(int(v) for v in total)}")
    return {"launches": int(total[0]),
            "by_mode": {"plain": int(total[0] - total[1] - total[2]),
                        "subset": int(total[1]), "weighted": int(total[2])}}


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
    max_err, checked = check_kernel(torch)
    timing = time_kernel(torch, bandwidth)
    t0 = time.perf_counter()
    sgd_timing = time_mlp_sgd(torch, bandwidth)
    log(f"[mlp-sgd] phase 2b in {time.perf_counter() - t0:.1f} s")
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda
    fl_aggregate_cuda.shapes.clear()
    launches, world = slice_runs(torch)
    panel, panel_weighted = panel_runs(torch, world)
    t0 = time.perf_counter()
    sparse = sparse_runs(torch, world) + population_sweep(torch)
    log(f"[sparse] phase 3c in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    faulty, poison = faults_and_matrices(torch, world)
    log(f"[faults] phase 3d in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    data = data_and_resume(torch, world)
    log(f"[data] phase 3e in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    obs = observability(torch, world)
    log(f"[obs] phase 3f in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    entry = serve_and_entry(torch)
    log(f"[serve] phase 3g in {time.perf_counter() - t0:.1f} s")
    check_main_shapes(torch, checked)
    sparse = sparse + faulty + data + obs + entry
    k1_modes = {"plain": launches + panel - panel_weighted
                + int(sparse[0] - sparse[1] - sparse[2]),
                "subset": int(sparse[1]),
                "weighted": panel_weighted + int(sparse[2])}
    launches += panel + int(sparse[0])
    attn_err = check_flash(torch)
    attn_timing = time_flash(torch, bandwidth)
    attn_launches = generate_full_width(torch)
    prefill_decode_parity(torch, "float32")
    depth2_card_vs_cpu(torch)
    prefill_decode_parity(torch, "bfloat16")
    sfu, sfu_name = sfu_rate(torch)
    log(f"[env] K3's bound uses the SFU rate {sfu_name} = "
        f"{sfu / 1e12:.3f} T exp/s")
    scan_err = check_scan(torch)
    scan_timing = time_scan(torch, bandwidth, sfu)
    scan_launches, model = jamba_period(torch)
    jamba_decode_parity(torch, model, "bfloat16")
    del model
    torch.cuda.empty_cache()
    jamba_float32(torch)
    torch.cuda.empty_cache()
    jamba_card_vs_cpu(torch)
    torch.cuda.empty_cache()
    train = training(torch, bandwidth, sfu)
    torch.cuda.empty_cache()
    launch = launch_layer(torch)
    torch.cuda.empty_cache()
    placement = client_placement(torch)
    k2_train = train["grads"][("K2", 2, 64, "bfloat16")]
    k2_train_1024 = train["grads"][("K2", 2, 1024, "bfloat16")]
    k3_train = train["grads"][("K3", 2, 16, "float32")]
    kernels = {"kernels": [{
        "name": "fl_aggregate",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fl_aggregate.cu",
        "replaces": "src/repro/kernels/fl_aggregate.py:43",
        "launches": launches,
        "launches_by_mode": k1_modes,
        "phase_3g_by_mode": {
            "plain": int(entry[0] - entry[1] - entry[2]),
            "subset": int(entry[1]), "weighted": int(entry[2])},
        "nonfinite_rows": poison,
        "max_abs_err": max_err,
        **timing[("plain", K, MAIN_M, "float32")],
        "phase_9": {**train["k1_row"], "launches": train["K1"]},
        "phase_10": {"launches": launch["k1_launches"]},
        "phase_11": placement,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:79",
        "launches": attn_launches,
        "max_abs_err": attn_err,
        **attn_timing[MAIN_ATTN],
        "phase_9": {"launches": train["K2"],
                    "shape": "B 2 S 64 H 32 KV 8 hd 64 bfloat16",
                    "forward_ms": k2_train[0][0],
                    "forward_recompute_backward_ms": k2_train[0][1],
                    "plain_forward_backward_ms": k2_train[1][1],
                    "sdpa_forward_ms": k2_train[2][0],
                    "sdpa_forward_backward_ms": k2_train[2][1],
                    "forward_backward_bound_ms": k2_train[3][0],
                    "forward_backward_bound_by": k2_train[3][1],
                    "s1024": {
                        "forward_ms": k2_train_1024[0][0],
                        "forward_recompute_backward_ms":
                            k2_train_1024[0][1],
                        "plain_forward_backward_ms": k2_train_1024[1][1],
                        "sdpa_forward_ms": k2_train_1024[2][0],
                        "sdpa_forward_backward_ms": k2_train_1024[2][1],
                        "forward_backward_bound_ms": k2_train_1024[3][0],
                        "forward_backward_bound_by": k2_train_1024[3][1]}},
        "phase_10": {key: value for key, value in launch.items()
                     if key != "k1_launches"},
    }, {
        "name": "selective_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/kernels/selective_scan.py:66",
        "launches": scan_launches,
        "max_abs_err": scan_err,
        **scan_timing[MAIN_SCAN],
        "phase_9": {"launches": train["K3"],
                    "shape": "B 2 S 16 d 512 N 16 float32",
                    "forward_ms": k3_train[0][0],
                    "forward_recompute_backward_ms": k3_train[0][1],
                    "plain_forward_backward_ms": k3_train[1][1],
                    "forward_backward_bound_ms": k3_train[3][0],
                    "forward_backward_bound_by": k3_train[3][1]},
    }, {
        "name": "mlp_local_sgd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlp_sgd.cu",
        "replaces": None,
        "launches": world["mlp_sgd_launches"],
        **sgd_timing[MLP_SGD_SHAPES[0]],
        "bucket_2048": sgd_timing[MLP_SGD_SHAPES[1]],
    }]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all; K1 timings "
        f"at R={K}, M={MAIN_M} fp32 (L2 dirty) and, in phase_9, at the "
        f"Llama round's R 4 x M 1,235,814,400 bf16; K2 at B4 S1024 H32 KV8 "
        f"hd64 bf16, K3 at B4 S1024 d16384 N16 (bf16 x), on {smi}")
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
