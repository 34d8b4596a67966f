"""The multi-device dry run (deliverable (e)).  Counterpart of
``repro.launch.dryrun``.

For every (architecture × input shape × mesh) combination, JAX lowers and
compiles the program on 512 fabricated host devices and records XLA's
memory and cost analyses and the collectives of the optimized HLO.  The
port opens a fake process group of 256 or 512 ranks (``mesh.fabricate_
world``: collectives return at once), builds the program's arguments as
fake DTensors (``specs.input_specs``) and runs the program once, eagerly,
under ``FakeTensorMode`` as rank 0, recording:

* ``memory``: argument, output and peak temporary bytes on this device,
  from the local shards, and from a tracker of the fake tensors' storages
  (each rounded up to the CUDA caching allocator's 512-byte blocks);
* ``cost.flops``: this device's FLOPs, from ``FlopCounterMode`` counting
  the local operations under DTensor (K2 through its FLOP formula);
* ``collectives``: counts and result bytes by kind of the functional
  collectives DTensor issues (``CollectiveCounter``, a dispatch mode that
  lets DTensor run first, as ``CommDebugMode`` does);
* ``explicit_redistributions``: the gathers and GQA expansions that
  ``models/pshard.py`` made where GSPMD reshards silently;
* ``cost_probe``: 1- and 2-super-block programs under
  ``costmode.cost_probe()``, and JAX's total ``M1 + (R−1)(M2 − M1)``.

``build_s``/``run_s`` (building the arguments, running the program) take
the place of JAX's ``lower_s``/``compile_s``.  What has no counterpart:
JAX's ``collective_bytes``/``_bytes_of_shape`` parse XLA's HLO text, which
an eager run does not have (the collectives are counted as they are
issued), and XLA counts a scan body once, which ``costmode`` corrects in
JAX; the port's eager run counts every operation, so its probe total
equals the full-depth count.

A combination that fails is recorded as data, and the run exits 1 if any
failed.  :func:`check_one_card` predicts programs on a world of one rank
(a 1×1 mesh) for ``chip_smoke.py`` to hold against the card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      [--out artifacts/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --no-probe \\
      --batch '[["llama3.2-1b", "decode_32k", false], ["xlstm-125m", \\
      "decode_32k", true]]'
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import time
import traceback
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import configs
from ..configs.shapes import SHAPES
from ..models import pshard
from ..models.costmode import cost_probe

#: the CUDA caching allocator's block: every allocation rounds up to it
BLOCK = 512

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def rounded(nbytes: int) -> int:
    return -(-nbytes // BLOCK) * BLOCK


_MIB = 1 << 20


def allocator_bytes(sizes) -> int:
    """The bytes the CUDA caching allocator counts as allocated after it
    serves requests of ``sizes`` bytes, in order, starting empty, with
    nothing freed: PyTorch's rules — each request rounded up to 512
    bytes; up to 1 MiB from 2 MiB segments, above from 20 MiB segments
    (below 10 MiB) or segments of the request rounded up to 2 MiB; the
    smallest free block that fits is used first; a block is split when
    what remains is at least 512 bytes (small pool) or more than 1 MiB
    (large pool), else handed out whole.  A 525 MB embedding table, for
    one, takes its segment's last 1 MiB with it."""
    pools = {True: [], False: []}
    total = 0
    for n in sizes:
        if n == 0:
            continue
        size = rounded(max(n, 1))
        small = size <= _MIB
        free = pools[small]
        fits = [b for b in free if b >= size]
        if fits:
            block = min(fits)
            free.remove(block)
        elif small:
            block = 2 * _MIB
        else:
            block = 20 * _MIB if size < 10 * _MIB else \
                -(-size // (2 * _MIB)) * (2 * _MIB)
        rest = block - size
        if rest >= BLOCK if small else rest > _MIB:
            free.append(rest)
            block = size
        total += block
    return total


def _is_dtensor_call(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


_SHADOW = [0]


def _shadow() -> bool:
    """True inside DTensor's sharding propagation, which runs an operation
    on global-shape fake tensors to learn its output's shape: the fake
    mode runs after every user mode, so the trackers see those operations
    and must not count them (:func:`_instrumented` keeps the count)."""
    return _SHADOW[0] > 0


def _local_tensors(tree) -> list:
    """The plain (local) tensors of a pytree of tensors and DTensors."""
    from torch.utils._pytree import tree_leaves
    out = []
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            out.append(t.to_local() if pshard.is_dtensor(t) else t)
    return out


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def storage_sizes(tree) -> list:
    """Bytes of the distinct storages of the local tensors of ``tree``, in
    the order of its leaves."""
    seen = {}
    for t in _local_tensors(tree):
        seen.setdefault(_storage_key(t), t.untyped_storage().nbytes())
    return list(seen.values())


def tree_bytes(tree, allocator: bool = True) -> int:
    """Bytes of the distinct storages of the local tensors of ``tree``
    (rounded to the allocator's blocks when ``allocator``)."""
    return sum(rounded(n) if allocator else n for n in storage_sizes(tree))


class MemoryTracker(TorchDispatchMode):
    """Live bytes of the storages that operations create, local shards
    under DTensor (it lets DTensor run first and sees the local
    operations), each rounded to the allocator's block and freed when the
    last tensor on it dies; ``peak`` is the most live at once.  An op's
    body is out of a dispatch mode's sight: the recompute backwards of K2
    and K3 report theirs through :meth:`body` (``ops.BODY_TRACKER``), on
    real tensors from the body itself and on fake ones from the op's fake
    implementation."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.inside = False
        self._refs: dict = {}

    @contextlib.contextmanager
    def body(self):
        """Track an op's body with a tracker of its own (yielded), pushed
        above the modes in force; its peak on top of what is live now
        counts here."""
        nested = MemoryTracker()
        self.inside = True
        try:
            with nested:
                yield nested
        finally:
            self.inside = False
        self.transient(nested.peak)

    def transient(self, nbytes: int) -> None:
        """``nbytes`` held for a moment on top of what is live now."""
        self.peak = max(self.peak, self.live + nbytes)

    def _release(self, key, nbytes):
        n = self._refs.get(key, 0) - 1
        if n <= 0:
            self._refs.pop(key, None)
            self.live -= nbytes
        else:
            self._refs[key] = n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_call(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if _shadow():
            return out
        from torch.utils._pytree import tree_leaves
        inputs = {_storage_key(t) for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor) and t.layout == torch.strided
                  and not t.is_sparse}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or t.layout != torch.strided \
                    or t.device.type == "meta":
                continue
            key = _storage_key(t)
            if key in inputs and key not in self._refs:
                continue        # a view or an in-place result of an input
            nbytes = rounded(t.untyped_storage().nbytes())
            if key not in self._refs:
                self.live += nbytes
                self.peak = max(self.peak, self.live)
                self._refs[key] = 0
            self._refs[key] += 1
            weakref.finalize(t, self._release, key, nbytes)
        return out


def flop_counter():
    """``FlopCounterMode`` counting this device's FLOPs: under DTensor it
    counts the local operations (shard shapes), not the global ones."""
    from torch.utils import flop_counter as fc

    class _Local(fc._FlopCounterMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _is_dtensor_call(types):
                return NotImplemented
            if _shadow():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    class LocalFlopCounterMode(fc.FlopCounterMode):
        def __enter__(self):
            self.flop_counts.clear()
            self.mod_tracker.__enter__()
            self.mode = _Local(self)
            self.mode.__enter__()
            return self

    return LocalFlopCounterMode(display=False)


_NAMESPACES = ("_c10d_functional", "c10d_functional",
               "_c10d_functional_autograd", "c10d")
_KINDS = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("_allgather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
          ("_reduce_scatter", "reduce-scatter"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("broadcast", "collective-permute"), ("send", "collective-permute"),
          ("recv", "collective-permute"))


def _kind(func) -> str | None:
    if getattr(func, "namespace", None) not in _NAMESPACES:
        return None
    name = func._overloadpacket.__name__
    for prefix, kind in _KINDS:
        if name.startswith(prefix):
            return kind
    return None


class CollectiveCounter(TorchDispatchMode):
    """Counts and result bytes, by kind, of the collectives DTensor issues
    (the functional collectives on local shards; it lets DTensor run first,
    as ``CommDebugMode`` does, whose module tracker fails when a backward
    pass runs inside a module's forward).  JAX's ``collective_bytes`` sums
    the result shapes too."""

    def __init__(self):
        super().__init__()
        self.counts = Counter()
        self.bytes = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_call(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = _kind(func)
        if kind is not None and not _shadow():
            from torch.utils._pytree import tree_leaves
            res = out if func.namespace != "c10d" else args[0]
            self.counts[kind] += 1
            self.bytes[kind] += sum(t.numel() * t.element_size()
                                    for t in tree_leaves(res)
                                    if isinstance(t, torch.Tensor))
        return out

    def summary(self) -> dict:
        b = {k: int(self.bytes.get(k, 0)) for k in _COLLECTIVES}
        c = {k: int(self.counts.get(k, 0)) for k in _COLLECTIVES}
        return {"bytes": b, "counts": c, "total_bytes": sum(b.values())}


def _patch(cls, name: str, wrap):
    """Replace ``cls.name`` by ``wrap`` of it (a static or class method
    stays one); returns the undo."""
    import inspect
    raw = inspect.getattr_static(cls, name, None)
    if raw is None:
        return lambda: None
    kind = type(raw) if isinstance(raw, (staticmethod, classmethod)) else None
    new = wrap(raw.__func__ if kind else raw)
    setattr(cls, name, kind(new) if kind else new)
    return lambda: setattr(cls, name, raw)


@contextlib.contextmanager
def _instrumented():
    """Two patches of DTensor internals for a fake run:

    * its sharding propagation's shape-only runs are flagged
      (:func:`_shadow`), so the trackers skip them;
    * a strided shard's offsets are worked out with small index tensors
      read on the host, which under ``FakeTensorMode`` would be fake and
      unreadable: they are made with every mode off (real CPU tensors of
      at most one dim's length)."""
    from torch.distributed.tensor import placement_types as pt
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    def flagged(orig):
        def run(*args, **kwargs):
            _SHADOW[0] += 1
            try:
                return orig(*args, **kwargs)
            finally:
                _SHADOW[0] -= 1
        return run

    def modes_off(orig):
        def run(*args, **kwargs):
            with _disable_current_modes():
                return orig(*args, **kwargs)
        return run


    undo = [_patch(ShardingPropagator, name, flagged)
            for name in ("_propagate_tensor_meta_non_cached",
                         "_propagate_tensor_meta")]
    if hasattr(pt, "_StridedShard"):
        undo.append(_patch(pt._StridedShard, "local_shard_size_and_offset",
                           modes_off))
    try:
        yield
    finally:
        for u in reversed(undo):
            u()


#: bytes of the cuBLAS workspace that PyTorch takes from the caching
#: allocator for each thread's handle at its first product on a Hopper card
#: (``CUBLAS_WORKSPACE_CONFIG``'s default ``:4096:8``, 8 × 4,096 KiB; seen
#: on the H100 80GB HBM3 at 700 W in ``chip_smoke.py`` phase 10)
CUBLAS_WORKSPACE = 32 * _MIB


def cublas_workspaces(kind: str) -> int:
    """The threads that run products in a program of ``kind``, each with a
    workspace of its own: the caller's, and for a train program the
    autograd engine's device thread, which runs the backward."""
    return 2 if kind == "train" else 1


def run_program(spec, card: bool = True) -> dict:
    """Run ``spec.fn(*spec.args)`` once under its fake mode (if any) with
    the trackers; returns the memory, cost and collective records.
    ``card``: the program is for a card, so the peak takes the cuBLAS
    workspaces of its threads (:data:`CUBLAS_WORKSPACE` each) too."""
    from torch.distributed.tensor.experimental import implicit_replication
    from ..kernels import ops
    from ..models import xlstm
    ops.register_sharding_rules()
    xlstm.register_sharding_rules()
    fake = spec.meta.get("fake_mode")
    pshard.REDISTRIBUTIONS.clear()
    mem, flops, comm = MemoryTracker(), flop_counter(), CollectiveCounter()
    args_bytes = tree_bytes(spec.args)
    # storages are freed as their last reference goes, never when the
    # cycle collector happens to run: the peak is then the program's own
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    ops.BODY_TRACKER[0] = mem
    try:
        with (fake or contextlib.nullcontext()), _instrumented(), \
                implicit_replication(), comm, flops, mem:
            out = spec.fn(*spec.args)
            out_bytes = tree_bytes(out)
    finally:
        ops.BODY_TRACKER[0] = None
        if collecting:
            gc.enable()
    workspace = CUBLAS_WORKSPACE * cublas_workspaces(spec.meta["kind"]) \
        if card else 0
    return {"memory": {"argument_size_in_bytes": args_bytes,
                       "argument_bytes_unrounded": tree_bytes(
                           spec.args, allocator=False),
                       "argument_allocated_bytes": allocator_bytes(
                           storage_sizes(spec.args)),
                       "output_size_in_bytes": out_bytes,
                       "temp_size_in_bytes": mem.peak + workspace,
                       "cublas_workspace_bytes": workspace},
            "cost": {"flops": int(flops.get_total_flops())},
            "collectives": comm.summary(),
            "explicit_redistributions": dict(pshard.REDISTRIBUTIONS),
            "out": out}


def cost_probes(arch: str, shape_name, mesh, mode: str, **kw) -> dict:
    """1- and 2-super-block probes under ``cost_probe()``: total-per-device
    metric ``M(R) = M1 + (R−1)·(M2 − M1)``, JAX's formula."""
    from .specs import input_specs
    cfg = kw.pop("cfg_override", None) or configs.get(arch, shape_name
                                                      if isinstance(
                                                          shape_name, str)
                                                      else shape_name.name)
    sb = len(cfg.mixer_pattern)
    out = {"n_repeats": cfg.n_repeats, "superblock": sb}
    with cost_probe():
        for tag, layers in (("m1", sb), ("m2", 2 * sb)):
            c = dataclasses.replace(cfg, n_layers=layers)
            spec = input_specs(arch, shape_name, mesh, cfg_override=c,
                               mode_override=None if mode == "-" else mode,
                               **kw)
            rec = run_program(spec)
            out[tag] = {"flops": rec["cost"]["flops"],
                        "collectives": rec["collectives"]}
    r = cfg.n_repeats
    m1, m2 = out["m1"], out["m2"]
    c1, c2 = m1["collectives"], m2["collectives"]
    out["total"] = {
        "flops": m1["flops"] + (r - 1) * (m2["flops"] - m1["flops"]),
        "collective_bytes": c1["total_bytes"]
        + (r - 1) * (c2["total_bytes"] - c1["total_bytes"]),
        "collective_bytes_by_kind": {
            k: c1["bytes"][k] + (r - 1) * (c2["bytes"][k] - c1["bytes"][k])
            for k in c1["bytes"]},
    }
    return out


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_one(arch: str, shape_name: str, multi_pod: bool,
            verbose: bool = True, probe: bool = True) -> dict:
    """One combination on the production mesh (the fabricated world of
    256 or 512 ranks must be open)."""
    from .mesh import make_production_mesh
    from .specs import input_specs
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": mesh_name(multi_pod), "devices": int(mesh.size()),
                 "status": "ok", "kind": SHAPES[shape_name].kind}
    t0 = time.time()
    try:
        spec = input_specs(arch, shape_name, mesh)
        rec["mode"] = spec.meta.get("mode", "-")
        t1 = time.time()
        res = run_program(spec)
        del res["out"], spec
        t2 = time.time()
        rec.update({"build_s": round(t1 - t0, 2), "run_s": round(t2 - t1, 2),
                    **res})
        if probe:
            rec["cost_probe"] = cost_probes(arch, shape_name, mesh,
                                            rec["mode"])
            rec["probe_s"] = round(time.time() - t2, 2)
        if verbose:
            m = rec["memory"]
            print(f"[dryrun] {arch} × {shape_name} × {rec['mesh']}: OK "
                  f"(build {rec['build_s']}s, run {rec['run_s']}s)")
            print(f"  memory: args {m['argument_size_in_bytes']:.4e} B, "
                  f"temp {m['temp_size_in_bytes']:.4e} B, out "
                  f"{m['output_size_in_bytes']:.4e} B")
            print(f"  cost: flops/device={rec['cost']['flops']:.4e}")
            c = rec["collectives"]
            print("  collectives:", c["counts"], "→",
                  f"{c['total_bytes'] / 1e6:.1f} MB/device",
                  rec["explicit_redistributions"] or "")
    except Exception as e:  # noqa: BLE001 — record failures as data
        rec["status"] = "fail"
        rec.setdefault("mode", "-")
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
        rec["seconds"] = round(time.time() - t0, 2)
        if verbose:
            print(f"[dryrun] {arch} × {shape_name} × {rec['mesh']}: FAIL "
                  f"{rec['error'][:300]}")
    return rec


#: measured over predicted peak temporary bytes of a program on one card:
#: the limit ``chip_smoke.py`` phase 10 holds (set before the first chip
#: run; the CUDA caching allocator may serve a request from a larger free
#: block, so the measured peak may only run somewhat above the prediction)
PEAK_RATIO_LIMIT = (0.90, 1.25)


def one_card_programs() -> dict:
    """The programs ``chip_smoke.py`` phase 10 predicts and runs on one
    card, at phase 5's and phase 9's settings: Llama-3.2-1B prefill at B 4
    × S 1024, decode of one token for B 4 against a full cache of 1,056
    (1,024 + 32 new tokens), and the training round at K 4, B 2, S 64."""
    from ..configs.shapes import InputShape
    return {"prefill": InputShape("prefill_4x1024", 1024, 4, "prefill"),
            "decode": InputShape("decode_4x1056", 1056, 4, "decode"),
            "train": InputShape("train_4x2x64", 64, 8, "train")}


def real_maker(device, seed: int = 0):
    """``make(shape, dtype)`` of real local shards on ``device``: float
    leaves N(0, 0.02²), integer leaves (tokens) zeros; one allocation a
    leaf, nothing else."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(shape, dtype):
        t = torch.empty(shape, dtype=dtype, device=device)
        if dtype.is_floating_point:
            return t.normal_(0.0, 0.02, generator=gen)   # no temporary
        return t.zero_()
    return make


def check_one_card(arch: str, programs: dict | None = None, clients: int = 4,
                   device_type: str = "cuda", cfg_override=None) -> dict:
    """Predict ``programs`` (``{tag: InputShape}``, by default
    :func:`one_card_programs`) of ``arch`` on a world of one rank (a 1×1
    mesh): each one's argument bytes (rounded to the allocator's blocks),
    peak temporary bytes (the cuBLAS workspaces too, on the card) and
    FLOPs; then run the same program on real tensors on the device, with
    the same trackers: argument bytes from ``torch.cuda.memory_allocated()``
    around building them, FLOPs from the same ``FlopCounterMode``, the
    peak from ``torch.cuda.max_memory_allocated()``; and the program once
    more on plain copies of its arguments, whose outputs the DTensor run's
    are held against (:func:`_compare`).  Opens and closes the world
    (``fabricate_world(1)``)."""
    from .mesh import AXES, close_world, fabricate_world, make_mesh
    from .specs import input_specs
    programs = programs or one_card_programs()
    fabricate_world(1)
    out = {}
    try:
        mesh = make_mesh((1, 1), AXES, device_type)
        for tag, shape in programs.items():
            spec = input_specs(arch, shape, mesh, clients=clients,
                               device_type=device_type,
                               cfg_override=cfg_override)
            rec = {"predicted": run_program(spec,
                                            card=device_type == "cuda")}
            del rec["predicted"]["out"], spec
            rec["measured"] = _measure(arch, shape, mesh, clients,
                                       device_type, cfg_override)
            out[tag] = rec
    finally:
        close_world()
    return out


def fresh_check_one_card(arch: str, programs: dict | None = None,
                         clients: int = 4, reduced: dict | None = None,
                         dtype: str | None = None) -> dict:
    """:func:`check_one_card` on the card in a new process, whose CUDA
    caching allocator starts empty, so that the argument bytes it counts
    are :func:`allocator_bytes` of the arguments alone.  ``reduced`` (the
    keyword arguments of ``ArchConfig.reduced``) and ``dtype`` cut the
    config; ``programs`` are ``{tag: (seq_len, global_batch, kind)}``."""
    import subprocess
    import sys
    job = {"arch": arch, "clients": clients, "reduced": reduced,
           "dtype": dtype,
           "programs": {t: [s.seq_len, s.global_batch, s.kind]
                        for t, s in (programs or one_card_programs()).items()}}
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--one-card",
         json.dumps(job)], env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"one-card check failed:\n{proc.stdout[-4000:]}"
                           f"\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _one_card_job(job: dict) -> dict:
    from ..configs.shapes import InputShape
    cfg = None
    if job["reduced"] is not None:
        cfg = configs.get(job["arch"]).reduced(**job["reduced"])
    if job["dtype"] is not None:
        cfg = dataclasses.replace(cfg or configs.get(job["arch"]),
                                  dtype=job["dtype"])
    programs = {t: InputShape(t, *v) for t, v in job["programs"].items()}
    return check_one_card(job["arch"], programs, clients=job["clients"],
                          cfg_override=cfg)


def _measure(arch, shape, mesh, clients, device_type, cfg_override) -> dict:
    """The program on real tensors.  On the card its argument bytes and
    peak come from the CUDA caching allocator; elsewhere from the same
    trackers as the prediction's.  The launches of K1 and K2 are counted
    over this run alone."""
    from torch.utils._pytree import tree_map
    from ..kernels.fl_aggregate import fl_aggregate_cuda
    from ..kernels.flash_attention import flash_attention_cuda
    from .specs import input_specs
    cuda = torch.cuda if device_type == "cuda" else None
    if cuda:
        cuda.synchronize()
        m0 = cuda.memory_allocated()
    spec = input_specs(arch, shape, mesh, clients=clients,
                       make=real_maker(device_type),
                       cfg_override=cfg_override)
    if cuda:
        cuda.synchronize()
        args = cuda.memory_allocated() - m0
    else:
        args = tree_bytes(spec.args)
    # the plain run's arguments: copies of the local tensors, made before
    # the run changes any in place
    plain = tree_map(lambda t: _local(t).clone()
                     if isinstance(t, torch.Tensor) else t, spec.args)
    if cuda:
        # the program takes its own cuBLAS workspaces, as predicted
        torch._C._cuda_clearCublasWorkspaces()
        cuda.synchronize()
        cuda.reset_peak_memory_stats()
        base = cuda.memory_allocated()
    launches = (fl_aggregate_cuda.launches, flash_attention_cuda.launches)
    t0 = time.perf_counter()
    rec = run_program(spec, card=bool(cuda))
    if cuda:
        cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t0
    rec["k1_launches"] = fl_aggregate_cuda.launches - launches[0]
    rec["k2_launches"] = flash_attention_cuda.launches - launches[1]
    rec["allocated_args"] = args
    rec["peak_temp_bytes"] = cuda.max_memory_allocated() - base if cuda \
        else rec["memory"]["temp_size_in_bytes"]
    rec["plain"] = _compare(rec["out"], spec.fn(*plain))
    rec["out"] = _summary(rec["out"])
    del spec, plain
    return rec


def _local(t):
    return t.to_local() if pshard.is_dtensor(t) else t


#: ``torch.testing.assert_close``'s default (rtol, atol) for each dtype
_CLOSE = {torch.bfloat16: (1.6e-2, 1e-5), torch.float16: (1e-3, 1e-5),
          torch.float32: (1.3e-6, 1e-5), torch.float64: (1e-7, 1e-7)}


def _compare(got, want, chunk: int = 1 << 26) -> dict:
    """The program's outputs on the 1×1 mesh against the same program's on
    plain tensors, leaf by leaf: the integer leaves' and float leaves'
    elements that differ, the largest float difference, and ``within``:
    the integers equal and every float within ``torch.testing.
    assert_close``'s default tolerance for its dtype (bf16 rtol 1.6e-2,
    float32 rtol 1.3e-6; atol 1e-5).  Compared in slices of ``chunk``
    elements: a training round's rows are gigabytes."""
    from torch.utils._pytree import tree_leaves
    a = [_local(t) for t in tree_leaves(got) if isinstance(t, torch.Tensor)]
    b = [t for t in tree_leaves(want) if isinstance(t, torch.Tensor)]
    if len(a) != len(b) or any(x.shape != y.shape or x.dtype != y.dtype
                               for x, y in zip(a, b)):
        raise AssertionError("the DTensor and plain programs' outputs differ "
                             "in structure")
    ints = floats = 0
    worst, within = 0.0, True
    for x, y in zip(a, b):
        x, y = x.reshape(-1), y.reshape(-1)
        for i in range(0, x.numel(), chunk):
            xs, ys = x[i:i + chunk], y[i:i + chunk]
            if not x.is_floating_point():
                ints += int((xs != ys).sum())
                continue
            d = (xs.float() - ys.float()).abs()
            floats += int((d != 0).sum())
            worst = max(worst, float(d.max()))
            rtol, atol = _CLOSE[x.dtype]
            within &= bool((d <= atol + rtol * ys.float().abs()).all())
    return {"leaves": len(a), "within": within and ints == 0,
            "int_elements_differ": ints, "float_elements_differ": floats,
            "max_abs_diff": worst}


def _summary(out) -> dict:
    """A program's output, checked and summarised: every float finite,
    every token an int in range; the tensors themselves dropped."""
    from torch.utils._pytree import tree_leaves
    leaves = [t.full_tensor() if pshard.is_dtensor(t) else t
              for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    floats = [t for t in leaves if t.is_floating_point()]
    ints = [t for t in leaves if not t.is_floating_point()]
    return {"finite": all(bool(torch.isfinite(t).all()) for t in floats),
            "tensors": len(leaves),
            "int_range": [min((int(t.min()) for t in ints if t.numel()),
                              default=0),
                          max((int(t.max()) for t in ints if t.numel()),
                              default=0)]}


def run_many(combos, out: str, probe: bool = True,
             skip_existing: bool = False) -> list:
    """Run ``combos`` (``(arch, shape, multi_pod)``) in this process, one
    fabricated world a mesh (opened once for all of its combinations), and
    write each record to ``out``; returns the records.  Torch 2.11 cannot
    open a second fake world in a process: give it one mesh's
    combinations a process."""
    from .mesh import close_world, fabricate_world
    os.makedirs(out, exist_ok=True)
    results = []
    for multi in sorted({bool(m) for _, _, m in combos}):
        fabricate_world(512 if multi else 256)
        try:
            for arch, shape, m in combos:
                if bool(m) != multi:
                    continue
                tag = f"{arch}_{shape}_{mesh_name(multi)}"
                path = os.path.join(out, tag.replace("/", "-") + ".json")
                if skip_existing and os.path.exists(path):
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") == "ok":
                        results.append(prev)
                        print(f"[dryrun] {arch} × {shape}: cached OK")
                        continue
                rec = run_one(arch, shape, multi, probe=probe)
                results.append(rec)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
        finally:
            close_world()
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--batch", default=None,
                    help='JSON list of [arch, shape, multi_pod] run in one '
                         'process, e.g. \'[["llama3.2-1b", "train_4k", '
                         'false]]\' (in place of --arch/--shape/--all)')
    ap.add_argument("--one-card", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one_card:           # fresh_check_one_card's child process
        print(json.dumps(_one_card_job(json.loads(args.one_card))))
        return

    if args.batch:
        combos = [tuple(c) for c in json.loads(args.batch)]
    else:
        archs = configs.names() if (args.all or not args.arch) \
            else [args.arch]
        shapes = list(SHAPES) if (args.all or not args.shape) \
            else [args.shape]
        combos = [(a, s, args.multi_pod) for a in archs for s in shapes]
    results = run_many(combos, args.out, probe=not args.no_probe,
                       skip_existing=args.skip_existing)
    ok = sum(r["status"] == "ok" for r in results)
    print(f"[dryrun] {ok}/{len(results)} combinations ran")
    if ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
