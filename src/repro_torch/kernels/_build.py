"""Build a CUDA source of ``csrc/`` with ``nvcc`` and load it with ctypes.

Each source compiles on first use into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v

never with ``--use_fast_math`` (it breaks ``isfinite`` and NaN propagation).
The library lands in ``kernels/_build/`` (listed in ``.gitignore``), named
by a hash of the source and the flags, so an edit triggers a rebuild and
concurrent builds never see a half-written file.  ``nvcc`` is taken from
``$CUDA_HOME/bin``, else ``PATH``, else ``/usr/local/cuda/bin``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


class BuiltLibrary:
    """A loaded kernel library, with how it was obtained."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.seconds = seconds   # nvcc wall time; 0.0 when already built
        self.log = log           # nvcc's output (ptxas register report)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build(name: str) -> BuiltLibrary:
    """Compile ``csrc/<name>.cu`` unless its library exists, then load it."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
    return BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log)
