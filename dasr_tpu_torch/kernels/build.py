"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``dasr_tpu_torch/csrc/*.cu`` into one shared
library with a plain C interface, under ``build/dasr_tpu_torch/`` at the
root of the checkout, the first time a kernel is launched. The library's
name carries a hash of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded. It is loaded with ``ctypes``;
every pointer and the stream pass as ``c_void_p``.

Nothing here runs at import time: a CPU-only host imports the package
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "dasr_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lib = None


def sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from dasr_tpu_torch/csrc at first use"
    )


def build(verbose: bool = False) -> tuple[Path, bool]:
    """Compile the sources if no library for their hash exists. Returns the
    library's path and whether this call compiled it."""
    so = BUILD_DIR / f"libdasr_kernels_{_digest()}.so"
    if so.exists():
        return so, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus = [str(s) for s in sources() if s.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *cus]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so, True


def load(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build(verbose)[0]))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dasr_rdb_level.argtypes = [i, vp, vp, vp, vp, vp] + [i] * 10 + [vp]
    lib.dasr_rdb_level.restype = i
    lib.dasr_cuda_error_string.argtypes = [i]
    lib.dasr_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.dasr_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
