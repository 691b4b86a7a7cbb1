"""Builds ``kissabc_tpu_torch/csrc/*.cu`` with ``nvcc`` into
``build/kissabc_tpu_torch/`` at first use and loads it with ``ctypes``.

The sources have a plain ``extern "C"`` interface and include no PyTorch
header, so a build takes seconds. The library's file name carries a hash
of the source, so an edited source is rebuilt and a stale library is
never loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "flagship.cu"
BUILD_DIR = _PKG.parent / "build" / "kissabc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "kt_normal_summary_cost": [_P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _I,
                               _I, _I, _I, _P],
    "kt_fused_sweep": [_P] * 13 + [_I, _I] + [_F] * 11 + [_I, _I, _I, _P],
}


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "CUDA kernels of kissabc_tpu_torch are built from source at "
            "first use")
    return path


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libflagship-{digest[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless a library for this source exists.
    Returns (library path, seconds spent compiling, compiler output)."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)
    return lib, seconds, log


@functools.cache
def load() -> ctypes.CDLL:
    """The built kernel library, with every entry point's argument types
    declared (pointers and the stream as ``c_void_p``, so ctypes does not
    cut them to 32 bits)."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kt_error_string.argtypes = [ctypes.c_int]
    lib.kt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {err} "
            f"({lib.kt_error_string(err).decode()})")
