"""Builds the CUDA kernels with ``nvcc`` into ``build/kissabc_tpu_torch/``
at first use and loads them with ``ctypes``.

Three kinds of translation unit:

- the hand-written sources, built into one library (``build()``,
  ``load()``): ``csrc/flagship.cu``, the flagship smc kernels, and
  ``csrc/ais.cu``, the flagship AIS sweeps;
- ``csrc/select.cu``, the masked quantile's radix select, built alone
  into ``libselect-<sha>.so`` (``start_select()``, ``load_select()``), so
  that a run which needs only the quantile builds only it;
- a generated unit per user model: the device functions that
  ``ops/codegen.py`` emits, then ``#include "generic.cuh"`` (i.i.d.
  simulators, the fused smc and AIS sweeps, the ABC-DE generation),
  ``#include "scan.cuh"`` (sequential simulators) or ``#include
  "tempered.cuh"`` (the tempered sweep of a log-likelihood)
  (``start(text)``, ``load_generated()``), written to
  ``build/kissabc_tpu_torch/gen-<sha>.cu`` and compiled to
  ``libgen-<sha>.so``.

The sources have a plain ``extern "C"`` interface and include no PyTorch
header, so a build takes seconds. A library's file name carries a hash
of everything it is built from (the sources, the headers of ``csrc/``
and the flags), so an edited source is rebuilt and a stale library is
never loaded. ``start`` lets several ``nvcc`` run at once. Nothing
here runs at import time.
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
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "flagship.cu", CSRC / "ais.cu")
SELECT_SOURCE = CSRC / "select.cu"
HEADERS = (CSRC / "common.cuh", CSRC / "compact.cuh", CSRC / "generic.cuh",
           CSRC / "scan.cuh", CSRC / "moments.cuh", CSRC / "walkers.cuh",
           CSRC / "tempered.cuh", CSRC / "shifts.cuh")
BUILD_DIR = _PKG.parent / "build" / "kissabc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# generated units: no FMA contraction, so the user's expressions round as
# the plain PyTorch version rounds them (one op, one rounding)
GEN_FLAGS = NVCC_FLAGS + ("-fmad=false",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "kt_normal_summary_cost": [_P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _I,
                               _I, _I, _I, _P],
    "kt_fused_sweep": [_P] * 5 + [_F] + [_P] * 6 + [_I, _P, _P, _I, _I, _P],
    "kt_fused_ais_half": [_P] * 11 + [_I, _P, _P, _I, _I, _P],
    "kt_fused_ais_full": [_P] * 9 + [_I, _P, _P, _I, _I, _P],
    "kt_fused_ais_full_grid": [_I, _I, _I, _P],
}
SELECT_SIGNATURES = {
    "kt_masked_quantile": [_P, _P, _I, _F, _P, _P, _I, _I, _P],
    "kt_masked_quantile_grid": [_I, _P],
    "kt_masked_quantile_scratch_words": [],
}
GEN_SIGNATURES = {
    "kt_streaming_moment_cost": [_P, _P, _P, _I, _I, _I, _F, _I, _I, _I,
                                 _I, _I, _I, _P],
    "kt_fused_smc_sweep": [_P] * 11 + [_I, _I, _F, _F, _I, _I, _I, _I, _I,
                                       _P, _P, _P],
    "kt_fused_smc_sweep_occupancy": [_I, _P],
    "kt_streaming_scan_cost": [_P] * 4 + [_I, _I, _I, _F, _I, _I, _I, _I,
                                          _P],
    "kt_fused_ais_sweep": [_P] * 8 + [_I, _I, _P] + [_I] * 6 + [_P],
    "kt_fused_ais_sweep_parts": [_P] * 8 + [_I, _I, _P] + [_I] * 6
                                + [_P, _P],
    "kt_fused_ais_sweep_occupancy": [_I, _I, _I, _P],
    "kt_fused_tempered_sweep": [_P] * 9 + [_I, _P, _I, _I, _P],
    "kt_fused_tempered_sweep_parts": [_P] * 9 + [_I, _P, _I, _I, _P, _P],
    "kt_fused_abcde_generation": [_P] * 11 + [_I, _I, _F, _F] + [_I] * 7
                                 + [_P],
    "kt_fused_abcde_generation_occupancy": [_I, _I, _I, _P],
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


def _digest(*parts: bytes) -> str:
    return hashlib.sha256(b"\0".join(parts)).hexdigest()[:16]


def library_path() -> Path:
    digest = _digest(*(f.read_bytes() for f in SOURCES + HEADERS),
                     " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libflagship-{digest}.so"


def select_path() -> Path:
    """The library of the radix select, keyed by its source and the
    flags."""
    digest = _digest(SELECT_SOURCE.read_bytes(), " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libselect-{digest}.so"


def generated_path(text: str) -> Path:
    """The library of a generated unit, keyed by the template, the
    generated text and the flags."""
    digest = _digest(*(h.read_bytes() for h in HEADERS), text.encode(),
                     " ".join(GEN_FLAGS).encode())
    return BUILD_DIR / f"libgen-{digest}.so"


class _Job:
    """One nvcc run towards ``lib``, started at construction (or nothing
    to do when the library exists)."""

    def __init__(self, lib: Path, sources, flags):
        self.lib, self.proc = lib, None
        if lib.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.tmp = lib.with_suffix(f".{os.getpid()}.{id(self)}.tmp")
        self.cmd = [nvcc(), *flags, "-I", str(CSRC), "-o", str(self.tmp),
                    *map(str, sources)]
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def wait(self) -> tuple[Path, float, str]:
        """(library path, seconds compiling, compiler output)."""
        if self.proc is None:
            return self.lib, 0.0, ""
        log, _ = self.proc.communicate()
        seconds = time.perf_counter() - self.t0
        if self.proc.returncode != 0:
            self.tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({self.proc.returncode}): "
                               f"{' '.join(self.cmd)}\n{log}")
        os.replace(self.tmp, self.lib)
        return self.lib, seconds, log


def start(text: str | None = None) -> _Job:
    """Start compiling the hand-written sources (``text=None``) or a generated
    unit, unless its library exists; ``.wait()`` on the result gives
    (library path, seconds compiling, compiler output). Starting several
    before waiting on any runs their nvcc at once."""
    if text is None:
        return _Job(library_path(), SOURCES, NVCC_FLAGS)
    lib = generated_path(text)
    source = BUILD_DIR / (lib.stem.replace("libgen-", "gen-") + ".cu")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        source.write_text(text)
    return _Job(lib, (source,), GEN_FLAGS)


def start_select() -> _Job:
    """Start compiling the radix select unless its library exists."""
    return _Job(select_path(), (SELECT_SOURCE,), NVCC_FLAGS)


def build() -> tuple[Path, float, str]:
    """Compile the hand-written sources unless a library for them
    exists. Returns (library path, seconds spent compiling, compiler
    output)."""
    return start().wait()


def _bind(path: Path, signatures) -> ctypes.CDLL:
    """Load a library with every entry point's argument types declared
    (pointers and the stream as ``c_void_p``, so ctypes does not cut them
    to 32 bits)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name, None)
        if fn is None:   # a unit without the sweep, or not of this kind
            continue
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kt_error_string.argtypes = [ctypes.c_int]
    lib.kt_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The built library of the hand-written sources."""
    return _bind(build()[0], _SIGNATURES)


@functools.cache
def load_select() -> ctypes.CDLL:
    """The built library of the radix select."""
    return _bind(start_select().wait()[0], SELECT_SIGNATURES)


@functools.cache
def load_generated(text: str) -> ctypes.CDLL:
    """The built library of one generated unit."""
    return _bind(start(text).wait()[0], GEN_SIGNATURES)


def pointers(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers (a ``const float*
    const*`` argument)."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {err} "
            f"({lib.kt_error_string(err).decode()})")
