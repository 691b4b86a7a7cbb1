"""Builds a host program from the CUDA sources of kissabc_tpu_torch/csrc
against the emulation in this directory (``cuda_runtime.h``,
``cooperative_groups.h``): each ``kernel<<<grid, block, smem, stream>>>(``
launch becomes ``kt_launch(kernel, grid, block, smem, ``, the dynamic
shared memory ``s_dyn`` the emulation's block buffer, and the inline
``rsqrt.approx`` ``1 / sqrtf``. Skips the calling test without a host C++
compiler."""

import re
import shutil
import subprocess
from pathlib import Path

import pytest

import kissabc_tpu_torch as kt

HERE = Path(__file__).parent
CSRC = Path(kt.__file__).parent / "csrc"


def emulated(text: str) -> str:
    """CUDA source with its launches, its dynamic shared memory and its
    inline PTX rewritten for the emulation."""
    text = text.replace("extern __shared__ float s_dyn[];",
                        "float* s_dyn = kt_dyn_smem<float>();")
    text = re.sub(r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*"
                  r"\(cudaStream_t\)stream>>>\(",
                  r"kt_launch(\1, \2, \3, \4, ", text)
    return text.replace(
        'asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(rs) : "f"(v));',
        "rs = 1.0f / sqrtf(v);")


def build_program(root: Path, source, main: str, defines=(),
                  shared=False) -> Path:
    """Copy the headers of csrc/ and ``source`` (a file of csrc/, or
    None) into ``root`` with the launches rewritten, and compile ``main``
    (a file of this directory, or one already in ``root``) with g++ into
    an executable, or with ``shared`` a shared library; returns its
    path."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the emulation")
    for f in list(CSRC.glob("*.cuh")) + ([CSRC / source] if source else []):
        (root / f.name).write_text(emulated(f.read_text()))
    for name in ("cuda_runtime.h", "cooperative_groups.h"):
        shutil.copy(HERE / name, root)
    if (HERE / main).exists():
        shutil.copy(HERE / main, root)
    out = root / (Path(main).stem + (".so" if shared else ""))
    p = subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                        "-pthread", "-w", *(f"-D{d}" for d in defines),
                        *(("-shared", "-fPIC") if shared else ()),
                        "-I", str(root), str(root / main), "-o", str(out)],
                       capture_output=True, text=True)
    assert p.returncode == 0, f"g++ failed:\n{p.stderr}"
    return out
