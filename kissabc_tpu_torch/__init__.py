"""kissabc_tpu_torch — the PyTorch and CUDA port of ``kissabc_tpu``.

The JAX package stays the reference; this package runs the same
algorithms with torch tensors, on an NVIDIA H100 through hand-written
CUDA kernels (``csrc/``), or on the CPU through each kernel's plain
PyTorch version when the caller passes ``device="cpu"``.

Slice 1 (this package today): adaptive-epsilon SMC-ABC through ``smc``
on the flagship README model — ``Factored(Uniform(1, 3),
TruncatedNormal(0, 0.05, 0, 100))`` with the batched cost
``make_flagship_cost_batched()`` — and the one-kernel flagship sweep
``make_fused_flagship_sweep``. It imports nothing of JAX or of the JAX
package.
"""

from .core.smc import SMCResult, smc  # noqa: F401
from .distributions import (  # noqa: F401
    Factored, Normal, Truncated, TruncatedNormal, Uniform)
from .ops.kernels import (  # noqa: F401
    make_flagship_cost_batched, make_fused_flagship_sweep)
from .particles import Particles  # noqa: F401

__all__ = ["smc", "SMCResult", "Factored", "Uniform", "Normal", "Truncated",
           "TruncatedNormal", "Particles", "make_flagship_cost_batched",
           "make_fused_flagship_sweep"]
