"""kissabc_tpu_torch — the PyTorch and CUDA port of ``kissabc_tpu``.

The JAX package stays the reference; this package runs the same
algorithms with torch tensors, on an NVIDIA H100 through hand-written
CUDA kernels (``csrc/``), or on the CPU through each kernel's plain
PyTorch version when the caller passes ``device="cpu"``.

Today: adaptive-epsilon SMC-ABC through ``smc`` on the flagship README
model — ``Factored(Uniform(1, 3), TruncatedNormal(0, 0.05, 0, 100))``
with the batched cost ``make_flagship_cost_batched()`` — and the
one-kernel flagship sweep ``make_fused_flagship_sweep`` (slice 1); and
``smc(..., sweep_fused=make_fused_smc_sweep(prior, draw, reduce_cost))``
with ``make_streaming_moment_cost(draw, reduce_cost)`` for user models
written in PyTorch and compiled into the generic kernels (slice 2). It
imports nothing of JAX or of the JAX package.
"""

from .core.smc import SMCResult, smc  # noqa: F401
from .distributions import (  # noqa: F401
    Factored, Normal, Truncated, TruncatedNormal, Uniform)
from .ops.fused_smc import make_fused_smc_sweep  # noqa: F401
from .ops.kernels import (  # noqa: F401
    make_flagship_cost_batched, make_fused_flagship_sweep)
from .ops.streaming import make_streaming_moment_cost  # noqa: F401
from .particles import Particles  # noqa: F401

__all__ = ["smc", "SMCResult", "Factored", "Uniform", "Normal", "Truncated",
           "TruncatedNormal", "Particles", "make_flagship_cost_batched",
           "make_fused_flagship_sweep", "make_streaming_moment_cost",
           "make_fused_smc_sweep"]
