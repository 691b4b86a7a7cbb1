"""kissabc_tpu_torch — the PyTorch and CUDA port of ``kissabc_tpu``.

The JAX package stays the reference; this package runs the same
algorithms with torch tensors, on an NVIDIA H100 through hand-written
CUDA kernels (``csrc/``), or on the CPU through each kernel's plain
PyTorch version when the caller passes ``device="cpu"``.

Today: adaptive-epsilon SMC-ABC, whole:

- ``smc`` with a per-walker cost ``cost(theta, gen)`` or ``cost(theta)``
  (the default form), or a batched cost with ``cost_vectorized=True``:
  the flagship README model's ``make_flagship_cost_batched()`` (slice
  1), ``make_streaming_moment_cost(draw, reduce_cost)`` for i.i.d. user
  simulators (slice 2) and ``make_streaming_scan_cost(step, init,
  reduce_cost, nsteps=...)`` for sequential ones (slice 3), each
  compiled into a CUDA kernel;
- the one-kernel sweeps ``make_fused_flagship_sweep`` and
  ``smc(..., sweep_fused=make_fused_smc_sweep(prior, draw,
  reduce_cost))``;
- ``smc_stepped``, the same program stepped from the host, with
  ``IterLog`` records and checkpoint/resume; ``trace`` profiles a block;
- the priors ``Uniform``, ``Normal``, ``Truncated``/``TruncatedNormal``,
  ``DiscreteUniform``, ``MvNormal`` and ``Factored``.

It imports nothing of JAX or of the JAX package.
"""

from .core.smc import SMCResult, smc, smc_stepped  # noqa: F401
from .distributions import (  # noqa: F401
    DiscreteUniform, Factored, MvNormal, Normal, Truncated, TruncatedNormal,
    Uniform)
from .ops.fused_smc import make_fused_smc_sweep  # noqa: F401
from .ops.kernels import (  # noqa: F401
    make_flagship_cost_batched, make_fused_flagship_sweep)
from .ops.scan import make_streaming_scan_cost  # noqa: F401
from .ops.streaming import make_streaming_moment_cost  # noqa: F401
from .particles import Particles  # noqa: F401
from .utils.logging import IterLog, trace  # noqa: F401

__all__ = ["smc", "smc_stepped", "SMCResult", "Factored", "Uniform",
           "Normal", "Truncated", "TruncatedNormal", "DiscreteUniform",
           "MvNormal", "Particles", "make_flagship_cost_batched",
           "make_fused_flagship_sweep", "make_streaming_moment_cost",
           "make_streaming_scan_cost", "make_fused_smc_sweep", "IterLog",
           "trace"]
