"""The plain reference of the benchmark: plain PyTorch, float64 unless a
function takes a ``dtype`` (the lower-precision control).

It imports nothing of the measured package and nothing of JAX. It takes
from a run only what the benchmark itself handed the program (the
population, the generator's state, the model's data) and what the
program produced (its outputs, which it judges), and works out again
everything the program derived: the random words, the proposals, the
simulations, the costs, the thresholds and the resampling.

- ``philox``: Philox4x32-10, the counter-based generator of the kernels;
- ``streams``: uniforms and normals from its words, the simulator's
  draws of one walker, and the words the program draws from its
  ``torch.Generator``;
- ``priors``: plain marginals, and the support and log-density of a
  factored prior;
- ``judge``: the readings a comparison accumulates (widest gaps, exact
  mismatches);
- ``smc_judge``: one smc solve, step by step (init, threshold, alive
  mask, resampling, sweep, stopping rule, result);
- ``ais_judge``: one red/black AIS sweep, half by half.
"""
