"""Helpers of the ``tests/test_torch_examples_*.py`` files: the JAX and
the torch walkthrough of one name, one torch thread, and the rule that
holds a posterior mean to the JAX run's.

Tolerance of a posterior mean against the JAX run's: both runs sample
the same posterior on the same data with other random streams, so the
difference of the two means has sd sqrt(sd1^2 / ess1 + sd2^2 / ess2),
each run's posterior sd over its effective sample size; the test allows
four of those sds. The effective sample size is measured, not assumed:
AIS's samples (``walkers`` a block, block-major) by ``kt.ess`` on the
``[walkers, blocks]`` chain layout, which counts the autocorrelation
along each walker; an smc or tsmc population by its distinct particles
(resampling copies a particle, and a copy adds nothing). Each must be at
least 50, else the tolerance would rest on too few samples.
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import kissabc_tpu_torch as kt

REPO = Path(__file__).resolve().parents[1]


def jax_example(name):
    """The JAX example module, loaded under its own name (its
    ``__main__`` block does not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def torch_example(name):
    return importlib.import_module(f"examples_torch.{name}")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the test workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def effective_size(p, walkers=None):
    """The effective sample size of one parameter's posterior ``p`` (a
    ``Particles`` of either package): ``kt.ess`` on the chain layout of
    AIS samples with ``walkers`` walkers, else the distinct particles
    (the module docstring)."""
    x = np.asarray(p.particles, np.float64)
    if walkers is None:
        return float(len(np.unique(x)))
    return float(kt.ess(x.reshape(-1, walkers).T))


def assert_means_agree(got, want, what, walkers=None):
    """Each posterior mean of ``got`` within four sds of the difference
    of the means from the JAX run's ``want``, each run's effective sample
    size at least 50 (the module docstring); ``walkers``: AIS samples of
    that many walkers a block, else smc or tsmc populations."""
    for i, (g, w) in enumerate(zip(got, want)):
        ess_g, ess_w = effective_size(g, walkers), effective_size(w, walkers)
        assert min(ess_g, ess_w) >= 50, (
            f"{what} parameter {i}: effective sample sizes {ess_g:.1f}, "
            f"JAX {ess_w:.1f}")
        tol = 4.0 * np.sqrt(g.std() ** 2 / ess_g + w.std() ** 2 / ess_w)
        assert abs(g.mean() - w.mean()) < tol, (
            f"{what} parameter {i}: {g} against JAX {w}, tolerance "
            f"{tol:.3g} at effective sizes {ess_g:.1f}, {ess_w:.1f}")
