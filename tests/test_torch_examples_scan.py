"""The walkthroughs of ``examples_torch/`` that reach kernel #5
(``make_streaming_scan_cost``) and #9 (``make_fused_tempered_sweep``),
on the CPU through the kernels' plain versions, held to their JAX
examples' checks; all uncut.

- ``example_scan_sim``: its asserts (the JAX example's ``:94-96`` and
  ``:128-129``) run inside ``main``; no observed data (the OU moments
  are exact, the Wiener curve is computed).
- ``example_sir`` on the JAX example's observed curve
  (``observed_curve()`` on the recovery sub-steps, zeros between): its
  asserts (the JAX example's ``:103-105``) run inside ``main``.
- ``example_tsmc``: the log-evidence within 0.5 of the analytic value
  (``tests/test_examples.py:110-124``), split and fused (on the CPU the
  fused sweep runs #9's plain version); beside it the JAX example's
  split tsmc, and the posterior means held to the JAX run's by the rule
  of ``tests/walkthroughs.py``.
"""

import numpy as np
from walkthroughs import (assert_means_agree, jax_example,  # noqa: F401
                          one_torch_thread, torch_example)

import kissabc_tpu as ka


def test_example_scan_sim(capsys):
    res, res2 = torch_example("example_scan_sim").main(device="cpu")
    out = capsys.readouterr().out
    assert "OU reversion a" in out and "Wiener drift mu" in out
    a, m, s = res.P
    assert abs(a.mean() - 0.3) < 0.12 and abs(m.mean() - 1.0) < 0.20
    assert abs(s.mean() - 1.5) < 0.40
    mu, sig = res2.P
    assert abs(mu.mean() - 0.5) < 0.25 and abs(sig.mean() - 2.0) < 0.8


def test_example_sir_on_the_jax_curve(capsys):
    y = jax_example("example_sir").observed_curve()
    series = np.zeros((2 * len(y),), np.float32)
    series[1::2] = y
    res = torch_example("example_sir").main(device="cpu", series=series)
    assert "R0" in capsys.readouterr().out
    beta, gamma = res.P
    assert abs(beta.mean() - 0.3) < 0.08 and abs(gamma.mean() - 0.1) < 0.05
    assert abs(float(np.mean(beta.particles / gamma.particles)) - 3.0) < 0.8


def test_example_tsmc_against_jax(capsys):
    res, resf, logz = torch_example("example_tsmc").main(device="cpu")
    assert "log-evidence" in capsys.readouterr().out
    assert abs(res.log_evidence - logz) < 0.5
    assert abs(resf.log_evidence - logz) < 0.5
    jmod = jax_example("example_tsmc")
    want = ka.tsmc(ka.Normal(0, 1), jmod.loglike, nparticles=4000,
                   mcmc_steps=5)
    assert abs(want.log_evidence - logz) < 0.5
    assert_means_agree([res.P], [want.P], "tsmc")
    assert_means_agree([resf.P], [want.P], "tsmc fused")
