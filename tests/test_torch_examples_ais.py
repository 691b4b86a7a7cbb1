"""The AIS walkthroughs of ``examples_torch/`` on the CPU, each on its
JAX example's observed data and held to the JAX check.

- ``example_n1`` on the JAX example's ``tdata``, uncut, beside the JAX
  example's own AIS and smc runs: both mu means within 0.05 of 2
  (``tests/test_examples.py:8-21``), and each posterior mean held to the
  JAX run's by the rule of ``tests/walkthroughs.py`` (AIS: 50 walkers a
  block).
- ``example_n2`` on the JAX example's ``summ_data``, uncut: the first
  parameter's mean within 0.25 of 1 in both posteriors
  (``tests/test_examples.py:94-107``).
- ``example_workflow`` on the JAX example's observed and pilot data
  (``jax.random.key(0)`` and ``key(9)``), uncut, beside the JAX
  example's ``main``: its asserts (rhat < 1.2, the predictive mean
  within 0.01 of the data's) run inside ``main``, and the smc posterior
  means are held to the JAX run's.
- ``example_expmix``'s ``main`` with one cut, 10^5 draws a cost call
  (from 10^6, as the JAX test ``tests/test_examples.py:127-145`` cuts
  it; at 10^6 a half-update simulates 5 10^7 draws and sorts 10^6 a
  walker, ten times the CPU time), its other settings the example's;
  the JAX test's bands u1 0.49 +- 0.12, p1 0.88 +- 0.12.

Tolerances against the JAX runs: ``tests/walkthroughs.py``.
"""

import jax
import numpy as np
from walkthroughs import (assert_means_agree, jax_example,  # noqa: F401
                          one_torch_thread, torch_example)

import kissabc_tpu as ka


def test_example_n1_against_jax(capsys):
    jmod = jax_example("example_n1")
    ais, smc = torch_example("example_n1").main(
        device="cpu", tdata=np.array(jmod.tdata))
    out = capsys.readouterr().out
    assert "AIS posterior" in out and "smc posterior" in out
    jais = ka.sample(ka.ApproxPosterior(jmod.prior, jmod.cost, 0.01),
                     ka.AIS(50), 500, discard_initial=1000, ntransitions=10,
                     key=1)
    jsmc = ka.smc(jmod.prior, jmod.cost, nparticles=500, epstol=0.01, key=2)
    for post in (ais, smc.P, jais, jsmc.P):
        assert abs(post[0].mean() - 2.0) < 0.05, post
    assert_means_agree(ais, jais, "n1 AIS", walkers=50)
    assert_means_agree(smc.P, jsmc.P, "n1 smc")


def test_example_n2(capsys):
    jmod = jax_example("example_n2")
    ais, smc = torch_example("example_n2").main(
        device="cpu", summ_data=np.array(jmod.summ_data))
    out = capsys.readouterr().out
    assert "AIS posterior" in out and "smc posterior" in out
    for post in (ais, smc.P):
        assert abs(post[0].mean() - 1.0) < 0.25, post


def test_example_workflow_against_jax(capsys):
    tdata = np.array(jax.random.normal(jax.random.key(0), (1000,)) * 0.04
                     + 2.0)
    pilot = np.array(jax.random.normal(jax.random.key(9), (64,)) * 0.5
                     + 2.1)
    res, ais, pp = torch_example("example_workflow").main(
        device="cpu", tdata=tdata, pilot=pilot)
    want = jax_example("example_workflow").main()
    out = capsys.readouterr().out
    assert out.count("rhat") == 2 and out.count("posterior predictive") == 2
    assert res.eps <= 0.012 and want.eps <= 0.012
    assert_means_agree(res.P, want.P, "workflow smc")
    assert pp.approx(float(np.mean(tdata)), atol=0.01)


def test_example_expmix_reduced(capsys):
    """10^5 draws a cost call (module docstring)."""
    u1p, p1p = torch_example("example_expmix").main(device="cpu",
                                                    ndraws=10**5)
    assert "reference CI [0.490, 0.495]" in capsys.readouterr().out
    assert u1p.approx(0.49, atol=0.12), u1p
    assert p1p.approx(0.88, atol=0.12), p1p
