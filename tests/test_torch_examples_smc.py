"""The smc walkthroughs of ``examples_torch/`` on the CPU, each held to
its JAX example's check; and the rules every walkthrough keeps.

- ``example_socks``, ``example_model_choice`` and ``example_covariance``
  run uncut; their asserts (the JAX examples' ``:72-75``, ``:68,77,98``
  and ``:76-78``) run inside ``main``. The data of socks and model
  choice are constants; covariance's come from numpy's generator seeded
  1 in both packages, so both see the same data.
- ``example_gk`` runs on the JAX example's observed octiles
  (``DATA_SUMM``), cut from 4096 to 512 particles (``NPARTICLES``, set
  by ``monkeypatch``; both packages take
  some 265 iterations to eps 0.05, and the per-walker sort of 1000 draws
  at 4096 takes minutes of CPU), beside the JAX example's smc at the
  same 512 particles. The JAX example has no assert, so the
  four posterior means are held to the JAX run's.

Tolerances against the JAX runs: ``tests/walkthroughs.py``.
"""

import numpy as np
import pytest
import torch
from walkthroughs import REPO, assert_means_agree, jax_example, torch_example
from torch_threads import one_torch_thread  # noqa: F401

import kissabc_tpu as ka

NAMES = sorted(p.stem for p in (REPO / "examples").glob("example_*.py"))


def test_every_jax_example_has_its_torch_walkthrough():
    assert len(NAMES) == 13
    assert NAMES == sorted(
        p.stem for p in (REPO / "examples_torch").glob("example_*.py"))


@pytest.mark.parametrize("name", NAMES)
def test_walkthrough_runs_on_cuda_unless_asked_for_the_cpu(name):
    """``main()`` takes CUDA; without a card it raises, it does not run
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would run the example on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_example(name).main()


def test_example_socks(capsys):
    res = torch_example("example_socks").main(device="cpu")
    out = capsys.readouterr().out
    assert "n_socks" in out and "prop_pairs" in out
    n_socks, prop_pairs = res.P
    # the JAX example's asserts, also run inside main
    assert n_socks.approx(46.2, atol=4.0) and prop_pairs.approx(0.866,
                                                                atol=0.06)


def test_example_model_choice(capsys):
    res_a, rej_a, rej_b, log_bf = torch_example(
        "example_model_choice").main(device="cpu")
    out = capsys.readouterr().out
    assert "log Bayes factor" in out and "log Z_A" in out
    # the JAX example's asserts (:68, :77, :98)
    assert res_a.P.approx(4.0, atol=0.3)
    assert abs(res_a.log_evidence - rej_a.log_evidence) < 0.5
    assert log_bf > 2.0


def test_example_covariance(capsys):
    res, (obs_r, obs_s1, obs_s2) = torch_example(
        "example_covariance").main(device="cpu")
    assert "posterior: r =" in capsys.readouterr().out
    # the JAX example's asserts (:76-78) on the same numpy data
    assert abs(res.P[1].mean() - obs_r) < 0.1
    assert abs(res.P[4].mean() - obs_s1) < 0.15
    assert abs(res.P[5].mean() - obs_s2) < 0.1


def test_example_gk_against_jax(monkeypatch):
    """512 particles in both packages (cut from 4096)."""
    jmod = jax_example("example_gk")
    data = np.array(jmod.DATA_SUMM)
    mod = torch_example("example_gk")
    monkeypatch.setattr(mod, "NPARTICLES", 512)
    res = mod.main(device="cpu", data_summ=data)
    want = ka.smc(jmod.prior, jmod.cost, nparticles=512, alpha=0.95,
                  epstol=0.05, key=1)
    assert res.eps <= 0.05 and want.eps <= 0.05
    assert_means_agree(res.P, want.P, "g-and-k")
