"""The walkthroughs of ``examples_torch/`` that reach kernel #4
(``make_streaming_moment_cost``) and #6 (``make_fused_ais_sweep``), on
the CPU through the kernels' plain versions, held to their JAX
examples' checks.

- ``example_streaming_sim`` on the JAX example's probe points
  (``GK_PROBES``), with one cut: smc's ``alpha`` 0.5 (from 0.95) in both
  fits (``ALPHA``, set by ``monkeypatch``). The plain version of #4 makes its draws one Philox call at a
  time, as the kernel sums them, so a cost call of 1024 walkers x 4000
  draws takes about a second of CPU whatever the particle count; at
  alpha 0.95 the two fits take 169 + 150 iterations (11 minutes), at 0.5
  some 13 + 23. Its asserts (the JAX example's ``:114-127``) run inside
  ``main``.
- ``example_fused_ais`` on the CPU takes the JAX example's portable
  path (``make_sweep_halves`` and ``_halves``, the cost through #4's
  plain version), uncut (about a minute of CPU). Its asserts (the JAX
  example's ``:100-101``) run inside ``main``; beside it the JAX
  example's split path, and each posterior mean within the larger
  posterior sd of the JAX run's: both are the same 60 sweeps of the
  same sampler from the prior, and with at least 50 effective walkers
  the difference of the two means has sd at most sd * sqrt(2 / 50) =
  0.2 sd.
"""

import re

from walkthroughs import (jax_example, one_torch_thread,  # noqa: F401
                          torch_example)


def test_example_streaming_sim(capsys, monkeypatch):
    """alpha 0.5 (module docstring)."""
    probes = jax_example("example_streaming_sim").GK_PROBES
    mod = torch_example("example_streaming_sim")
    monkeypatch.setattr(mod, "ALPHA", 0.5)
    res, res2 = mod.main(device="cpu", probes=probes)
    out = capsys.readouterr().out
    assert "shape k" in out and "scale lam" in out
    assert res.eps <= 0.01 and res2.eps <= 0.02
    kp, lamp = res.P
    assert kp.approx(1.7, atol=0.25) and lamp.approx(2.0, atol=0.3)
    for p, true, tol in zip(res2.P, (3.0, 1.0, 2.0, 0.5),
                            (0.3, 0.35, 0.7, 0.4)):
        assert p.approx(true, atol=tol), p


def test_example_fused_ais_split_path_against_jax(capsys):
    mu, sg = torch_example("example_fused_ais").main(device="cpu")
    out = capsys.readouterr().out
    assert "split make_sweep_halves" in out and "OK" in out
    jax_example("example_fused_ais").main()
    jout = capsys.readouterr().out
    assert "split make_sweep_halves" in jout and "OK" in jout
    want = [tuple(float(v) for v in m) for m in re.findall(
        r"= (-?[\d.]+) \+- ([\d.]+)", jout)]
    assert len(want) == 2, jout
    for got, (wmean, wsd), what in zip((mu, sg), want, ("mu", "sigma")):
        tol = max(float(got.std(correction=0)), wsd)
        assert abs(float(got.mean()) - wmean) < tol, (what, got, wmean)
