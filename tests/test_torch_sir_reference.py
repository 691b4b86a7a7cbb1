"""The benchmark's SIR deployment (``benchport/configs/sir-cle``) on the
CPU: the port's scan cost for it (the plain version of kernel #5)
against the float64 reference of ``benchport/reference/`` (the kernel's
noise rebuilt from its seed word, each path worked out in float64), the
configuration's observed curve and model against the port's own SIR
(``kissabc_tpu_torch.models.sir``), a seeded smc solve held to the
cell's limits by its judge, and the judge failing planted faults in the
simulator (the recovery flow without its clamp; one sub-step's parity
swapped).

Each test takes under 20 s alone; the solve runs at 4096 walkers to eps
0.1 (a CPU budget: the cell solves 2^20 walkers to 0.01 on the card),
the faults at 1024 walkers to 0.15.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "benchport"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import jobs  # noqa: E402
import run  # noqa: E402
from reference.scan_streams import scan_noise  # noqa: E402

import kissabc_tpu_torch as kt  # noqa: E402
from kissabc_tpu_torch import models  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

CELL = "sir-smc-1m"
LIMITS = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())


def _config():
    cfg, mod = jobs.load_config("sir-cle")
    data = mod.make_data(cfg)
    return cfg, mod, data, mod.model(cfg, data)


def _cost(m, data, step=None):
    return kt.make_streaming_scan_cost(
        step or m.step, m.init, m.reduce_cost, observe=m.observe,
        series=data["series"], nsteps=m.nsteps)


@pytest.mark.parametrize("key", [0, 1, 2**31 + 5])
def test_plain_scan_cost_matches_the_float64_reference(key):
    cfg, _, data, m = _config()
    n = 4096
    g = torch.Generator().manual_seed(key)
    theta = m.port_prior(kt).sample_tree(g, n)
    seed = int(torch.randint(0, 1 << 32, (1,), generator=g))
    got = _cost(m, data).seeded(theta, torch.tensor([seed])).double()
    want = m.ref_cost([t.double() for t in theta],
                      scan_noise(seed, torch.arange(n), m.nsteps))
    gap = float((got - want).abs().max())
    assert gap <= LIMITS["cost"], gap
    # the paths are the deployment's: epidemics that grow and that die
    assert float(want.min()) < 0.1 < float(want.max())


def test_observed_curve_and_model_are_the_ports_sir():
    cfg, _, data, m = _config()
    series = models.sir_series()
    assert data["series"].dtype == series.dtype == np.float32
    assert data["series"].tobytes() == series.tobytes()
    assert (m.pop, m.i0, cfg["days"], m.nsteps) == (
        models.SIR_POP, models.SIR_I0, models.SIR_DAYS, 2 * models.SIR_DAYS)
    prior, step, init, observe, reduce_cost, _ = models.sir()
    assert [(float(p.a), float(p.b)) for p in prior.p] == [
        (u.lo, u.hi) for u in m.ref_prior]
    # the same costs, bit for bit, from the port's own SIR
    n = 512
    theta = prior.sample_tree(torch.Generator().manual_seed(3), n)
    seed = torch.tensor([987654321])
    theirs = kt.make_streaming_scan_cost(
        step, init, reduce_cost, observe=observe, series=series,
        nsteps=2 * models.SIR_DAYS).seeded(theta, seed)
    assert torch.equal(_cost(m, data).seeded(theta, seed), theirs)


def _readings(n, epstol, patch=None, seed=2**31 + 7):
    """One solve of the cell's job at ``n`` walkers to ``epstol``, its
    replay judged: the numbers that the cell's limits bound (``run.run``
    without its guard against a loaded JAX, which this test process
    holds)."""
    cfg, mod = jobs.load_config("sir-cle")
    cfg["smc"] = {**cfg["smc"], "nparticles": n, "epstol": epstol}
    traffic = {**jobs.load_traffic("smc_scan_solves"), "warm_solves": 0,
               "min_solves": 1}
    job = jobs.make(kt, cfg, mod, traffic, seed, torch.device("cpu"))
    if patch is not None:
        patch(job)
    rng = np.random.default_rng(jobs.derive(seed, "judge"))
    job.setup()
    window = job.window(0.0, False, rng)
    nums, notes = run.merge(job.judge(rng, 256))
    return window, {k: nums[k] for k in LIMITS}, notes


def test_seeded_solve_meets_every_limit():
    window, nums, notes = _readings(4096, 0.1)
    assert window["iterations"][0] > 20 and window["failed"] == 0
    assert nums["exact"] == 0, notes
    assert all(nums[k] <= LIMITS[k] for k in LIMITS), nums


def _no_recovery_clamp(m):
    def step(th, state, eps, t):
        beta, gamma = th
        s, i = state
        even = (t % 2) == 0
        flow = torch.where(even, beta * s * i / m.pop, gamma * i)
        dn = flow + torch.sqrt(torch.clamp(flow, min=0.0)) * eps
        dn = torch.where(even, torch.clamp(dn, torch.zeros_like(dn), s), dn)
        return torch.where(even, s - dn, s), torch.where(even, i + dn, i - dn)
    return step


def _parity_swapped(m):
    def step(th, state, eps, t):
        # sub-step 37 (a recovery sub-step) runs the infection flow
        return m.step(th, state, eps, torch.where(t == 37, t + 1, t))
    return step


@pytest.mark.parametrize("fault", [_no_recovery_clamp, _parity_swapped],
                         ids=["no_recovery_clamp", "parity_swapped"])
def test_judge_fails_a_planted_fault(fault):
    def patch(job):
        job.cost = _cost(job.model, job.data, fault(job.model))

    _, nums, _ = _readings(1024, 0.15, patch)
    assert nums["cost"] > LIMITS["cost"], nums
