"""A run with its timed path broken underneath comes out not correct:
a step that returns its state unchanged, the simulator's mean taken over
half of its draws, and an answer altered where it is produced (one
card: no exchange between chips to leave out)."""

import pytest
import torch

import run
from small import SECONDS, SMALL


def _unchanged(job):
    if hasattr(job, "results"):
        job.sweep = lambda gen, th, xs, lps, alive, eps, flag: (
            th, xs, lps, torch.zeros((), dtype=torch.int64))
    else:
        job.sweep = lambda gen, th, ld: (th, ld)


def _half_draws(job):
    kw = dict(job.kw, ndraws=job.kw["ndraws"] // 2)
    m, kt = job.model, job.kt
    job.cost = kt.make_streaming_moment_cost(m.draw, m.reduce, **kw)
    if hasattr(job, "results"):
        job.sweep = kt.make_fused_smc_sweep(job.prior, m.draw, m.reduce,
                                            **kw)
    else:
        job.sweep = kt.make_fused_ais_sweep(job.prior, m.draw, m.reduce,
                                            scale=job.scale, **kw)


def _altered(job):
    sweep = job.sweep

    def bent(gen, *a):
        out = sweep(gen, *a)
        th = [x.clone() for x in out[0]]
        th[0][0] += 0.01
        return (tuple(th),) + tuple(out[1:])

    job.sweep = bent


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("fault", [_unchanged, _half_draws, _altered],
                         ids=["unchanged", "half_draws", "altered"])
def test_fault_is_not_correct(workload, fault):
    over, traffic = SMALL[workload]
    out = run.run(workload, 99, SECONDS, False, device=torch.device("cpu"),
                  overrides=over, traffic_overrides=traffic, patch=fault)
    assert not out["correct"], out["checks"]
