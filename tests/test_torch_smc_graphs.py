"""The smc iteration as CUDA graphs (``core/smc.py`` ``_IterGraphs``), on
the CPU: a capture cannot run here, so ``utils/graphs.py``'s
``_Captured`` is replaced by a stand-in that runs the recorded function
at each replay. What is held is everything but the recording itself: the
iteration's ``pre`` and ``post`` on the graphs' buffers, the host-side
resampling between them, the rotation shifts kept on the device, and the
stop test, against the eager loop bit for bit, on the same key.

The same holds for the fused sweep (``FusedSMCSweep``, its plain
version on the CPU) in ``post``: iterations, eps, costs, population and
the generator's final state equal the eager loop's, and
``graph_replays`` counts two replays an iteration after the first.

Also: ``propose_roll`` on device shifts equals ``torch.roll`` by the
same shifts read on the host, and ``gaussian_diff_propose`` such a host
roll, ``graphable`` holds the graphs to one card, the radix select,
written-out marginals, no retries and a sweep that says it can be
captured (a one-card fused sweep, or the split sweep's cost), and
``add_counts`` moves the registered counters. On one torch thread a
graphed-against-eager case takes 2-3 s, alone or beside five other test
workers; the others take under 0.1 s.
"""

import types

import numpy as np
import pytest
import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch import models
from kissabc_tpu_torch.core import smc as S
from kissabc_tpu_torch.ops import moves
from kissabc_tpu_torch.ops import scan as SC
from kissabc_tpu_torch.parallel.mesh import make_mesh
from kissabc_tpu_torch.utils import graphs as G
from kissabc_tpu_torch.utils import logging as L
from kissabc_tpu_torch.utils.rng import uint32_words
from torch_threads import one_torch_thread  # noqa: F401


class _Replayed(G._Captured):
    """``_Captured`` without a card: its "graph" runs the function at
    each replay, whose Python counts what it launches (no delta)."""

    def __init__(self, fn, device, gens=()):
        self.graph = types.SimpleNamespace(replay=fn)
        self.delta = {}


def _ar1():
    def step(th, x, eps, t):
        return th[0] * x + th[1] * eps

    def observe(th, x, t, obs):
        return (x, x * x)

    def reduce_cost(th, m):
        return torch.hypot(m[0] - 0.1, m[1] - 1.2)

    cost = kt.make_streaming_scan_cost(
        step, lambda th: torch.zeros_like(th[0]), reduce_cost,
        observe=observe, nsteps=24)
    prior = kt.Factored(kt.Uniform(-0.9, 0.9), kt.Uniform(0.2, 2.0))
    return prior, cost


def _solve(prior, cost, key, n, stepped=False):
    kw = dict(nparticles=n, epstol=0.12, cost_vectorized=True,
              partner_scheme="roll", min_r_ess=0.6, key=key, device="cpu")
    res = (kt.smc_stepped if stepped else kt.smc)(prior, cost, **kw)
    return res.iterations, res.eps, res.C, [np.asarray(p) for p in res.P]


def _graphed_resamples(monkeypatch):
    """A list that gets an entry at each resampling between two replays."""
    made = []
    real = S._SMCProgram._resample

    def resample(self, *a):
        if self._graphs is not None:
            made.append(1)
        return real(self, *a)

    monkeypatch.setattr(S._SMCProgram, "_resample", resample)
    return made


@pytest.mark.parametrize("stepped", [False, True])
@pytest.mark.parametrize("key", [3, 2**31 + 7])
def test_graphed_iteration_equals_the_eager_one(monkeypatch, key, stepped):
    prior, cost = _ar1()
    eager = _solve(prior, cost, key, 2048, stepped)
    monkeypatch.setattr(G, "_Captured", _Replayed)
    monkeypatch.setattr(S._SMCProgram, "graphable", lambda self: True)
    resampled = _graphed_resamples(monkeypatch)
    made = []
    real = S._IterGraphs.__init__

    def init(self, program, state):
        made.append(self)
        real(self, program, state)

    monkeypatch.setattr(S._IterGraphs, "__init__", init)
    replays = L.counts()["graph_replays"]
    graphed = _solve(prior, cost, key, 2048, stepped)
    assert len(made) == 1 and resampled
    assert L.counts()["graph_replays"] - replays == 2 * (graphed[0] - 1)
    assert eager[0] == graphed[0] and eager[0] > 3
    assert eager[1] == graphed[1]
    np.testing.assert_array_equal(eager[2], graphed[2])
    for a, b in zip(eager[3], graphed[3]):
        np.testing.assert_array_equal(a, b)


def _gk_fused(ndraws=16, mesh=None):
    """(prior, streamed cost, fused sweep) of ``models.g_and_k``, whose
    marginals are all Uniform."""
    prior, draw, reduce_cost = models.g_and_k()
    return (prior, kt.make_streaming_moment_cost(draw, reduce_cost,
                                                 ndraws=ndraws),
            kt.make_fused_smc_sweep(prior, draw, reduce_cost, ndraws=ndraws,
                                    mesh=mesh))


def _fused_solve(key, stepped):
    prior, cost, sweep = _gk_fused()
    gen = torch.Generator().manual_seed(key)
    replays = L.counts()["graph_replays"]
    res = (kt.smc_stepped if stepped else kt.smc)(
        prior, cost, nparticles=2048, epstol=0.4, cost_vectorized=True,
        sweep_fused=sweep, min_r_ess=0.6, key=gen, device="cpu")
    return (res.iterations, res.eps, res.C, [np.asarray(p) for p in res.P],
            gen.get_state(), L.counts()["graph_replays"] - replays)


@pytest.mark.parametrize("stepped", [False, True])
@pytest.mark.parametrize("key", [5, 2**31 + 3])
def test_graphed_fused_iteration_equals_the_eager_one(monkeypatch, key,
                                                      stepped):
    eager = _fused_solve(key, stepped)
    monkeypatch.setattr(G, "_Captured", _Replayed)
    monkeypatch.setattr(S._SMCProgram, "graphable", lambda self: True)
    resampled = _graphed_resamples(monkeypatch)
    graphed = _fused_solve(key, stepped)
    assert resampled
    assert eager[0] == graphed[0] and eager[0] > 3
    assert eager[1] == graphed[1]
    np.testing.assert_array_equal(eager[2], graphed[2])
    for a, b in zip(eager[3], graphed[3]):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(eager[4], graphed[4])
    assert eager[5] == 0
    assert graphed[5] == 2 * (graphed[0] - 1)


def _torch_roll(ens, w, r1, r2):
    """The roll proposal by ``torch.roll`` with host shifts."""
    return tuple(x + (torch.roll(x, r2, 0) - torch.roll(x, r1, 0))
                 * w.reshape((-1,) + (1,) * (x.dim() - 1)) for x in ens)


@pytest.mark.parametrize("n", [5, 1000, 65536])
def test_roll_on_the_device_equals_torch_roll(n):
    gen = torch.Generator().manual_seed(n)
    ens = (torch.randn(n, generator=gen), torch.randn(n, 3, generator=gen))
    w = torch.randn(n, generator=gen)
    for _ in range(4):
        words = uint32_words(gen, 2)
        r1, r2 = moves.roll_shifts(words.tolist(), n)
        d1, d2 = moves.roll_shifts(words, n)
        assert isinstance(d1, torch.Tensor) and isinstance(d2, torch.Tensor)
        assert (int(d1), int(d2)) == (r1, r2)
        want = _torch_roll(ens, w, r1, r2)
        got = moves.propose_roll(ens, w, d1, d2)
        for a, b in zip(want, got):
            assert torch.equal(a, b)


def test_propose_takes_the_draws_and_shifts_of_a_host_roll():
    n = 20000
    ens = (torch.linspace(0, 1, n), torch.linspace(2, 3, n))
    gen = torch.Generator().manual_seed(11)
    got = moves.gaussian_diff_propose(gen, ens, 2)
    ref = torch.Generator().manual_seed(11)
    w = 2.0 * torch.randn(n, generator=ref) / np.sqrt(2)
    r1, r2 = moves.roll_shifts(uint32_words(ref, 2).tolist(), n)
    want = _torch_roll(ens, w, r1, r2)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert torch.equal(gen.get_state(), ref.get_state())


def test_graphable_only_where_a_capture_can_run():
    prior, cost = _ar1()
    kw = dict(nparticles=2**18, alpha=0.95, mcmc_retrys=0, mcmc_tol=0.015,
              epstol=0.0, r_epstol=None, min_r_ess=0.5, max_stretch=2.0,
              max_iters=10, resample="replicate", verbose=False,
              mesh=None, cost_vectorized=True, partner_scheme="auto",
              quantile_impl="auto", sweep_fused=None, caller="smc")

    def prog(prior=prior, cost=cost, **over):
        p = S._program(prior, cost, **{**kw, "device": "cpu", **over})
        p.device = torch.device("cuda")   # as on a card
        return p

    assert prog().graphable()
    assert not S._program(prior, cost, **{**kw, "device": "cpu"}).graphable()
    assert not prog(mcmc_retrys=1).graphable()
    assert not prog(nparticles=4096).graphable()   # the sort quantile
    assert not prog(verbose=True).graphable()
    assert not prog(cost=lambda th, gen: th[0]).graphable()
    assert not prog(prior=kt.Factored(kt.Uniform(0, 1),
                                      kt.Exponential(1.0))).graphable()
    assert SC.StreamingScanCost.graph_safe
    assert not getattr(lambda th, gen: th[0], "graph_safe", False)

    # the fused sweep: asked in place of the cost, which then runs only in
    # the init (the streamed moment cost has no graph_safe)
    gk_prior, gk_cost, sweep = _gk_fused()
    assert sweep.graph_safe and not hasattr(gk_cost, "graph_safe")

    def fused(sweep=sweep, **over):
        return prog(**{"prior": gk_prior, "cost": gk_cost,
                       "sweep_fused": sweep, **over})

    assert fused().graphable()
    assert not S._program(gk_prior, gk_cost, **{
        **kw, "device": "cpu", "sweep_fused": sweep}).graphable()
    assert not fused(nparticles=4096).graphable()   # the sort quantile
    assert not fused(mcmc_retrys=1).graphable()
    assert not fused(verbose=True).graphable()
    assert not fused(prior=kt.Factored(kt.Uniform(0, 1), kt.Uniform(0, 1),
                                       kt.Uniform(0, 1),
                                       kt.Exponential(1.0))).graphable()
    assert not fused(sweep=lambda gen, *a: sweep(gen, *a)).graphable()
    # on a mesh the sweep reads its shifts on the host
    mesh = make_mesh(walker=2, devices=["cpu"] * 2)
    on_mesh = _gk_fused(mesh=mesh)[2]
    assert not on_mesh.graph_safe
    assert not fused(sweep=on_mesh).graphable()
    assert not fused(sweep=on_mesh, mesh=mesh,
                     cost=kt.shard_batched_cost(gk_cost, mesh)).graphable()


def test_add_counts_moves_the_registered_counters():
    before = L.counts()
    L.add_counts({"launches.streaming_scan_cost": 3, "scan.walker_steps": 7,
                  "no such counter": 1})
    after = L.counts()
    assert after["launches.streaming_scan_cost"] \
        == before["launches.streaming_scan_cost"] + 3
    assert after["scan.walker_steps"] == before["scan.walker_steps"] + 7
    L.add_counts({"launches.streaming_scan_cost": -3,
                  "scan.walker_steps": -7})
    assert L.counts() == before
