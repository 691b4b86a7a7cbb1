"""``smc_solves``: adaptive smc solves run back to back (a closed loop:
one scientist's job starts the next call when the last returns), each
with its own key from the seed and its index, through the port's
streamed cost (kernel #4, the init) and fused sweep (kernel #3, every
iteration). The configuration's ``smc`` group gives the solver's
settings; the traffic file ``warm_solves``, ``min_solves`` and
``judged_walkers``."""

from __future__ import annotations

import time

import numpy as np

from jobs import Job, clone, derive, leaves
from reference.smc_judge import SMCJudge


class Kind(Job):
    def __init__(self, *a):
        super().__init__(*a)
        s = self.cfg["smc"]
        self.n = int(s["nparticles"])
        m = self.model
        self.cost = self.kt.make_streaming_moment_cost(m.draw, m.reduce,
                                                       **self.kw)
        self.sweep = self.kt.make_fused_smc_sweep(
            self.prior, m.draw, m.reduce, max_stretch=s["max_stretch"],
            **self.kw)
        self.results, self.ends = [], []

    def key(self, i):
        return derive(self.seed, "solve", i)

    def call(self, key, cost=None, sweep=None):
        s = self.cfg["smc"]
        res = self.kt.smc(
            self.prior, cost or self.cost, nparticles=self.n,
            alpha=s["alpha"], mcmc_retrys=s["mcmc_retrys"],
            mcmc_tol=s["mcmc_tol"], epstol=s["epstol"],
            min_r_ess=s["min_r_ess"], max_stretch=s["max_stretch"],
            max_iters=s["max_iters"], resample=s["resample"],
            cost_vectorized=True, sweep_fused=sweep or self.sweep, key=key,
            device=self.device)
        return {"C": res.C, "eps": res.eps, "iterations": res.iterations,
                "ess": res.ess,
                "P": [np.asarray(p) for p in leaves(res.P)]}

    def setup(self):
        for w in range(int(self.traffic["warm_solves"])):
            self.call(derive(self.seed, "warm", w))
        self.sync()

    def window(self, seconds, trace, rng):
        """Solves back to back until ``seconds`` have passed (at least
        ``min_solves``); with ``trace`` one whole solve, drawn from the
        first ``min_solves`` by ``rng``, runs under the profiler."""
        least = int(self.traffic["min_solves"])
        self.profiled = int(rng.integers(least)) if trace else None
        t0 = time.perf_counter()
        i = 0
        while True:
            if i == self.profiled:
                with self.profiling():
                    self.results.append(self.call(self.key(i)))
            else:
                self.results.append(self.call(self.key(i)))
            self.ends.append(time.perf_counter())
            i += 1
            if self.ends[-1] - t0 >= seconds and i >= least:
                break
        self.window_s = self.ends[-1] - t0
        starts = [t0] + self.ends[:-1]
        return {"window_s": self.window_s, "attempted": i, "failed": sum(
            r["iterations"] >= self.cfg["smc"]["max_iters"]
            for r in self.results), "solves": i,
            "iterations": [r["iterations"] for r in self.results],
            "each_s": [b - a for a, b in zip(starts, self.ends)]}

    def replay(self, i, judges):
        """Solve ``i`` again from its key, each judge fed what the cost
        and the sweep are handed and return; returns the solve's
        result."""
        kt_cost, kt_sweep = self.cost, self.sweep

        def cost(thetas, gen):
            state = gen.get_state()
            out = kt_cost(thetas, gen)
            for j in judges:
                j.init(clone(leaves(thetas)), state, out.clone())
            return out

        def sweep(gen, thetas, xs, lps, alive, eps, flag):
            state = gen.get_state()
            inp = (clone(leaves(thetas)), xs.clone(), lps.clone(),
                   alive.clone(), eps.clone(), flag.clone())
            out = kt_sweep(gen, thetas, xs, lps, alive, eps, flag)
            res = (clone(leaves(out[0])), out[1].clone(), out[2].clone())
            for j in judges:
                j.step(inp, state, res, out[3])
            return out

        return self.call(self.key(i), cost, sweep)

    def judge(self, rng, walkers, controls=(False,)):
        """Readings of the solves judged: one drawn by ``rng`` from those
        the window finished, and the profiled one; each replayed once,
        its judges fed together, and tied to the window's result bit for
        bit (in the program's readings)."""
        picks = {int(rng.integers(len(self.results)))}
        if self.profiled is not None:
            picks.add(self.profiled)
        out = []
        for i in sorted(picks):
            js = [SMCJudge(self.cfg, self.model, rng=rng, walkers=walkers,
                           control=c) for c in controls]
            again = self.replay(i, js)
            for j in js:
                j.finish(again)
            tie(js[0].r, self.results[i], again)
            out.append((i, js))
        return out

    def work(self, judge):
        """(kernel, operations, bytes) of each launch of a judged solve,
        by the frozen counts of ``metrics/_counts.py``."""
        from metrics import _counts as c
        cfg, mod = self.cfg, self.mod
        launches = [("k4",) + c.streaming_cost(mod, cfg, self.n)]
        launches += [("k3",) + c.smc_sweep(mod, cfg, self.n, nsim)
                     for nsim in judge.nsim]
        return launches


def tie(readings, window, again):
    """Count where the window's solve and its replay differ."""
    for k in ("iterations", "eps", "ess"):
        readings.mismatch(f"replayed {k}", window[k] != again[k])
    readings.mismatch("replayed costs", not np.array_equal(window["C"],
                                                           again["C"]))
    for a, b in zip(window["P"], again["P"]):
        readings.mismatch("replayed population", not np.array_equal(a, b))
