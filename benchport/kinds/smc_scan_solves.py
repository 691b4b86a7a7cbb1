"""``smc_scan_solves``: adaptive smc solves of a sequential simulator run
back to back (a closed loop: one scientist's job starts the next call
when the last returns), each with its own key from the seed and its
index, through the port's split sweep (the moves, the log-prior and the
gates in PyTorch) and its scan cost (kernel #5, every iteration), with
no fused sweep. The configuration's ``smc`` group gives the solver's
settings, its module the model (``step``, ``init``, ``observe``,
``reduce_cost``) and ``make_data`` the observed ``series``; the traffic
file ``warm_solves``, ``min_solves`` and ``judged_walkers``.

The window is ``smc_solves``'; the judged replay runs the same solve
host-stepped (``smc_stepped``, the same program one iteration at a
time), whose log gives the judge each iteration's threshold, and is tied
bit for bit to the window's result."""

from __future__ import annotations

import numpy as np

from jobs import clone, leaves
from kinds.smc_solves import Kind as SMCSolves
from kinds.smc_solves import tie
from reference.scan_smc_judge import ScanSMCJudge


class Kind(SMCSolves):
    def __init__(self, kt, cfg, mod, traffic, seed, device):
        # not Job's set-up: that reads the streamed cost's sizes
        # (``model_kwargs``), which a scan model has not. This sets every
        # field that ``jobs.Job.__init__`` sets but ``kw`` (kt, cfg, mod,
        # traffic, seed, device, data, model, prior, prof, profiled): a
        # field that Job gains has to be set here too
        self.kt, self.cfg, self.mod = kt, cfg, mod
        self.traffic, self.seed, self.device = traffic, int(seed), device
        self.data = mod.make_data(cfg)
        self.model = m = mod.model(cfg, self.data)
        self.prior = m.port_prior(kt)
        self.prof = self.profiled = None
        self.n = int(cfg["smc"]["nparticles"])
        self.cost = kt.make_streaming_scan_cost(
            m.step, m.init, m.reduce_cost, observe=m.observe,
            series=self.data["series"], nsteps=int(cfg["nsteps"]),
            noise=cfg["noise"])
        self.results, self.ends = [], []

    def _kw(self, key):
        s = self.cfg["smc"]
        return dict(nparticles=self.n, alpha=s["alpha"],
                    mcmc_retrys=s["mcmc_retrys"], mcmc_tol=s["mcmc_tol"],
                    epstol=s["epstol"], min_r_ess=s["min_r_ess"],
                    max_stretch=s["max_stretch"], max_iters=s["max_iters"],
                    resample=s["resample"],
                    partner_scheme=s["partner_scheme"],
                    cost_vectorized=True, key=key, device=self.device)

    def call(self, key, cost=None, log=None):
        if log is None:
            res = self.kt.smc(self.prior, cost or self.cost, **self._kw(key))
        else:
            res = self.kt.smc_stepped(self.prior, cost or self.cost, log=log,
                                      **self._kw(key))
        return {"C": res.C, "eps": res.eps, "iterations": res.iterations,
                "ess": res.ess,
                "P": [np.asarray(p) for p in leaves(res.P)]}

    def replay(self, i, judges):
        """Solve ``i`` again from its key, host-stepped, each judge fed
        what the cost is handed and returns, the generator's state before
        each call, and each iteration's record; returns the solve's
        result."""
        kt_cost = self.cost

        def cost(thetas, gen):
            state = gen.get_state()
            out = kt_cost(thetas, gen)
            for j in judges:
                j.cost(clone(leaves(thetas)), state, out.clone())
            return out

        class Log:
            @staticmethod
            def emit(**rec):
                for j in judges:
                    j.iteration(rec)

        return self.call(self.key(i), cost, Log())

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
            js = [ScanSMCJudge(self.cfg, self.model, rng=rng,
                               walkers=walkers, control=c) for c in controls]
            again = self.replay(i, js)
            for j in js:
                j.finish(again)
            tie(js[0].r, self.results[i], again)
            out.append((i, js))
        return out

    def work(self, judge):
        """(kernel, operations, bytes) of each launch of a judged solve
        (#5: the init's and one an iteration), by the frozen counts of
        ``metrics/_scan_counts.py``."""
        from metrics import _scan_counts
        one = ("k5",) + _scan_counts.scan_cost(self.mod, self.cfg, self.n)
        return [one] * (judge.t + 1)

