"""One adaptive smc solve with the split sweep and a batched cost, held
to the reference step by step (the algorithm of KissABC.jl's ``smc``,
``src/smc.jl``).

The split sweep has no kernel of its own: each iteration the program
draws the proposals' scales, the two rotations and the log accept draws
from its ``torch.Generator``, hands the pushed proposals to the batched
cost (which draws its seed word), then applies the gates. The judge is
fed what each cost call is handed and returns, the generator's state
before the call, and after each iteration the record the host-stepped
loop logs (``iteration``, ``eps``, ``ess``, ``accepted``). From its own
carried state (population, costs, alive mask) it works out again:

- ``cost`` (the init and every sweep): a sample of the walkers' costs,
  each walker's whole path in float64 from the kernel's own noise
  (``scan_streams``), by the configuration's ``ref_cost``;
- ``iteration``: the threshold (the type-7 ``alpha`` quantile of the
  alive costs), the boundary flag, the alive mask, the resampling
  decision and ancestry (replication of the alive walkers), the words the
  sweep drew (the generator's state must follow from the last call's by
  exactly those draws), every walker's proposal (Gaussian-difference
  moves against the two rotated partners), the prior gate, the
  threshold gate on the program's costs, the commit, the accept count
  and the stopping rule;
- ``finish``: the returned population, costs, threshold, iterations
  and alive count.

What the hooks do not show: the program's log-priors (the gate is
worked out from the reference's, which are equal for every walker
inside a uniform prior), its evidence, and its alive mask and
population between iterations, which the judge carries itself and holds
to the program's next proposals and to the result.

Numbers (``Readings``): ``eps`` the widest relative gap of a threshold;
``value`` of a proposal (relative to max(|x|, 1)); ``cost`` the widest
absolute distance of a sampled cost from the float64 path's; ``flip``
the widest reference margin at which a decision went the other way (a
share of the support's width at the prior gate, of the threshold at the
cost gate); ``exact`` the count of mismatches where the program and the
reference must agree bit for bit (the generator's stream, the loop's
carried state, the alive count, the accept count, the stopping rule,
the result).

With ``control=True`` the reference itself, computed in bfloat16 from
the same inputs, stands in the program's place: its thresholds,
proposals, costs and decisions are judged, and ``exact`` is not read.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import priors, streams
from .judge import Readings, rel_gap, sample
from .scan_streams import scan_noise
from .smc_judge import below, roll_shifts, type7

NAMES = ("eps", "value", "cost", "flip")
_F32 = torch.float32


def _gen(state, device):
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


class ScanSMCJudge:
    def __init__(self, cfg, model, *, rng, walkers, control=False):
        s = cfg["smc"]
        if int(s["mcmc_retrys"]) != 0 or s["resample"] != "replicate" \
                or s["partner_scheme"] != "roll":
            raise ValueError("the judge follows one sweep an iteration, "
                             "replication and rotated partners")
        self.prior, self.model = model.ref_prior, model
        self.n, self.alpha = int(s["nparticles"]), float(s["alpha"])
        self.min_r_ess, self.epstol = float(s["min_r_ess"]), float(s["epstol"])
        self.r_epstol = float(s.get("r_epstol") or
                              (1 - self.alpha) ** 1.5 / 50.0)
        self.tol_count = float(s["mcmc_tol"]) * self.n
        self.max_iters = int(s["max_iters"])
        self.max_stretch = float(s["max_stretch"])
        self.d = len(self.prior)
        self.nsteps = int(cfg["nsteps"])
        self.rng, self.k, self.control = rng, int(walkers), control
        self.low = torch.bfloat16 if control else None
        self.r = Readings(NAMES)
        self.state = None        # (leaves, costs, alive) carried
        self.eps = float("inf")
        self.last = None         # the generator's state at the last call
        self.pending = None      # the sweep's cost call, until its record
        self.sims = []           # the sampled walkers of every call
        self.t = 0
        self.done = []

    def cost(self, pushed, state, costs):
        """A cost call: the pushed population it was handed (leaves), the
        generator's state before it drew its seed, and its costs."""
        if self.state is None:
            self._init(pushed, state, costs)
        else:
            self.pending = (pushed, state, costs)

    def _sample(self, pushed, state, costs):
        """Keep ``k`` walkers of a call, drawn among all, for the path
        check: their parameters, the call's seed word, the program's
        costs."""
        dev = costs.device
        seed = streams.generator_words(state, 1, dev)[0][0]
        idx = sample(torch.ones(self.n, dtype=torch.bool, device=dev),
                     self.rng, self.k)
        self.sims.append({"idx": idx, "seed": seed,
                          "theta": [x[idx].double() for x in pushed],
                          "got": costs[idx].double()})
        return self.sims[-1]

    def _init(self, pushed, state, costs):
        dev = costs.device
        inside = torch.isfinite(priors.logpdf(
            self.prior, [x.double() for x in pushed]))
        if not self.control:
            self.r.mismatch("an initial walker outside the prior",
                            (~inside).sum())
        self._sample(pushed, state, costs)
        self.state = (list(pushed), costs,
                      torch.ones(self.n, dtype=torch.bool, device=dev))
        self.last = state

    def _draws(self, state, dev):
        """The sweep's draws from the generator's state at the last cost
        call: that call's seed word, then the scales' normals, the two
        rotation words and the exponentials of the log accept draws; and
        the state they leave."""
        g = _gen(state, dev)
        torch.randint(0, 1 << 32, (1,), generator=g, device=dev,
                      dtype=torch.int64)
        z = torch.randn(self.n, generator=g, device=dev)
        w = torch.randint(0, 1 << 32, (2,), generator=g, device=dev,
                          dtype=torch.int64)
        e = torch.empty(self.n, dtype=_F32, device=dev).exponential_(
            generator=g)
        return z, w.tolist(), e, g.get_state()

    def iteration(self, rec):
        """The record of an iteration: ``iteration``, ``eps`` (the
        threshold), ``ess`` (the alive count after resampling) and
        ``accepted`` (the sweep's commits)."""
        self.t += 1
        leaves, xs, alive = self.state
        pushed, state, xp = self.pending
        self.pending = None
        dev, n = xs.device, self.n
        eps = torch.tensor(rec["eps"], dtype=_F32, device=dev)
        # the threshold, the flag, the alive mask, the resampling
        costs = xs[alive]
        want = type7(costs, self.alpha)
        got = (type7(costs, self.alpha, self.low) if self.control
               else eps.double())
        self.r.gap("eps", (got - want).abs() / want.abs())
        flag = ~(eps > costs.min())
        alive = below(xs, eps, flag)
        ess = alive.sum()
        if bool(self.alpha * ess.to(_F32) <= n * self.min_r_ess):
            idx = torch.nonzero(alive).flatten()
            idx = idx[torch.arange(n, device=dev) % idx.numel()]
            leaves, xs = [x[idx] for x in leaves], xs[idx]
            alive = torch.ones_like(alive)
        if not self.control:
            self.r.mismatch("alive count", rec["ess"] != int(alive.sum()))
        # the sweep's draws, the proposals, the prior gate
        z, words, e, after = self._draws(self.last, dev)
        self.last = state
        if not self.control:
            self.r.mismatch("generator stream", not torch.equal(
                after.cpu(), state.cpu()))
        r1, r2 = roll_shifts(words[0], words[1], n)
        ar = torch.arange(n, device=dev)
        i2, i1 = (ar - r2) % n, (ar - r1) % n
        scale = self.max_stretch / math.sqrt(self.d)
        x64 = [x.double() for x in leaves]
        props = [x + (x[i2] - x[i1]) * (scale * z.double()) for x in x64]
        if self.control:
            wl = scale * z.to(self.low)
            got_props = [(x + (x[i2] - x[i1]) * wl).double()
                         for x in (x.to(self.low) for x in leaves)]
        else:
            got_props = [p.double() for p in pushed]
        for a, p in zip(got_props, props):
            self.r.gap("value", rel_gap(a, p))
        # the gate on the program's proposals carries the state (the
        # control's too); a proposal on the other side of the support's
        # edge than the float64 one is a flip
        lpp = priors.logpdf(self.prior, [p.double() for p in pushed])
        lm = torch.clamp(lpp - priors.logpdf(self.prior, x64), max=0.0)
        gate1 = alive & torch.isfinite(lpp) & (-e.double() < lm)
        got_in = torch.isfinite(priors.logpdf(self.prior, got_props))
        want_in = torch.isfinite(priors.logpdf(self.prior, props))
        margin = priors.support_margin(self.prior, props).abs()
        self.r.gap("flip", margin[got_in != want_in])
        # the threshold gate on the program's costs, the commit
        commit = gate1 & below(xp, eps, flag)
        if not self.control:
            self.r.mismatch("accept count",
                            rec["accepted"] != int(commit.sum()))
            done = (2.0 * torch.abs(torch.tensor(self.eps, dtype=_F32)
                                    - eps.cpu())
                    < self.r_epstol * (abs(self.eps) + torch.abs(eps.cpu())))
            self.done.append(bool(done | (eps.cpu() <= self.epstol)
                                  | (int(commit.sum()) < self.tol_count)))
        sim = self._sample(pushed, state, xp)
        sim.update(eps=eps.double(), flag=flag, gate1=gate1[sim["idx"]])
        self.state = ([torch.where(commit, p, x) for p, x in zip(pushed,
                                                                  leaves)],
                      torch.where(commit, xp, xs), alive)
        self.eps = float(rec["eps"])

    def _paths(self):
        """Every sampled walker's cost, by the float64 path (``lo``) and
        by the program's precision or the control's (``got``)."""
        idx = torch.cat([s["idx"] for s in self.sims])
        seeds = torch.cat([s["seed"].expand(s["idx"].numel())
                           for s in self.sims])
        theta = [torch.cat([s["theta"][j] for s in self.sims])
                 for j in range(self.d)]
        z = scan_noise(seeds, idx, self.nsteps)
        want = self.model.ref_cost(theta, z)
        if self.control:
            got = self.model.ref_cost(theta, scan_noise(
                seeds, idx, self.nsteps, self.low), self.low)
        else:
            got = torch.cat([s["got"] for s in self.sims])
        self.r.gap("cost", (got - want).abs())
        at = 0
        for s in self.sims:
            m = s["idx"].numel()
            w, g = want[at:at + m], got[at:at + m]
            at += m
            if "eps" not in s:
                continue
            eps, flag = s["eps"], s["flag"]
            went = s["gate1"] & (below(w, eps, flag) != below(g, eps, flag))
            self.r.gap("flip", ((w - eps).abs() / eps)[went])

    def finish(self, result):
        """The solve's result: ``C`` (costs), ``eps``, ``iterations``,
        ``ess`` and ``P`` (the alive walkers' leaves, numpy)."""
        self._paths()
        if self.control:
            return
        t = self.t
        stops = [i + 1 for i, d in enumerate(self.done) if d]
        self.r.mismatch("stopping rule",
                        not (stops == [t] or (t == self.max_iters
                                              and not stops)))
        leaves, xs, alive = self.state
        self.r.mismatch("result iterations", result["iterations"] != t)
        self.r.mismatch("result eps", result["eps"] != self.eps)
        self.r.mismatch("result costs", not np.array_equal(
            result["C"], xs.cpu().numpy()))
        self.r.mismatch("result ess", result["ess"] != int(alive.sum()))
        for p, x in zip(result["P"], leaves):
            self.r.mismatch("result population", not np.array_equal(
                np.asarray(p), x[alive].cpu().numpy()))
