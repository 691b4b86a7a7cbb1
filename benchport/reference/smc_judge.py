"""One adaptive smc solve with the fused sweep, held to the reference
step by step (the algorithm of KissABC.jl's ``smc``, ``src/smc.jl``).

The judge is fed what a solve handed its cost and its sweep and what
they returned: the initial population, the generator's state before each
draw of words, each sweep's inputs and outputs. It works out again:

- ``init``: the initial costs of a sample of walkers (their simulations
  from the cost's seed word);
- ``step`` (one an iteration): the threshold (the type-7 ``alpha``
  quantile of the alive costs), the boundary flag, the alive mask, the
  resampling decision and ancestry (replication of the alive walkers),
  the sweep's proposals for every walker (Gaussian-difference moves
  against the two rotated partners), the prior gate, and for a sample of
  the walkers that pass it, the simulation, the cost and the threshold
  gate; and the stopping rule;
- ``finish``: the returned population, costs, threshold and iterations.

Numbers (``Readings``): ``eps`` the widest relative gap of a threshold;
``value`` of a committed proposal or log-prior (relative to max(|x|,
1)); ``cost`` the widest distance of a cost outside the reference's
interval; ``flip`` the widest reference margin at which a decision went
the other way (a share of the support's width at the prior gate, of the
threshold at the cost gate); ``exact`` the count of mismatches where the
program and the reference must agree bit for bit (the loop's carried
state, the alive mask, resampling, the stopping rule, the result).

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

NAMES = ("eps", "value", "cost", "flip")
_F32 = torch.float32
# a walker this close to a gate (in the gate's own margin) may go either
# way in float32; it is not sampled for the simulation
_TIE = 1e-6


def roll_shifts(w0, w1, n):
    """The two distinct partner rotations of a sweep from two words."""
    r1 = w0 % (n - 1) + 1
    r2 = w1 % (n - 2) + 1
    return r1, r2 + (r2 >= r1)


def type7(x, q, dtype=torch.float64):
    """The type-7 ``q`` quantile of the values ``x``, in ``dtype``."""
    xs = torch.sort(x.to(dtype)).values
    m = xs.numel()
    h = (m - 1) * q
    k = math.floor(h)
    frac = h - k
    hi = min(k + 1, m - 1)
    return (xs[k] + frac * (xs[hi] - xs[k])).double()


def below(x, eps, flag):
    return (x < eps) | (flag & (x == eps))


class SMCJudge:
    def __init__(self, cfg, model, *, rng, walkers, control=False):
        s = cfg["smc"]
        self.prior, self.model = model.ref_prior, model
        self.n, self.alpha = int(s["nparticles"]), float(s["alpha"])
        self.min_r_ess, self.epstol = float(s["min_r_ess"]), float(s["epstol"])
        self.r_epstol = float(s.get("r_epstol") or
                              (1 - self.alpha) ** 1.5 / 50.0)
        self.tol_count = float(s["mcmc_tol"]) * self.n
        self.max_iters = int(s["max_iters"])
        self.w_scale = float(s["max_stretch"]) / math.sqrt(len(self.prior))
        self.ndraws, self.chunk = int(cfg["ndraws"]), int(cfg["chunk"])
        self.rng, self.k, self.control = rng, int(walkers), control
        self.low = torch.bfloat16 if control else None
        self.r = Readings(NAMES)
        self.prev = None          # (leaves, xs, lps) after the last step
        self.prev_alive = None
        self.prev_eps = float("inf")
        self.t = 0
        self.done = []
        self.nsim = []            # walkers that pass the prior gate, a sweep

    def init(self, pushed, state, costs):
        """The initial population (pushed leaves), the generator's state
        before the cost drew its seed, and the costs."""
        dev = costs.device
        seed = streams.generator_words(state, 1, dev)[0][0]
        idx = sample(torch.ones(self.n, dtype=torch.bool, device=dev),
                     self.rng, self.k)
        theta = [x[idx].double() for x in pushed]
        z = streams.sim_noise(seed, idx, self.ndraws, self.chunk,
                              streams.STREAM_COST)
        lo, hi = self.model.ref_cost(theta, z)
        got = (self.model.ref_cost(theta, z, self.low)[0] if self.control
               else costs[idx].double())
        self.r.gap("cost", torch.clamp(torch.maximum(lo - got, got - hi),
                                       min=0))
        self.prev = (list(pushed), costs, None)
        self.prev_alive = torch.ones(self.n, dtype=torch.bool, device=dev)

    def _loop(self, inp):
        """The threshold, the flag, the alive mask and the resampling that
        lead from the last step's outputs to this sweep's inputs."""
        leaves, xs, lps, alive, eps, flag = inp
        pl, pxs, plps = self.prev
        costs = pxs[self.prev_alive]
        want = type7(costs, self.alpha)
        got = (type7(costs, self.alpha, self.low) if self.control
               else eps.double())
        self.r.gap("eps", (got - want).abs() / want.abs())
        if self.control:
            return
        xmin = costs.min()
        self.r.mismatch("flag", bool(~(eps > xmin)) != bool(flag))
        alive_t = torch.where(flag, pxs <= eps, pxs < eps)
        ess = alive_t.sum()
        if bool(self.alpha * ess.to(_F32) <= self.n * self.min_r_ess):
            idx = torch.nonzero(alive_t).flatten()
            idx = idx[torch.arange(self.n, device=idx.device) % idx.numel()]
            want_tree = ([x[idx] for x in pl], pxs[idx],
                         None if plps is None else plps[idx])
            alive_t = torch.ones_like(alive_t)
        else:
            want_tree = (pl, pxs, plps)
        self.r.mismatch("alive mask", (alive_t != alive).sum())
        for a, b in zip(want_tree[0], leaves):
            self.r.mismatch("carried walkers", (a != b).sum())
        self.r.mismatch("carried costs", (want_tree[1] != xs).sum())
        if want_tree[2] is None:   # the init's log-priors: the reference's
            self.r.gap("value", rel_gap(lps, priors.logpdf(
                self.prior, [x.double() for x in leaves])))
        else:
            self.r.mismatch("carried log-priors", (want_tree[2] != lps).sum())

    def step(self, inp, state, out, naccept):
        """One iteration: the sweep's inputs ``(leaves, xs, lps, alive,
        eps, flag)``, the generator's state before it drew its words, its
        outputs ``(leaves, xs, lps)`` and its accept count."""
        self.t += 1
        leaves, xs, lps, alive, eps, flag = inp
        dev = xs.device
        self._loop(inp)
        if not self.control:
            ev = torch.tensor(self.prev_eps, dtype=_F32, device=dev)
            stall = 2.0 * torch.abs(ev - eps) < self.r_epstol * (
                torch.abs(ev) + torch.abs(eps))
            self.done.append(bool(stall | (eps <= self.epstol)
                                  | (naccept < self.tol_count)))
        n = self.n
        w = streams.generator_words(state, 3, dev)[0].tolist()
        r1, r2 = roll_shifts(w[0], w[1], n)
        seed = torch.tensor(w[2], dtype=torch.int64, device=dev)
        ar = torch.arange(n, device=dev)
        b1, b2, b3, _ = streams.philox(0, ar, streams.STREAM_SWEEP_WALKER,
                                       0, seed)
        wv = streams.normal_pair(b1, b2)[0] * self.w_scale
        lprob = torch.log1p(-streams.unit(b3))
        i2, i1 = (ar - r2) % n, (ar - r1) % n
        x64 = [x.double() for x in leaves]
        props = [x + (x[i2] - x[i1]) * wv for x in x64]
        lpp = priors.logpdf(self.prior, props)
        lm = torch.clamp(lpp - lps.double(), max=0.0)
        finite = torch.isfinite(lpp)
        gate1 = alive & finite & (lprob < lm)
        m1 = torch.minimum(priors.support_margin(self.prior, props).abs(),
                           torch.where(finite, (lprob - lm).abs(),
                                       torch.full_like(lm, float("inf"))))
        self.nsim.append(int(gate1.sum()))
        eps64 = eps.double()
        if self.control:
            lowp = [(xb + (xb[i2] - xb[i1]) * wv.to(self.low)).double()
                    for xb in (x.to(self.low) for x in leaves)]
            for p, q in zip(lowp, props):
                self.r.gap("value", rel_gap(p[gate1], q[gate1]))
        else:
            changed = (out[1] != xs) | (out[2] != lps)
            for a, b in zip(out[0], leaves):
                changed |= a != b
            self.r.mismatch("a dead walker moved", (changed & ~alive).sum())
            self.r.gap("flip", m1[changed & ~gate1])
            ch = changed & gate1
            for a, p in zip(out[0], props):
                self.r.gap("value", rel_gap(a[ch], p[ch]))
            self.r.gap("value", rel_gap(out[2][ch], lpp[ch]))
            self.r.mismatch("a commit above the threshold",
                            (changed & ~below(out[1], eps, flag)).sum())
            nch = int(changed.sum())
            self.r.mismatch("accept count",
                            not nch <= int(naccept)
                            <= int((gate1 | (m1 <= _TIE)).sum()))
        idx = sample(gate1 & (m1 > _TIE), self.rng, self.k)
        if idx is None:
            self._advance(inp, out, eps)
            return
        theta = [p[idx].float().double() for p in props]
        z = streams.sim_noise(seed, idx, self.ndraws, self.chunk,
                              streams.STREAM_SWEEP_SIM)
        lo, hi = self.model.ref_cost(theta, z)
        sure_commit, sure_reject = below(hi, eps64, flag), ~below(lo, eps64,
                                                                   flag)
        if self.control:
            got = self.model.ref_cost([t.to(self.low) for t in theta], z,
                                      self.low)[0]
            got_commit = below(got.to(self.low).double(), eps64.to(
                self.low).double(), flag)
            same = torch.zeros_like(got_commit)
        else:
            got, got_commit = out[1][idx].double(), changed[idx]
            same = (xs[idx].double() >= lo) & (xs[idx].double() <= hi)
            for p, x in zip(theta, leaves):
                same &= p == x[idx].double()
        self.r.gap("flip", ((lo - eps64) / eps64)[got_commit & sure_reject])
        self.r.gap("flip", ((eps64 - hi) / eps64)[~got_commit & sure_commit
                                                  & ~same])
        self.r.gap("cost", torch.clamp(torch.maximum(lo - got, got - hi),
                                       min=0)[got_commit])
        self._advance(inp, out, eps)

    def _advance(self, inp, out, eps):
        self.prev = (list(out[0]), out[1], out[2])
        self.prev_alive = inp[3]
        self.prev_eps = float(eps)

    def finish(self, result):
        """The solve's result: ``C`` (costs), ``eps``, ``iterations``,
        ``ess`` and ``P`` (the alive walkers' leaves, numpy)."""
        if self.control:
            return
        t = self.t
        stops = [i + 1 for i, d in enumerate(self.done) if d]
        self.r.mismatch("stopping rule",
                        not (stops == [t] or (t == self.max_iters
                                              and not stops)))
        leaves, xs, _ = self.prev
        alive = self.prev_alive
        self.r.mismatch("result iterations", result["iterations"] != t)
        self.r.mismatch("result eps", result["eps"] != self.prev_eps)
        self.r.mismatch("result costs", not np.array_equal(
            result["C"], xs.cpu().numpy()))
        self.r.mismatch("result ess", result["ess"] != int(alive.sum()))
        for p, x in zip(result["P"], leaves):
            self.r.mismatch("result population", not np.array_equal(
                np.asarray(p), x[alive].cpu().numpy()))
