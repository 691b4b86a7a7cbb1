"""Red/black AIS sweeps with the kernelized ABC density (KissABC.jl's
``ApproxKernelizedPosterior`` and ``AIS``), held to the reference half
by half.

A sweep updates half A against partners in half B, then half B against
the updated half A. Each half draws seven words from the generator: six
partner rotations (distinct within each move) and the half's seed. For
each walker of the half, its own Philox words choose the move of the
4:2:1 mixture (stretch against one partner, differential evolution
against two, walk against three), its scales and its accept draw; the
proposal is held to the prior's support, simulated, and accepted by
Metropolis-Hastings on log-prior plus ``-(cost / scale)^2 / 2``.

The judge works out every walker's proposal and log-prior, and for a
sample of the walkers inside the support, the simulation, the cost and
the accept decision. Numbers: ``value`` (committed proposals and
log-priors, relative to max(|x|, 1)), ``cost`` (a committed cost against
the reference's, over the scale), ``flip`` (the widest reference margin
at which a decision went the other way: a share of the support's width,
or the log accept ratio less the log accept draw); ``exact`` counts the
replayed block's departures from the window's state (``jobs.py``).
``control=True``: the reference in bfloat16 stands in the program's
place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import priors, streams
from .judge import Readings, rel_gap, sample

NAMES = ("value", "cost", "flip")
_F32 = np.float32


def _bump(raw):
    out = []
    for u in raw:
        for e in sorted(out):
            u += int(u >= e)
        out.append(u)
    return out


def rotations(words, h):
    """The six partner rotations of a half from its first six words:
    one for the stretch, two distinct for the DE move, three distinct
    for the walk."""
    v = [int(x) for x in words[:6]]
    return ([v[0] % h] + _bump([v[1] % h, v[2] % (h - 1)])
            + _bump([v[3] % h, v[4] % (h - 1), v[5] % (h - 2)]))


class AISJudge:
    def __init__(self, cfg, model, *, rng, walkers, control=False):
        a = cfg["ais"]
        self.prior, self.model = model.ref_prior, model
        self.d = len(self.prior)
        self.scale = float(a["scale"])
        sa = math.sqrt(float(a["a_stretch"]))
        self.g_lo, self.g_span = 1.0 / sa, sa - 1.0 / sa
        self.dscale = 2.38 / math.sqrt(2 * self.d)
        # the mixture's thresholds as the program states them (float32)
        self.p_s, self.p_d = float(_F32(4.0 / 7.0)), float(_F32(6.0 / 7.0))
        self.npairs = -(-(self.d + 4) // 2)
        self.ndraws, self.chunk = int(cfg["ndraws"]), int(cfg["chunk"])
        self.rng, self.k, self.control = rng, int(walkers), control
        self.low = torch.bfloat16 if control else torch.float64
        self.r = Readings(NAMES)
        self.inside = []          # walkers proposing inside the prior, a half

    def init(self, pushed, state, costs, lds):
        """The initial population (pushed leaves), the generator's state
        before the cost drew its seed, the costs and ``(lp, ll)``."""
        dev = costs.device
        n = costs.numel()
        seed = streams.generator_words(state, 1, dev)[0][0]
        idx = sample(torch.ones(n, dtype=torch.bool, device=dev), self.rng,
                     self.k)
        theta = [x[idx].double() for x in pushed]
        z = streams.sim_noise(seed, idx, self.ndraws, self.chunk,
                              streams.STREAM_COST)
        want = self.model.ref_cost(theta, z)[0]
        got = (self.model.ref_cost(theta, z, self.low)[0] if self.control
               else costs[idx].double())
        self.r.gap("cost", (got - want).abs() / self.scale)
        lp = priors.logpdf(self.prior, [x.double() for x in pushed])
        if not self.control:
            self.r.gap("value", rel_gap(lds[0], lp))

    def proposals(self, upd, comp, shifts, ww, dtype=torch.float64):
        """Every walker's proposal (leaves), its log correction and its
        accept uniform, computed in ``dtype``."""
        h = upd[0].numel()
        ar = torch.arange(h, device=upd[0].device)
        u_mid, u_z = streams.unit(ww[0], dtype), streams.unit(ww[1], dtype)
        nrm = []
        for q in range(self.npairs):
            nrm.extend(streams.normal_pair(ww[3 + 2 * q], ww[4 + 2 * q],
                                           dtype))
        is_s = u_mid < self.p_s
        is_d = (u_mid >= self.p_s) & (u_mid < self.p_d)
        zroot = u_z * self.g_span + self.g_lo
        z = zroot * zroot
        corr = torch.where(is_s, 2.0 * (self.d - 1) * torch.log(zroot),
                           torch.zeros_like(zroot))
        gamma = self.dscale * torch.exp(0.1 * nrm[0])
        nzs, rr = nrm[1:1 + self.d], nrm[1 + self.d:4 + self.d]
        props = []
        for x, c, nz in zip(upd, comp, nzs):
            x, c = x.to(dtype), c.to(dtype)
            p = [c[(ar + s) % h] for s in shifts]
            p_s = p[0] + z * (x - p[0])
            tri = (p[1] - p[2]).abs() + (x - p[2]).abs() + (p[1] - x).abs()
            p_d = x + gamma * (p[1] - p[2]) + gamma * tri / 300.0 * nz
            cen = (p[3] + p[4] + p[5]) / 3.0
            p_w = x + (rr[0] * (p[3] - cen) + rr[1] * (p[4] - cen)
                       + rr[2] * (p[5] - cen))
            props.append(torch.where(is_s, p_s, torch.where(is_d, p_d,
                                                            p_w)).double())
        return props, corr.double(), streams.unit(ww[2])

    def half(self, upd, lp, ll, comp, words, out, full=True):
        """One half: its leaves, ``lp``, ``ll``, the partners' half, its
        seven words and the outputs ``(leaves, lp, ll)``. Without
        ``full`` only the proposals are worked out (the count inside the
        prior), and nothing is judged."""
        dev = lp.device
        h = lp.numel()
        shifts = rotations(words.tolist(), h)
        seed = words[6].to(dev)
        ar = torch.arange(h, device=dev)
        ww = streams.walker_words(seed, ar, streams.STREAM_AIS_WALKER,
                                  3 + 2 * self.npairs)
        props, corr, u_acc = self.proposals(upd, comp, shifts, ww)
        lpp = priors.logpdf(self.prior, props)
        inside = torch.isfinite(lpp)
        margin_s = priors.support_margin(self.prior, props).abs()
        self.inside.append(int(inside.sum()))
        if not full:
            return
        if self.control:
            changed = None
        else:
            changed = (out[1] != lp) | (out[2] != ll)
            for a, b in zip(out[0], upd):
                changed |= a != b
            self.r.gap("flip", margin_s[changed & ~inside])
            ch = changed & inside
            for a, p in zip(out[0], props):
                self.r.gap("value", rel_gap(a[ch], p[ch]))
            self.r.gap("value", rel_gap(out[1][ch], lpp[ch]))
        if not full:
            return
        idx = sample(inside & (margin_s > 1e-6), self.rng, self.k)
        if idx is None:
            return
        theta = [p[idx].float().double() for p in props]
        zs = streams.sim_noise(seed, idx, self.ndraws, self.chunk,
                               streams.STREAM_AIS_SIM)
        cost = self.model.ref_cost(theta, zs)[0]
        llp = -0.5 * torch.square(cost / self.scale)
        base = lp[idx].double() + ll[idx].double()
        logu = torch.log1p(-u_acc[idx])
        margin = corr[idx] + (lpp[idx] + llp) - base - logu
        if self.control:
            low = self.low
            lprops = self.proposals(upd, comp, shifts, ww, low)[0]
            for a, p in zip(lprops, props):
                self.r.gap("value", rel_gap(a[inside], p[inside]))
            cl = self.model.ref_cost([a[idx].to(low) for a in lprops], zs,
                                     low)[0]
            got_cost = cl
            lw = (corr[idx].to(low) + (lpp[idx].to(low)
                  - 0.5 * torch.square(cl.to(low) / self.scale))
                  - base.to(low))
            got_commit = logu.to(low) <= lw
        else:
            got_commit = changed[idx]
            got_cost = self.scale * torch.sqrt(torch.clamp(
                -2.0 * out[2][idx].double(), min=0.0))
        self.r.gap("flip", margin.abs()[got_commit != (margin >= 0)])
        self.r.gap("cost", ((got_cost.double() - cost).abs()
                            / self.scale)[got_commit])

    def sweep(self, inp, state, out, full=True):
        """One sweep: inputs ``(leaves, (lp, ll))`` over the whole
        population, the generator's state before it, the outputs; without
        ``full`` only counted (``half``)."""
        (leaves, (lp, ll)), (oleaves, (olp, oll)) = inp, out
        dev = lp.device
        n = lp.numel()
        h = n // 2
        wa, state = streams.generator_words(state, 7, dev)
        wb, _ = streams.generator_words(state, 7, dev)
        a, b = slice(0, h), slice(h, n)
        self.half([x[a] for x in leaves], lp[a], ll[a],
                  [x[b] for x in leaves], wa,
                  ([x[a] for x in oleaves], olp[a], oll[a]), full)
        self.half([x[b] for x in leaves], lp[b], ll[b],
                  [x[a] for x in oleaves], wb,
                  ([x[b] for x in oleaves], olp[b], oll[b]), full)
