"""sir-cle: the stochastic SIR epidemic (Kermack-McKendrick) in its
diffusion (chemical Langevin) form, integrated by Euler-Maruyama as
``examples/example_sir.py`` does: a closed population of ``population``
with ``i0`` infectious, ``days`` observed days each split into two
sub-steps (the infection flow on even t, the recovery flow on odd t, one
normal noise each), fitted to the deterministic curve at ``theta_true``
by the mean of |I - obs| over the recovery sub-steps, scaled by
2 / population. The sizes are in ``sir-cle.json``.

``model(cfg, data)`` gives the model as the program takes it (``step``,
``init``, ``observe``, ``reduce_cost``: elementwise PyTorch that the port
compiles into its scan kernel) and as the plain reference computes it
(``ref_cost``, in float64, or in a lower precision for the control).
``make_data`` makes the observed series. ``STEP_OPS``, ``OBSERVE_OPS``
and ``INIT_OPS`` are the frozen operation counts of the roofline
(``metrics/_scan_counts.py``), a transcendental counted as one.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import priors

# per step: t % 2 == 0 (2), the two flows and their where (beta*s, *i,
# /N, gamma*i, where: 5), the noise term (clamp, sqrt, *eps, +: 4), the
# clamp of the flow to [0, s or i] (where, max, min: 3), the new state
# (s - dn, where, i + dn, i - dn, where: 5)
STEP_OPS = 2 + 5 + 4 + 3 + 5
# per step: t % 2 == 1 (2), i - obs, abs, where, * 2, / N (5)
OBSERVE_OPS = 2 + 5
# per walker: the two initial states, each a constant plus 0 * beta (2)
INIT_OPS = 2 * 2
# the observations, the state leaves, the parameter leaves, the series
NSTATS, NSTATE, NLEAVES, NSERIES = 1, 2, 2, 1


def make_data(cfg):
    """The observed series: the deterministic SIR at ``theta_true``, day
    by day in float64 as ``examples/example_sir.py`` computes it, on the
    recovery sub-steps (odd t) as float32, zeros on the infection
    sub-steps. The port compiles nothing of it: it is read at t."""
    pop, i0 = float(cfg["population"]), float(cfg["i0"])
    beta, gamma = (float(v) for v in cfg["theta_true"])
    s, i, ys = pop - i0, i0, []
    for _ in range(int(cfg["days"])):
        ninf = beta * s * i / pop
        nrec = gamma * i
        s, i = s - ninf, i + ninf - nrec
        ys.append(i)
    series = np.zeros((int(cfg["nsteps"]),), np.float32)
    series[1::2] = np.asarray(ys, np.float32)
    return {"series": series}


class Model:
    def __init__(self, cfg, data):
        self.pop, self.i0 = float(cfg["population"]), float(cfg["i0"])
        self.nsteps = int(cfg["nsteps"])
        if self.nsteps != 2 * int(cfg["days"]):
            raise ValueError("nsteps must be two sub-steps a day")
        self.series = data["series"]
        self.bounds = [(lo, hi) for _, lo, hi in cfg["prior"]]
        # the float32 bounds the program's Uniform holds
        self.ref_prior = [priors.Uniform(float(np.float32(lo)),
                                         float(np.float32(hi)))
                          for lo, hi in self.bounds]

    def port_prior(self, kt):
        return kt.Factored(*(kt.Uniform(lo, hi) for lo, hi in self.bounds))

    def step(self, th, state, eps, t):
        beta, gamma = th
        s, i = state
        even = (t % 2) == 0
        # the infection flow on even t, the recovery flow on odd t
        flow = torch.where(even, beta * s * i / self.pop, gamma * i)
        dn = flow + torch.sqrt(torch.clamp(flow, min=0.0)) * eps
        dn = torch.clamp(dn, torch.zeros_like(dn), torch.where(even, s, i))
        return torch.where(even, s - dn, s), torch.where(even, i + dn, i - dn)

    def init(self, th):
        return (self.pop - self.i0) + 0.0 * th[0], self.i0 + 0.0 * th[0]

    def observe(self, th, state, t, obs):
        # a day ends after its recovery sub-step (odd t); x 2 restores the
        # day average over the sub-steps
        _, i = state
        odd = (t % 2) == 1
        return (torch.where(odd, torch.abs(i - obs), 0.0) * 2.0 / self.pop,)

    def reduce_cost(self, th, m):
        return m[0]

    def ref_cost(self, theta, z, dtype=torch.float64):
        """Each walker's cost from its parameters ``theta`` (two ``[K]``
        tensors) and its path's normals ``z`` (``[K, nsteps]``), the path
        worked out step by step in ``dtype``; returned in float64. The
        branches depend on t alone, and every clamp and the absolute
        value are continuous: a float32 path that takes the other side of
        a clamp's edge moves by no more than its rounding there, so the
        float64 cost is one number, not an interval."""
        beta, gamma = (t.to(dtype) for t in theta)
        z = z.to(dtype)
        obs = torch.as_tensor(self.series, device=z.device).to(dtype)
        s = torch.full_like(beta, self.pop - self.i0)
        i = torch.full_like(beta, self.i0)
        zero = torch.zeros_like(beta)
        acc = zero
        for t in range(self.nsteps):
            if t % 2 == 0:
                flow = beta * s * i / self.pop
                dn = flow + torch.sqrt(torch.clamp(flow, min=0.0)) * z[:, t]
                dn = torch.minimum(torch.maximum(dn, zero), s)
                s, i = s - dn, i + dn
            else:
                flow = gamma * i
                dn = flow + torch.sqrt(torch.clamp(flow, min=0.0)) * z[:, t]
                dn = torch.minimum(torch.maximum(dn, zero), i)
                i = i - dn
                acc = acc + torch.abs(i - obs[t]) * 2.0 / self.pop
        return (acc / self.nsteps).double()


def model(cfg, data):
    return Model(cfg, data)
