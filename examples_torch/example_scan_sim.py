"""Sequential-simulator toolkit: state-space ABC with
``make_streaming_scan_cost``.

PyTorch counterpart of ``examples/example_scan_sim.py``. The i.i.d.
streaming kernel (example_streaming_sim.py) covers elementwise draw
models; THIS example covers the other common ABC workload shape —
Markovian simulators where each observation depends on the previous
state (the drifted-Wiener class of the reference's test suite,
runtests.jl:116-131; also OU, AR, SIR). ``step``, ``init`` and
``observe`` are compiled into a CUDA kernel
(``kissabc_tpu_torch/csrc/scan.cuh``) that runs each walker's whole path
in one thread with Philox noise and returns the observations averaged
over t, so the simulated path is never stored. On the CPU the same cost
runs the kernel's plain PyTorch version.

Part 1 — Ornstein-Uhlenbeck parameter recovery (3 parameters from ONE
path): discretized OU

    x_{t+1} = x_t + a (m - x_t) + s eps_t

has stationary mean m, variance s^2 / (1 - (1-a)^2), and lag-1
autocorrelation (1-a). Streaming E_t[x], E_t[x^2] and the lag-1 product
E_t[x_t x_{t-1}] (carried via a tuple state (x, x_prev)) identifies
(a, m, s) jointly — the autocovariance needs the sequential kernel; no
i.i.d.-draw summary can see it.

Part 2 — drifted Wiener process, matching an observed per-step moment
curve through ``series=``: X_{t+1} = X_t + mu + sigma eps has
E[X_t^2] = mu^2 t^2 + sigma^2 t; the observed curve is handed to the
kernel and matched pointwise with two differently t-weighted residual
averages (a single time-average would collapse the curve's shape and
leave (mu, sigma) on a ridge). A single stochastic path is a NOISY cost
— smc's population averaging handles it, like the reference's noisy rms
cost — so the recovered posterior is broad but centred.

    python examples_torch/example_scan_sim.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.utils.device import resolve_device

# --------------------------------------------------------------------
# Part 1: OU recovery from streamed stationary + lag-1 statistics
# --------------------------------------------------------------------
TRUE_A, TRUE_M, TRUE_S = 0.3, 1.0, 1.5
NSTEPS = 512

stat_mean = TRUE_M
stat_var = TRUE_S ** 2 / (1.0 - (1.0 - TRUE_A) ** 2)
stat_lag1 = stat_var * (1.0 - TRUE_A) + TRUE_M ** 2  # E[x_t x_{t-1}]


def ou_step(th, state, eps, t):
    a, m, s = th
    x, _ = state
    return (x + a * (m - x) + s * eps, x)   # carry x_{t-1} for the lag


def ou_init(th):
    _, m, _ = th
    return (m, m)  # start at the stationary mean


def ou_observe(th, state, t, obs):
    x, xp = state
    return (x, x * x, x * xp)


def ou_cost(th, means):
    m1, m2, m12 = means
    var = torch.clamp(m2 - m1 * m1, min=1e-6)
    return (torch.abs(m1 - stat_mean)
            + torch.abs(var - stat_var) / stat_var
            + torch.abs(m12 - stat_lag1) / stat_var)


cost = kt.make_streaming_scan_cost(
    ou_step, ou_init, ou_cost, observe=ou_observe, nsteps=NSTEPS)
prior = kt.Factored(kt.Uniform(0.05, 0.9), kt.Uniform(-2, 4),
                    kt.Uniform(0.5, 3.0))


# --------------------------------------------------------------------
# Part 2: drifted Wiener, observed moment curve through series=
# --------------------------------------------------------------------
MU0, SIG0, T = 0.5, 2.0, 30


def w_step(th, x, eps, tt):
    mu, sig = th
    return x + mu + sig * eps


def w_observe(th, x, tt, obs):
    r = (x * x - obs) / (1.0 + obs)             # normalized residual
    w = (tt.float() + 1.0) / T
    return (r, r * w)


def w_cost(th, means):
    return torch.hypot(means[0], 3.0 * means[1])


_t = np.arange(1, T + 1, dtype=np.float32)
y = (MU0 ** 2) * _t ** 2 + (SIG0 ** 2) * _t    # E[X_t^2]
cost2 = kt.make_streaming_scan_cost(
    w_step, lambda th: torch.zeros_like(th[0]), w_cost, observe=w_observe,
    series=y, nsteps=T)
prior2 = kt.Factored(kt.Uniform(0, 1), kt.Uniform(0, 4))


def main(device=None):
    dev = resolve_device(device)
    res = kt.smc(prior, cost, nparticles=1024, cost_vectorized=True,
                 epstol=0.25, key=11, device=dev)
    a_post, m_post, s_post = res.P
    print(f"OU reversion a : {a_post.mean():.3f} ± {a_post.std():.3f}"
          f"   (truth {TRUE_A})")
    print(f"OU mean m      : {m_post.mean():.3f} ± {m_post.std():.3f}"
          f"   (truth {TRUE_M})")
    print(f"OU noise s     : {s_post.mean():.3f} ± {s_post.std():.3f}"
          f"   (truth {TRUE_S})")
    assert abs(a_post.mean() - TRUE_A) < 0.12
    assert abs(m_post.mean() - TRUE_M) < 0.20
    assert abs(s_post.mean() - TRUE_S) < 0.40

    res2 = kt.smc(prior2, cost2, nparticles=1024, cost_vectorized=True,
                  key=12, device=dev)
    mu_post, sig_post = res2.P
    print(f"Wiener drift mu: {mu_post.mean():.3f} ± {mu_post.std():.3f}"
          f"   (truth {MU0})")
    print(f"Wiener sigma   : {sig_post.mean():.3f} ± {sig_post.std():.3f}"
          f"   (truth {SIG0})")
    assert abs(mu_post.mean() - MU0) < 0.25
    assert abs(sig_post.mean() - SIG0) < 0.8
    return res, res2


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
