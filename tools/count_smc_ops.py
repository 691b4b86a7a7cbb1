#!/usr/bin/env python3
"""PyTorch operations per smc iteration, on one device and on a walker
mesh, counted on the CPU (a count of calls, not a time).

    python3 tools/count_smc_ops.py [--n N] [--shards K] [--iters I]

Runs the README model's per-walker cost (100 draws a walker; the count
of operations does not depend on it) through ``smc`` for ``--iters``
iterations, unsharded and on ``make_mesh(walker=K, devices=["cpu"] *
K)``, with the roll and the default partner scheme (and on one device
with the bisect quantile that a mesh picks), and prints one JSON line
per run: the operations dispatched per iteration and the commonest
ones. Each operation is one launch on the
card, so the ratio is what sharding adds to the host's work there.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    opts = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    import kissabc_tpu_torch as kt
    from kissabc_tpu_torch.parallel.mesh import make_mesh

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    prior = kt.Factored(kt.Uniform(1, 3),
                        kt.TruncatedNormal(0, 0.05, 0, 100))

    def cost(theta, g):
        mu, sigma = theta
        x = mu + sigma * torch.randn(100, generator=g, device=g.device)
        return torch.hypot(x.mean() - 2.0, (x.std(correction=0) - 0.04) * 50)

    mesh = make_mesh(walker=opts.shards, devices=["cpu"] * opts.shards)
    runs = {"one device": dict(device="cpu"),
            "one device, bisect quantile": dict(device="cpu",
                                                quantile_impl="bisect"),
            f"{opts.shards} shards": dict(mesh=mesh)}
    for where, where_kw in runs.items():
        for scheme in ("roll", "auto"):
            kw = dict(nparticles=opts.n, epstol=0.0, key=2,
                      max_iters=opts.iters, partner_scheme=scheme,
                      **where_kw)
            with warnings.catch_warnings(), Count() as count:
                warnings.simplefilter("ignore", RuntimeWarning)
                res = kt.smc(prior, cost, **kw)
            print(json.dumps({
                "run": where, "partner_scheme": scheme, "n": opts.n,
                "iterations": res.iterations,
                "ops_per_iteration": sum(count.ops.values())
                / res.iterations,
                "commonest": count.ops.most_common(5)}))


if __name__ == "__main__":
    main()
