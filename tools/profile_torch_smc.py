#!/usr/bin/env python3
"""Where the time of kissabc_tpu_torch's ``smc``, ``tsmc`` and ``ABCDE``
goes on one CUDA card.

    python3 tools/profile_torch_smc.py
        [--path flagship|generic|both|scan|perwalker|tsmc|abcde|sweep|all]
        [--parent DIR] [--trace-dir DIR]

Runs ``smc`` once warm without the profiler for the wall time, then once
under ``torch.profiler``. ``--path flagship`` (the default) runs slice
1's path on the flagship README model at 1000 and 2**20 particles, the
flagship cost kernel and the split sweep; ``--path generic`` runs the
same model as a user model through ``make_streaming_moment_cost`` and
``smc(sweep_fused=make_fused_smc_sweep(...))``; ``both`` runs both.
``--path scan`` runs the AR(1) model through ``make_streaming_scan_cost``
at 131072 particles x 1000 steps (``chip_smoke.py``'s ``smc-scan-ar1``);
``--path perwalker`` the README model's per-walker cost ``cost(theta,
gen)`` at 1000 particles (``smc-perwalker``). ``--path tsmc`` runs
``tsmc`` on the conjugate-normal oracle at 4096 particles, 5 MCMC steps,
with the split rejuvenation and with the fused tempered sweep (kernel
#9) (``chip_smoke.py``'s ``tsmc-conjugate``); ``--path abcde`` runs
``ABCDE`` on the flagship model with the streaming cost at 16384
particles for 100 generations at an unreachable eps, split and through
the fused generation (kernel #10) (``abcde-fused``). ``--path sweep``
runs ``chip_smoke.py``'s ``fused-sweep``, 100 steps of
``make_fused_flagship_sweep`` (kernel #2) at 131072 walkers, with
``--parent DIR`` in turns with the checkout under DIR (parent, this,
this, parent), and adds updates/s and sync-or-copy calls per step; with
``--path tsmc``, ``--parent DIR`` times the tempered sweep alone for both
trees in the same turns.
``all`` runs all seven. For each run it prints one JSON line with
the wall time, the iterations (generations for ABCDE), the device busy
time (the union of all CUDA kernel and copy intervals), the device idle
share of the profiled window, the CUDA events and the port's kernel
launches per iteration,
the sync and copy calls (and, for the generic path, those of the fused
sweep called alone 100 times, each with the Python frames it came from,
and the blocking syncs torch's sync debug mode reports; for tsmc's fused
run, the tempered sweep called alone 100 times: its wall, CUDA events,
launches and sync or copy calls per sweep), and the CUDA
kernels that took the most device time. With ``--trace-dir`` a Chrome trace of each profiled
run is written there (tens of MiB each). Needs one CUDA card; imports
nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


SYNC_OR_COPY = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                "cudaMemcpyAsync")


def sync_or_copy_calls(prof):
    """Host calls that wait for the card or copy to or from it."""
    return sum(e.count for e in prof.key_averages() if e.key in SYNC_OR_COPY)


def sweep_syncs(torch, prior, sweep, n, calls=100):
    """The fused sweep called alone ``calls`` times, with eps and the
    flag on the card as smc passes them: its sync or copy calls per call
    (0 means the sweep reads nothing on the host), each such call with
    its count and the Python frames it came from, and the blocking syncs
    torch's sync debug mode reports over the same calls."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    th = prior.sample_tree(gen, n)
    args = (torch.full((n,), 0.5, device="cuda"), prior.logpdf_tree(th),
            torch.ones(n, dtype=torch.bool, device="cuda"),
            torch.tensor(0.5, device="cuda"), torch.tensor(False,
                                                           device="cuda"))
    sweep(gen, th, *args)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True) as prof:
        for _ in range(calls):
            sweep(gen, th, *args)
    torch.cuda.synchronize()
    sources = [{"call": e.key, "count": e.count,
                "stack": [f for f in e.stack if "profile_torch_smc" not in f
                          ][:6]}
               for e in prof.key_averages(group_by_stack_n=12)
               if e.key in SYNC_OR_COPY]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(calls):
                sweep(gen, th, *args)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    blocking = [str(w.message).splitlines()[0] for w in caught
                if "synchroniz" in str(w.message)]
    return {"calls": calls,
            "sync_or_copy_per_call": sync_or_copy_calls(prof) / calls,
            "sources": sources, "blocking_syncs": len(blocking),
            "blocking_examples": blocking[:3]}


def tempered_sweep_alone(torch, sweep, n=4096, calls=100):
    """The fused tempered sweep (#9) called alone ``calls`` times on
    ``n`` walkers of the conjugate model at lam 0.3 (on the card, as tsmc
    passes it): its warm wall per sweep, and under the profiler its CUDA
    events, its #9 launches and its sync or copy calls per sweep."""
    from torch.profiler import ProfilerActivity, profile

    from kissabc_tpu_torch import models

    prior, ll_elem, _, _ = models.conjugate_normal()
    gen = torch.Generator(device="cuda").manual_seed(0)
    th = torch.randn(n, generator=gen, device="cuda")
    lp, ll = prior.logpdf(th).float(), ll_elem(th).float()
    h = n // 2
    state = ((th[:h], th[h:]), ((lp[:h], ll[:h]), (lp[h:], ll[h:])))
    lam = torch.tensor(0.3, device="cuda")

    def run():
        nonlocal state
        for _ in range(calls):
            state = sweep(gen, *state, lam)
        torch.cuda.synchronize()

    run()   # warm
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"calls": calls, "nparticles": n, "wall_ms_per_sweep":
            wall / calls * 1e3,
            "cuda_events_per_sweep": len(events) / calls,
            "kernel_events_per_sweep": sum(
                "fused_tempered" in e.name for e in events) / calls,
            "sync_or_copy_per_sweep": sync_or_copy_calls(prof) / calls}


def path_spec(torch, kt, path):
    """(prior, cost, smc keywords, [(particles, extra keywords)])."""
    from kissabc_tpu_torch import models

    readme = dict(cost_vectorized=True, epstol=0.011113, key=2)
    sizes = [(1000, {}), (1 << 20, {"min_r_ess": 0.5})]
    prior, draw, reduce_cost = models.flagship()
    if path == "flagship":
        return prior, kt.make_flagship_cost_batched(), readme, sizes
    if path == "generic":
        return (prior, kt.make_streaming_moment_cost(draw, reduce_cost),
                dict(readme, sweep_fused=kt.make_fused_smc_sweep(
                    prior, draw, reduce_cost)), sizes)
    if path == "scan":
        aprior, step, init, areduce = models.ar1()
        return (aprior, kt.make_streaming_scan_cost(step, init, areduce,
                                                    nsteps=1000),
                dict(cost_vectorized=True, epstol=0.15, key=9),
                [(131072, {})])

    def cost(theta, gen):   # __graft_entry__.py:17-22, per walker
        mu, sigma = theta
        x = mu + sigma * torch.randn(1000, generator=gen, device=gen.device)
        return torch.hypot(x.mean() - 2.0, (x.std(correction=0) - 0.04) * 50)

    return prior, cost, dict(epstol=0.011113, key=2), [(1000, {})]


def _modules():
    from kissabc_tpu_torch.ops import (fused_abcde, fused_smc,
                                       fused_tempered, kernels, scan,
                                       streaming)
    return (kernels, streaming, fused_smc, scan, fused_tempered, fused_abcde)


def measure(torch, call, trace, modules=None):
    """Runs ``call()`` (one whole run of a sampler) warm, then timed,
    then under ``torch.profiler``. Returns (result, wall seconds, the
    kernel launches of the timed run counted by ``modules`` (default the
    port's), the profiler, the profiled wall seconds); ``trace`` names a
    Chrome trace to write, or None."""
    from torch.profiler import ProfilerActivity, profile

    modules = modules or _modules()

    def run():
        for m in modules:
            m.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    run()  # warm: kernel build, allocator, lazy CUDA init
    res, wall = run()
    launches = {k: v for m in modules for k, v in m.launches.items() if v}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_prof = run()
    if trace:
        prof.export_chrome_trace(trace)
    return res, wall, launches, prof, wall_prof


def device_summary(torch, prof, wall_prof, iterations):
    """Busy time, idle share, CUDA events per iteration, sync or copy
    calls and the top kernels of a profiled run."""
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    intervals = [(e.time_range.start, e.time_range.end) for e in dev_events]
    busy = busy_us(intervals) / 1e6
    by_name = {}
    for e in dev_events:
        t = e.time_range.end - e.time_range.start
        name = e.name[:80]
        n_, t_ = by_name.get(name, (0, 0.0))
        by_name[name] = (n_ + 1, t_ + t)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {
        "wall_profiled_s": wall_prof,
        "device_busy_s": busy if dev_events else None,
        "device_idle_share": (1 - busy / wall_prof) if dev_events else None,
        "cuda_events": len(dev_events),
        "cuda_events_per_iteration": len(dev_events) / max(iterations, 1),
        "sync_or_copy_calls": sync_or_copy_calls(prof),
        "top_kernels_ms": [{"name": k, "count": c, "ms": t / 1e3}
                           for k, (c, t) in top],
    }


def profile_sampler(torch, kt, path, trace_dir):
    """tsmc (split and fused, 4096) or ABCDE (split and fused, 16384 x
    100 generations): one JSON-ready dict per run."""
    from kissabc_tpu_torch import models

    out = []
    for fused in (False, True):
        if path == "tsmc":
            prior, ll_elem, ll_vec, _ = models.conjugate_normal()
            sweep = (kt.make_fused_tempered_sweep(prior, ll_elem) if fused
                     else None)
            n = 4096

            def call():
                return kt.tsmc(prior, ll_vec, nparticles=n, mcmc_steps=5,
                               loglike_vectorized=True, sweep_fused=sweep,
                               key=1)
        else:
            prior, draw, reduce_cost = models.flagship()
            cost = kt.make_streaming_moment_cost(draw, reduce_cost)
            gen = (kt.make_fused_abcde_generation(
                prior, draw, reduce_cost, gamma=2.38 / 2.0) if fused
                else None)
            n = 16384

            def call():
                return kt.ABCDE(prior, cost, 1e-6, nparticles=n,
                                generations=100, cost_vectorized=True,
                                sweep_fused=gen, verbose=False, key=2)
        label = f"{path}_{'fused' if fused else 'split'}"
        trace = os.path.join(trace_dir, f"{label}_{n}.json") \
            if trace_dir else None
        res, wall, launches, prof, wall_prof = measure(torch, call, trace)
        alone = (tempered_sweep_alone(torch, sweep)
                 if path == "tsmc" and fused else None)
        out.append({"path": label, "nparticles": n,
                    "iterations": res.iterations, "wall_s": wall,
                    **device_summary(torch, prof, wall_prof, res.iterations),
                    "kernel_launches": launches, "fused_sweep_alone": alone,
                    "trace": trace})
    return out


def profile_sweep(torch, trees, trace_dir, n=131072, steps=100):
    """``chip_smoke.py``'s ``fused-sweep``: ``steps`` steps of
    ``make_fused_flagship_sweep(n)`` at eps 0.5 from the prior, once warm
    for the wall and updates/s, then under the profiler, for each tree of
    ``trees`` (name -> package) in turn: one dict each."""
    import importlib

    out = []
    for who, pkg in trees:
        step = pkg.make_fused_flagship_sweep(n)
        prior = importlib.import_module(
            f"{pkg.__name__}.models").flagship()[0]
        th0 = prior.sample_tree(torch.Generator(device="cuda").manual_seed(0),
                                n)

        def call():
            gen = torch.Generator(device="cuda").manual_seed(1)
            th, xs = th0, torch.ones(n, device="cuda")
            lps = torch.zeros(n, device="cuda")
            acc = torch.zeros((), dtype=torch.int64, device="cuda")
            for _ in range(steps):
                th, xs, lps, a = step(gen, th, xs, lps, 0.5)
                acc += a
            return acc

        trace = (os.path.join(trace_dir, f"sweep_{who}_{n}.json")
                 if trace_dir else None)
        acc, wall, launches, prof, wall_prof = measure(
            torch, call, trace, modules=(pkg.ops.kernels,))
        summary = device_summary(torch, prof, wall_prof, steps)
        out.append({"path": "sweep", "tree": who, "nparticles": n,
                    "steps": steps, "wall_s": wall,
                    "updates_per_s": n * steps / wall,
                    "accept_fraction": int(acc) / (n * steps), **summary,
                    "sync_or_copy_per_step":
                        summary["sync_or_copy_calls"] / steps,
                    "kernel_launches": launches, "trace": trace})
    return out


def profile_run(torch, kt, path, spec, nparticles, trace_dir, **kw):
    prior, cost, base, _ = spec
    kw = dict(base, **kw)

    def call():
        return kt.smc(prior, cost, nparticles=nparticles, max_iters=2000,
                      **kw)

    trace = (os.path.join(trace_dir, f"smc_{path}_{nparticles}.json")
             if trace_dir else None)
    res, wall, launches, prof, wall_prof = measure(torch, call, trace)

    per_sweep = (sweep_syncs(torch, prior, kw["sweep_fused"], nparticles)
                 if path == "generic" else None)
    return {
        "path": path, "nparticles": nparticles,
        "iterations": res.iterations, "eps": res.eps, "wall_s": wall,
        **device_summary(torch, prof, wall_prof, res.iterations),
        "kernel_launches": launches, "fused_sweep_alone": per_sweep,
        "trace": trace,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("flagship", "generic", "both", "scan",
                                       "perwalker", "tsmc", "abcde", "sweep",
                                       "all"),
                    default="flagship")
    ap.add_argument("--parent", default=None,
                    help="with --path sweep (or tsmc: the tempered sweep "
                    "alone): also the checkout under DIR, in turns (parent, "
                    "this, this, parent)")
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_smc: no CUDA device", file=sys.stderr)
        return 1
    import kissabc_tpu_torch as kt

    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    paths = {"both": ("flagship", "generic"),
             "all": ("flagship", "generic", "scan", "perwalker", "tsmc",
                     "abcde", "sweep")}.get(args.path, (args.path,))
    for path in paths:
        if path == "sweep":
            trees = [("this", kt)]
            if args.parent:
                sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
                from same_bits import load_package
                old = load_package(args.parent, "kt_parent")
                trees = [("parent", old), ("this", kt), ("this", kt),
                         ("parent", old)]
            for row in profile_sweep(torch, trees, args.trace_dir):
                print(json.dumps(row), flush=True)
            continue
        if path in ("tsmc", "abcde"):
            for row in profile_sampler(torch, kt, path, args.trace_dir):
                print(json.dumps(row), flush=True)
            if path == "tsmc" and args.parent:
                sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
                from same_bits import load_package
                old = load_package(args.parent, "kt_parent")
                for who, pkg in (("parent", old), ("this", kt), ("this", kt),
                                 ("parent", old)):
                    sweep = pkg.make_fused_tempered_sweep(
                        *pkg.models.conjugate_normal()[:2])
                    print(json.dumps({"tree": who, **tempered_sweep_alone(
                        torch, sweep)}), flush=True)
            continue
        spec = path_spec(torch, kt, path)
        for n, kw in spec[3]:
            print(json.dumps(profile_run(torch, kt, path, spec, n,
                                         args.trace_dir, **kw)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
