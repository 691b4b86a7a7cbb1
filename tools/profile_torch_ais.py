#!/usr/bin/env python3
"""Where the time of kissabc_tpu_torch's AIS sweeps goes on one CUDA card.

    python3 tools/profile_torch_ais.py
        [--path split|half|full|generic|all] [--sweeps N] [--trace-dir DIR]

Each path runs ``N`` red/black sweeps (default 100) of the flagship
README model at 131072 walkers, scale 0.005, from the init of
``sample(..., key=0)``: ``split`` is the sweep ``sample`` runs
(``make_sweep_halves``: the batched mixture in PyTorch and the flagship
cost kernel #1 per half), ``half`` the fused sweep with one kernel per
half (#7), ``full`` the one-launch sweep (#8), ``generic`` the model
written as a user model through ``make_fused_ais_sweep`` (#6). Each runs
once warm without the profiler for the wall time, then once under
``torch.profiler``, and prints one JSON line: the wall time, the device
busy time (the union of all CUDA kernel and copy intervals), the device
idle share of the profiled window, the CUDA events, the port's kernel
launches and the sync and copy calls per sweep, and the CUDA kernels
that took the most device time. ``--trace-dir`` writes a Chrome trace
of each profiled run. Needs one CUDA card; imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from profile_torch_smc import busy_us, sync_or_copy_calls  # noqa: E402

N = 131072
SCALE = 0.005


def sweeps_of(kt, path):
    """(sweep, carries halves) of one path."""
    from kissabc_tpu_torch import models
    from kissabc_tpu_torch.core import ais

    prior, draw, reduce_cost = models.flagship()
    if path == "split":
        model = kt.ApproxKernelizedPosterior(
            prior, kt.make_flagship_cost_batched(), SCALE,
            cost_vectorized=True)
        return ais.make_sweep_halves(model, N), True
    if path == "half":
        return kt.make_fused_flagship_ais_sweep(N, scale=SCALE), False
    if path == "full":
        return kt.make_fused_flagship_ais_sweep_onekernel(N,
                                                          scale=SCALE), False
    return kt.make_fused_ais_sweep(prior, draw, reduce_cost,
                                   scale=SCALE), False


def profile_path(torch, kt, path, sweeps, trace_dir):
    from torch.profiler import ProfilerActivity, profile

    from kissabc_tpu_torch.core import ais
    from kissabc_tpu_torch.ops import fused_ais, kernels

    prior = kt.Factored(kt.Uniform(1, 3), kt.TruncatedNormal(0, 0.05, 0, 100))
    model = kt.ApproxKernelizedPosterior(
        prior, kt.make_flagship_cost_batched(), SCALE, cost_vectorized=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    th0, ld0, _ = ais._init_ensemble(model, gen, N, 100)
    sweep, halves = sweeps_of(kt, path)
    if halves:
        th0, ld0 = ais._halves(th0, N // 2), ais._halves(ld0, N // 2)
    modules = (kernels, fused_ais)

    def run():
        for m in modules:
            m.reset_launch_counts()
        g = torch.Generator(device="cuda")
        g.manual_seed(7)
        th, ld = th0, ld0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(sweeps):
            th, ld = sweep(g, th, ld)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()   # warm: kernel build, allocator, lazy CUDA init
    wall = run()
    launches = {k: v for m in modules for k, v in m.launches.items() if v}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = run()
    trace = None
    if trace_dir:
        trace = os.path.join(trace_dir, f"ais_{path}_{N}.json")
        prof.export_chrome_trace(trace)
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us([(e.time_range.start, e.time_range.end)
                    for e in dev_events]) / 1e6
    by_name = {}
    for e in dev_events:
        name = e.name[:80]
        c, t = by_name.get(name, (0, 0.0))
        by_name[name] = (c + 1, t + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "path": path, "walkers": N, "sweeps": sweeps, "wall_s": wall,
        "updates_per_s": N * sweeps / wall, "wall_profiled_s": wall_prof,
        "device_busy_s": busy if dev_events else None,
        "device_idle_share": (1 - busy / wall_prof) if dev_events else None,
        "cuda_events_per_sweep": len(dev_events) / sweeps,
        "kernel_launches": launches,
        "sync_or_copy_per_sweep": sync_or_copy_calls(prof) / sweeps,
        "top_kernels_ms": [{"name": k, "count": c, "ms": t / 1e3}
                           for k, (c, t) in top],
        "trace": trace,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("split", "half", "full", "generic",
                                       "all"), default="all")
    ap.add_argument("--sweeps", type=int, default=100)
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_ais: no CUDA device", file=sys.stderr)
        return 1
    import kissabc_tpu_torch as kt

    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    paths = (("split", "half", "full", "generic") if args.path == "all"
             else (args.path,))
    for path in paths:
        print(json.dumps(profile_path(torch, kt, path, args.sweeps,
                                      args.trace_dir)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
