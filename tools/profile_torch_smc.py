#!/usr/bin/env python3
"""Where the time of kissabc_tpu_torch's ``smc`` goes on one CUDA card.

    python3 tools/profile_torch_smc.py [--trace-dir DIR]

Runs ``smc`` on the flagship README model at 1000 and at 2**20
particles: once warm without the profiler for the wall time, then once
under ``torch.profiler``. For each run it prints one JSON line with the
wall time, the iterations, the device busy time (the union of all CUDA
kernel and copy intervals), the device idle share of the profiled
window, the sync and copy calls, and the CUDA kernels that took the
most device time. With ``--trace-dir`` a Chrome trace of each profiled
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


def profile_run(torch, kt, nparticles, trace_dir, **kw):
    from torch.profiler import ProfilerActivity, profile

    prior = kt.Factored(kt.Uniform(1, 3), kt.TruncatedNormal(0, 0.05, 0, 100))
    cost = kt.make_flagship_cost_batched()

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = kt.smc(prior, cost, cost_vectorized=True,
                     nparticles=nparticles, epstol=0.011113, max_iters=2000,
                     key=2, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    run()  # warm: kernel build, allocator, lazy CUDA init
    res, wall = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_prof = run()
    trace = None
    if trace_dir:
        trace = os.path.join(trace_dir, f"smc_{nparticles}.json")
        prof.export_chrome_trace(trace)

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
    syncs = sum(e.count for e in prof.key_averages()
                if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                             "cudaMemcpyAsync"))
    return {
        "nparticles": nparticles, "iterations": res.iterations,
        "eps": res.eps, "wall_s": wall, "wall_profiled_s": wall_prof,
        "device_busy_s": busy if dev_events else None,
        "device_idle_share": (1 - busy / wall_prof) if dev_events else None,
        "cuda_events": len(dev_events), "sync_or_copy_calls": syncs,
        "top_kernels_ms": [{"name": k, "count": c, "ms": t / 1e3}
                           for k, (c, t) in top],
        "trace": trace,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    for n, kw in ((1000, {}), (1 << 20, {"min_r_ess": 0.5})):
        print(json.dumps(profile_run(torch, kt, n, args.trace_dir, **kw)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
