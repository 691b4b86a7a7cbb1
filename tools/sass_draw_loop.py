#!/usr/bin/env python3
"""SASS instructions per draw of the draw loops of kissabc_tpu_torch's
CUDA kernels, and the issue floor they set.

    python3 tools/sass_draw_loop.py [--repo DIR] [--out DIR]

Builds (with the checkout at ``--repo``, default this one) the
hand-written library (``csrc/flagship.cu`` + ``csrc/ais.cu``) and the
generated units of the flagship model for the fused smc sweep (with the
streaming cost), the generic AIS sweep and the ABC-DE generation, and the
scan kernel's units of AR(1) and SIR (whose loops count per step: an
angle gives the noise of two steps), runs
``cuobjdump -sass`` on each, writes the listings to ``--out``, and prints
one JSON line per kernel with a draw loop: each innermost loop's
instructions, its Box-Muller angles (two draws each), instructions per
draw, its commonest opcodes, and the issue floor of 1000 draws for 2**20
walkers at the card's maximum SM clock (``kissabc_tpu_torch/ops/sass.py``),
and, for the compacting kernels (#6, #10, whose template arguments
<stub, lanes> are parsed from the name, and #7, #8), the floor for the
walkers they simulate at their production widths (#2 at 131072 from the
prior, the scan kernel at 131072 x 1000 steps, the cost kernel #4, in the
sweep's unit with its <stub, lanes>, at 16384 and 1000 walkers; ``--sim``;
the loop's count is per draw per lane, so the floor counts every lane's
share), and the tempered sweep #9's kernel (no draw loop: every
instruction once a walker, a sweep of 131072 walkers).
Then, on the card, it runs kernel #1 (``normal_summary_cost``, 2**20
walkers x 1000 Philox draws) back to back for about two seconds while
``nvidia-smi`` samples the SM clock every 50 ms, and prints the kernel's
milliseconds by CUDA events and the median clock under that load. The
last line names the card and its power limit. Needs nvcc, cuobjdump and
one card. Imports nothing of JAX.
"""

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

# the walkers the compacting kernels simulate at their production widths
# on the H100: #10 at 16384 and 131072 walkers of an ABCDE generation
# (tools/time_geometry.py), #6, #7 and #8 over one sweep of 131072 from the
# prior (chip_smoke.py ais-kernel-times; #7's and #8's loops are in the
# hand-written library)
SIMULATED = ["abcde:16384:5318", "abcde:131072:42876", "ais:131072:77645",
             "flagship:ais7:77996", "flagship:ais8:77883",
             "flagship:sweep2:58068", "scan ar1:131072:131072",
             "scan sir:131072:131072", "sweep:cost16384:16384",
             "sweep:cost1000:1000"]


def smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else ""


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=here)
    ap.add_argument("--out", default=os.path.join(here, "chiprun_out",
                                                  "sass"))
    ap.add_argument("--sim", action="append", default=None,
                    help="LIB:LABEL:WALKERS, an issue floor of LIB's loops "
                    "for that many simulated walkers x 1000 draws")
    args = ap.parse_args()
    if args.sim is None:
        args.sim = SIMULATED
    sys.path.insert(0, os.path.abspath(args.repo))
    import kissabc_tpu_torch as kt
    from kissabc_tpu_torch import models
    from kissabc_tpu_torch.ops import _build

    # the reader of this checkout, whatever the checkout built
    spec = importlib.util.spec_from_file_location(
        "sass", os.path.join(here, "kissabc_tpu_torch", "ops", "sass.py"))
    sass = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sass)

    prior, draw, reduce_cost = models.flagship()
    units = {
        "sweep": kt.make_fused_smc_sweep(prior, draw, reduce_cost).unit,
        "ais": kt.make_fused_ais_sweep(prior, draw, reduce_cost,
                                      scale=0.005).unit,
        "abcde": kt.make_fused_abcde_generation(
            prior, draw, reduce_cost, gamma=1.19).unit}
    # the scan kernel's units: AR(1) (bench.py's streaming-scan) and SIR
    # with a series; a step loop's count is per step (each Box-Muller
    # angle gives the noise of two steps)
    _, astep, ainit, areduce = models.ar1()
    _, sstep, sinit, sobs, sreduce, series = models.sir()
    units["scan ar1"] = kt.make_streaming_scan_cost(
        astep, ainit, areduce, nsteps=1000).unit(2)
    units["scan sir"] = kt.make_streaming_scan_cost(
        sstep, sinit, sreduce, observe=sobs, series=series,
        nsteps=len(series)).unit(2)
    # the tempered sweep #9 (conjugate model): no draw loop, one pass a
    # walker, so its floor counts every instruction once a walker
    cprior, ll_elem, _, _ = models.conjugate_normal()
    units["tempered"] = kt.make_fused_tempered_sweep(cprior, ll_elem).unit
    jobs = {"flagship": _build.start()}
    jobs.update({k: _build.start(u.source) for k, u in units.items()})
    clock = float(smi("clocks.max.sm") or "nan")
    sims = {}   # lib -> {label: simulated walkers}
    for item in args.sim:
        lib, label, count = item.split(":")
        sims.setdefault(lib, {})[label] = int(count)
    os.makedirs(args.out, exist_ok=True)
    for name, job in jobs.items():
        lib = job.wait()[0]
        text = sass.disassemble(lib)
        with open(os.path.join(args.out, f"{name.replace(' ', '_')}.sass"),
                  "w") as f:
            f.write(text)
        for fn, instrs in sorted(sass.functions(text).items()):
            found = sass.draw_loops(instrs)
            if name == "tempered":   # a sweep of 131072: 2 x 65536 walkers
                print(json.dumps(dict(
                    lib=name, kernel=fn, instructions=len(instrs),
                    floor_ms_sweep_131072=sass.issue_floor_ms(
                        len(instrs), 1, 131072, clock))), flush=True)
                continue
            if not found:
                continue
            for loop in found:
                loop["floor_ms_2p20x1000"] = sass.issue_floor_ms(
                    loop["per_draw"], 1000, 1 << 20, clock)
                for label, count in sims.get(name, {}).items():
                    loop[f"floor_ms_{label}"] = sass.issue_floor_ms(
                        loop["per_draw"], 1000, count, clock)
            # the lane-group kernels' template arguments: <stub, lanes>
            m = re.search(r"ILb([01])ELi(\d+)EE", fn)
            extra = dict(stub=m.group(1) == "1", lanes=int(m.group(2))) \
                if m else {}
            print(json.dumps(dict(lib=name, kernel=fn,
                                  instructions=len(instrs), **extra,
                                  loops=found)), flush=True)
    print(json.dumps(dict(load=clock_under_load())), flush=True)
    print(json.dumps(dict(card=smi("name,power.limit"),
                          max_sm_clock_mhz=clock, repo=args.repo)))


def clock_under_load(seconds=2.0):
    """Kernel #1 at 2**20 x 1000 draws: its milliseconds by CUDA events,
    and the SM clocks nvidia-smi reads while it runs back to back."""
    import torch
    from kissabc_tpu_torch.ops import kernels as K

    n = 1 << 20
    gen = torch.Generator(device="cuda").manual_seed(0)
    mu = torch.rand(n, generator=gen, device="cuda") * 2 + 1
    sg = torch.rand(n, generator=gen, device="cuda") * 0.1
    seed = torch.tensor([11], dtype=torch.int64, device="cuda")
    for _ in range(3):
        K.normal_summary_cost(mu, sg, seed)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "50"], stdout=subprocess.PIPE, text=True)
    try:
        reps, t0 = 0, time.perf_counter()
        start.record()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                K.normal_summary_cost(mu, sg, seed)
            reps += 20
            torch.cuda.synchronize()
        end.record()
        torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    clocks = sorted(float(v) for v in out.split() if v.isdigit())
    return dict(kernel="normal_summary_cost", n=n, ndraws=1000,
                ms=start.elapsed_time(end) / reps, reps=reps,
                sm_clock_mhz_median=clocks[len(clocks) // 2] if clocks
                else None, sm_clock_mhz_samples=len(clocks),
                sm_clock_mhz_min=clocks[0] if clocks else None)


if __name__ == "__main__":
    main()
