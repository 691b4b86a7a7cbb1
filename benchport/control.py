#!/usr/bin/env python3
"""The readings that the limits of ``benchport/limits/<workload>.json``
are set from: for each seed, one run of the cell through ``run.run`` at
its own size with a window of one solve (smc cells) or one block of
sweeps after the warm block (AIS cells), whose judged replay feeds two
judges at once: the program's outputs (the lower readings, the run's
``checks``) and the plain reference computed in bfloat16 in the
program's place (the control, the upper readings). One process reads
every seed; the benchmark's own runs never run this.

    python3 benchport/control.py --workload gk-smc-1m --seeds 1 2 3

Prints one JSON line a seed: ``{"seed", "program": {...}, "control":
{...}, "seconds"}``. Needs one CUDA card; the tests call ``readings``
on the CPU at a small size."""

import argparse
import json
import sys
import time

import run

# one timed solve or block, with no warm solve before an smc solve
WINDOW = {"warm_solves": 0, "min_solves": 1, "min_blocks": 1}


def readings(workload, seeds, device, overrides=None, traffic=None,
             stream=sys.stdout):
    out = []
    for seed in seeds:
        t0 = time.time()
        res = run.run(workload, seed, 0.0, False, device=device,
                      overrides=overrides,
                      traffic_overrides={**(traffic or {}), **WINDOW},
                      control=True)
        line = {"seed": seed,
                "program": {k: c["value"] for k, c in res["checks"].items()},
                "control": res["control"], "seconds": time.time() - t0}
        print(json.dumps(line), file=stream, flush=True)
        out.append(line)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    run.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    readings(args.workload, args.seeds, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
