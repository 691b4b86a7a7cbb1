"""One profiled smc solve (gk-ecdf at 2^16 walkers, #4 and #3) or block
of 20 fused AIS sweeps (normal-readme at 131072, #6) on the card, in a
process of its own, with the program's span recorder on or stubbed.

    python3 benchport/tests/profile_once.py smc|ais on|off

The last line of standard output is JSON: ``ops``, the device
operations of the profiled span by name and count, and ``spans``, the
spans the program recorded there."""

import collections
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402

import jobs  # noqa: E402


def main(kind, recorder):
    from torch.profiler import ProfilerActivity, profile
    kt = __import__("kissabc_tpu_torch")
    from kissabc_tpu_torch.utils import logging
    dev = torch.device("cuda", 0)
    if kind == "smc":
        cfg, mod = jobs.load_config("gk-ecdf")
        cfg["smc"] = {**cfg["smc"], "nparticles": 1 << 16}
        job = jobs.make(kt, cfg, mod, jobs.load_traffic("smc_solves"), 7,
                        dev)
        job.call(1)

        def work():
            job.call(2)
    else:
        cfg, mod = jobs.load_config("normal-readme")
        traffic = {**jobs.load_traffic("ais_sweeps"), "block_sweeps": 20}
        job = jobs.make(kt, cfg, mod, traffic, 7, dev)
        job.setup()
        work = job.run_block
    if recorder == "off":
        logging._profiler = type("Off", (), {"_is_profiler_enabled": False})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        work()
        torch.cuda.synchronize()
    ops = collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    print(json.dumps({"ops": dict(sorted(ops.items())),
                      "spans": len(logging.spans())}))


if __name__ == "__main__":
    main(*sys.argv[1:3])
