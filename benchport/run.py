#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``kissabc_tpu_torch`` on CUDA.

    python3 benchport/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchport/configs/<config>.json`` and the module it names) and a
traffic mix (``benchport/traffic/<traffic>.json``, whose ``kind`` names
the driver ``benchport/kinds/<kind>.py``). A run builds the port's
kernels for the cell (cached in ``build/`` inside the checkout), warms
the cell's own shapes, then measures for ``--seconds``; with ``--trace
1`` part of the window runs under ``torch.profiler``. After the window
it replays the judged solves or blocks and holds them to the plain
reference (``reference/``), each number against its limit in
``benchport/limits/<workload>.json``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics, each read by
``benchport/metrics/<name>.py``), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each compared number with its
limit, which also close standard error. A run without a CUDA card, or
with fewer cards than the cell asks for, prints no result and exits 2; a
run that finds JAX or the JAX package loaded exits 3.
"""

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kissabc_tpu")
PACKAGE = "kissabc_tpu_torch"


def process_start():
    """The epoch second this process started (Linux), else the import."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``kissabc_tpu_torch`` is not ``kissabc_tpu``)."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def cache_dirs():
    """Every build and kernel cache at a fixed path inside the
    checkout."""
    base = ROOT / "build" / "benchport"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def log(msg):
    print(f"benchport: {time.time() - START:.3f} s: {msg}", file=sys.stderr,
          flush=True)


def cell_of(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"benchport: no workload {name!r} in BENCHMARK.json")


def metric_names(bench, cell, trace):
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if cell["name"] in m.get("workloads", [cell["name"]])]


def read_metric(name, ctx):
    import importlib.util
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchport_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def merge(judged, which=0):
    """The numbers of all judged solves or blocks by their judge
    ``which`` (0: the program's, 1: the control's): the widest of each
    gap, the sum of the exact mismatches, and the notes."""
    nums, notes = {}, []
    for _, js in judged:
        r = js[which].r
        for k, v in r.numbers(exact=which == 0).items():
            nums[k] = nums.get(k, 0) + v if k == "exact" else max(
                nums.get(k, 0.0), v)
        notes += r.notes
    return nums, notes


def run(workload, seed, seconds, trace, *, device, overrides=None,
        traffic_overrides=None, patch=None, control=False):
    """The run after the look for a card: returns the result's dict
    (``None`` where a forbidden module was found). ``overrides`` and
    ``traffic_overrides`` change sizes of the configuration and the
    traffic (the tests' small runs on the CPU); ``patch(job)`` changes
    the job before its set-up (the tests' faults). With ``control`` the
    judged replays also feed the control (the reference in bfloat16 in
    the program's place), whose numbers the result gives under
    ``control`` (``control.py``; the benchmark's own runs never do)."""
    import numpy as np
    import torch

    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    if str(ROOT) not in sys.path:
        sys.path.insert(1, str(ROOT))
    import jobs
    import profiling

    kt = __import__(PACKAGE)
    log(f"{PACKAGE} imported")
    where = Path(kt.__file__).resolve()
    if ROOT not in where.parents:
        raise SystemExit(f"benchport: {PACKAGE} loaded from {where}, not "
                         f"from the checkout {ROOT}")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cell_of(bench, workload)
    cfg, mod = jobs.load_config(cell["config"])
    traffic = {**jobs.load_traffic(cell["traffic"]),
               **(traffic_overrides or {})}
    for key, val in (overrides or {}).items():
        if isinstance(val, dict):
            cfg[key] = {**cfg[key], **val}
        else:
            cfg[key] = val
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    rng = np.random.default_rng(jobs.derive(seed, "judge"))
    job = jobs.make(kt, cfg, mod, traffic, seed, device)
    if patch is not None:
        patch(job)
    log("job built")
    job.setup()
    t_first = time.time()
    log("set up")
    window = job.window(seconds, trace, rng)
    log(f"window closed: {window['attempted']} attempted, each (s): "
        + " ".join(f"{t:.4f}" for t in window["each_s"]))
    if "iterations" in window:
        log("iterations: " + " ".join(map(str, window["iterations"])))
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    summary = host = None
    if job.prof is not None:
        summary, host = profiling.summarize(job.prof, torch)
        job.prof = None
    judged = job.judge(rng, int(traffic["judged_walkers"]),
                       (False, True) if control else (False,))
    log("judged")
    nums, notes = merge(judged)
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    ctx = {"window": window, "trace": summary, "work": None}
    for i, js in judged:
        if i == job.profiled:
            ctx["work"] = job.work(js[0])
            if "iterations" in window:
                ctx["iterations"] = window["iterations"][i]
            else:
                ctx["sweeps"] = job.block
    metrics = {}
    for m in metric_names(bench, cell, trace):
        if m["name"] == "setup_s":
            value = t_first - START
        else:
            value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    out = {"correct": bool(correct), "attempted": window["attempted"],
           "failed": window["failed"], "metrics": metrics, "device": dev}
    if trace and summary is not None:
        out["breakdown"] = profiling.breakdown(summary, host)
    if control:
        out["control"] = merge(judged, 1)[0]
    out["checks"] = checks
    for note in notes:
        print(f"benchport: mismatch: {note}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"benchport: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return None
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return out


START = process_start()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    import torch

    # load from one process with few threads: the host's work is the
    # launches of one Python thread
    torch.set_num_threads(1)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = int(cell_of(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchport: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              device=torch.device("cuda", 0))
    if out is None:
        return 3
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
