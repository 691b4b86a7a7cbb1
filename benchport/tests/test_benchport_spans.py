"""The program's spans and sync counters as the benchmark reads them.

On the CPU: a small traced run of each cell reports the metrics read
from the program's spans (``program_span``, ``program_counter``).

On a card (marked ``chip``):

- an smc solve at 2^16 walkers through the bisection quantile and the
  fused sweep (#3), under ``torch.cuda.set_sync_debug_mode("warn")``,
  warns once for each read and copy that the program counted, and a
  block of fused AIS sweeps (#6) neither warns nor counts;
- each #3 and #6 launch starts on the card after the start of its
  ``smc.sweep`` or ``ais.half`` span, on the profiler's clock;
- spans add no device operation: a profiled solve and block count the
  same device operations with the recorder on as with it stubbed, each
  profiled in a process of its own (``profile_once.py``: later profiler
  sessions in one process record fewer of the same operations).
"""

import collections
import json
import math
import subprocess
import sys
import traceback
import warnings
from pathlib import Path

import pytest
import torch

import jobs
import run
from small import SECONDS, SMALL, TRACED

SPAN_METRICS = {
    "gk-smc-1m": ["syncs_per_iter.smc", "sync_wait_ms_per_iter.smc",
                  "host_ms_per_iter.smc", "threshold_host_ms_per_iter.smc"],
    "normal-ais-131k": ["host_us_per_sweep.ais"],
}


def _logging():
    from kissabc_tpu_torch.utils import logging
    return logging


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
def test_small_traced_run_reports_the_span_metrics(workload):
    _logging().reset_spans()
    over, traffic = TRACED.get(workload, SMALL[workload])
    out = run.run(workload, 2**31 + 11, SECONDS, True,
                  device=torch.device("cpu"), overrides=over,
                  traffic_overrides=traffic)
    for name in SPAN_METRICS[workload]:
        value = out["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    if workload == "gk-smc-1m":
        # on the CPU nothing is copied: two reads an iteration (the stop
        # test and the resample flag), the last stop test and the
        # result's reads, none inside the threshold
        m = out["metrics"]
        assert m["syncs_per_iter.smc"]["value"] > 2
        assert m["threshold_host_ms_per_iter.smc"]["value"] < \
            m["host_ms_per_iter.smc"]["value"]


def _smc_job(device, n=1 << 16):
    kt = __import__("kissabc_tpu_torch")
    cfg, mod = jobs.load_config("gk-ecdf")
    cfg["smc"] = {**cfg["smc"], "nparticles": n}
    return jobs.make(kt, cfg, mod, jobs.load_traffic("smc_solves"), 7,
                     device)


def _solve(job, key):
    s = job.cfg["smc"]
    return job.kt.smc(
        job.prior, job.cost, nparticles=s["nparticles"], alpha=s["alpha"],
        mcmc_retrys=s["mcmc_retrys"], mcmc_tol=s["mcmc_tol"],
        epstol=s["epstol"], min_r_ess=s["min_r_ess"],
        max_stretch=s["max_stretch"], max_iters=s["max_iters"],
        resample=s["resample"], cost_vectorized=True,
        sweep_fused=job.sweep, quantile_impl="bisect", key=key,
        device=job.device)


def _ais_job(device, sweeps):
    kt = __import__("kissabc_tpu_torch")
    cfg, mod = jobs.load_config("normal-readme")
    traffic = {**jobs.load_traffic("ais_sweeps"), "block_sweeps": sweeps}
    job = jobs.make(kt, cfg, mod, traffic, 7, device)
    job.setup()
    return job


def _synced(fn):
    """``fn()`` under the sync debug mode: (its result, the change of
    every counter, the sync warnings by the stack that made them)."""
    L = _logging()
    stacks = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            frames = traceback.extract_stack()[:-2]
            stacks.append("".join(traceback.format_list(frames[-12:])))

    torch.cuda.synchronize()
    before = L.counts()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        stacks.clear()   # the switch itself may warn
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    after = L.counts()
    return (out, {k: after[k] - before[k] for k in after},
            collections.Counter(stacks))


@pytest.mark.chip
def test_sync_warnings_equal_the_counted_syncs(cuda_card):
    job = _smc_job(cuda_card)
    _solve(job, 1)   # builds and loads the kernels
    res, moved, places = _synced(lambda: _solve(job, 2))
    counted = moved["host_syncs"] + moved["host_copies"]
    uncounted = {k: v for k, v in places.items()
                 if "in host_read" not in k and "in device_scalar" not in k}
    for k, v in uncounted.items():
        print(f"uncounted sync, {v} time(s):\n{k}")
    assert sum(places.values()) == counted, (counted, moved)
    # an iteration reads the resample flag and the stop test and copies
    # the bisection's two constants; a solve also reads the last stop test
    # and ten values of the result (four leaves), and copies five scalars
    # in the init
    assert moved["host_syncs"] == 2 * res.iterations + 1 + 10
    assert moved["host_copies"] == 2 * res.iterations + 5
    ais = _ais_job(cuda_card, 20)
    _, moved, places = _synced(ais.run_block)
    assert not places and moved["host_syncs"] == moved["host_copies"] == 0


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    L = _logging()
    L.reset_spans()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = sorted((e.time_range.start, e.name) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return dev, L.profiler_spans(prof)


def _after_their_spans(kernels, starts):
    """Each kernel's device start after the start of its span: the i-th
    kernel the trace holds (it may miss some of the first) starts after
    at least i + 1 of the spans, on the profiler's clock."""
    starts = sorted(starts)
    assert 0 < len(kernels) <= len(starts)
    for i, k in enumerate(kernels):
        assert sum(s <= k for s in starts) >= i + 1, (i, k, starts[i])


@pytest.mark.chip
def test_kernels_start_after_their_spans(cuda_card):
    job = _smc_job(cuda_card)
    _solve(job, 1)
    dev, spans = _profiled(lambda: _solve(job, 3))
    _after_their_spans(
        [t for t, name in dev if "fused_smc_sweep_kernel" in name],
        [s["start_us"] for s in spans if s["name"] == "smc.sweep"])
    ais = _ais_job(cuda_card, 20)
    dev, spans = _profiled(ais.run_block)
    _after_their_spans(
        [t for t, name in dev if "fused_ais_sweep_kernel" in name],
        [s["start_us"] for s in spans if s["name"] == "ais.half"])


def _ops_in_a_process(kind, recorder):
    out = subprocess.run(
        [sys.executable, str(Path(__file__).with_name("profile_once.py")),
         kind, recorder], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.chip
@pytest.mark.parametrize("kind", ["smc", "ais"])
def test_spans_add_no_device_operation(cuda_card, kind):
    on = _ops_in_a_process(kind, "on")
    off = _ops_in_a_process(kind, "off")
    assert on["spans"] > 0 and off["spans"] == 0
    assert not any("annotation" in n for n in on["ops"])
    assert on["ops"] == off["ops"]
