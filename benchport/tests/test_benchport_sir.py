"""The cell ``sir-smc-1m`` (configuration ``sir-cle``, traffic
``smc_scan_solves``): a small run end to end on the CPU with the port's
plain versions (every check against the cell's limits, traced and not),
the control failing a limit where the program passes them all, a run
without a card refused, a run whose cost halves its answers not
correct, the split sweep's spans and the scan's walker-step counter, the
frozen counts of #5; and a small run on a card (marked ``chip``)."""

import json
import math
from pathlib import Path

import pytest
import torch

import control
import jobs
import run

CELL = "sir-smc-1m"
LIMITS = json.loads((Path(__file__).resolve().parents[1] / "limits"
                     / f"{CELL}.json").read_text())
# 1024 walkers to eps 0.15: 20-30 iterations a solve on the CPU
OVER = {"smc": {"nparticles": 1024, "epstol": 0.15}}
TRAFFIC = {"judged_walkers": 256}
SECONDS = 0.2
# the cell's per-layer metrics, by what they read
SPAN_READERS = ("sweep_host_ms_per_iter.split", "scan_host_us_per_call",
                "syncs_per_iter.smc", "sync_wait_ms_per_iter.smc",
                "host_ms_per_iter.smc", "threshold_host_ms_per_iter.smc")
DEVICE_READERS = ("k5_roofline", "idle_share.smc", "launches_per_iter.smc",
                  "step_mfu.smc")


@pytest.mark.parametrize("trace", [False, True])
def test_small_run_is_correct(trace):
    out = run.run(CELL, 2**31 + 7, SECONDS, trace, device=torch.device("cpu"),
                  overrides=OVER, traffic_overrides=TRAFFIC)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and set(out["checks"]) == set(LIMITS)
    assert out["checks"]["exact"]["value"] == 0
    json.dumps(out)
    m = out["metrics"]
    if trace:
        # the span readers read the CPU run too; the device's do not
        for name in SPAN_READERS:
            assert math.isfinite(m[name]["value"]) and m[name]["value"] > 0
        assert not set(m) & set(DEVICE_READERS)
    else:
        assert set(m) == {"solve_s", "setup_s"}


def test_control_fails_and_program_passes():
    lines = control.readings(CELL, [101, 202], torch.device("cpu"),
                             overrides=OVER, traffic=TRAFFIC,
                             stream=open("/dev/null", "w"))
    for line in lines:
        prog, ctl = line["program"], line["control"]
        assert all(prog[k] <= LIMITS[k] for k in LIMITS), prog
        assert any(ctl[k] > LIMITS[k] for k in ctl), ctl


def test_halved_costs_are_not_correct():
    def halved(job):
        cost = job.cost
        job.cost = lambda thetas, gen: cost(thetas, gen) * 0.5

    out = run.run(CELL, 99, SECONDS, False, device=torch.device("cpu"),
                  overrides=OVER, traffic_overrides=TRAFFIC, patch=halved)
    assert not out["correct"], out["checks"]


def test_run_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELL, "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_split_sweep_spans_cover_the_sweep_and_count_walker_steps():
    from kissabc_tpu_torch.utils import logging as L
    kt = __import__("kissabc_tpu_torch")
    cfg, mod = jobs.load_config("sir-cle")
    cfg["smc"] = {**cfg["smc"], **OVER["smc"]}
    job = jobs.make(kt, cfg, mod, jobs.load_traffic("smc_scan_solves"), 7,
                    torch.device("cpu"))
    L.reset_spans()
    with L.tracing():
        res = job.call(3)
    spans = L.spans()
    L.reset_spans()
    by_id = {s["id"]: s for s in spans}

    def secs(ss):
        return sum(s["end_ns"] - s["start_ns"] for s in ss)

    sweeps = [s for s in spans if s["name"] == "smc.sweep"]
    parts = [s for s in spans
             if s["name"] in ("smc.propose", "smc.cost", "smc.accept")]
    assert len(sweeps) == res["iterations"]
    assert all(by_id[s["parent"]]["name"] == "smc.sweep" for s in parts)
    assert secs(parts) >= 0.9 * secs(sweeps)
    calls = [s for s in spans if s["name"] == "scan.cost"]
    # the init's call and one a sweep, each inside ``smc.cost`` but the
    # init's
    assert len(calls) == res["iterations"] + 1
    assert sum(by_id[s["parent"]]["name"] == "smc.cost"
               for s in calls) == res["iterations"]
    for s in calls:
        assert s["counts"]["scan.walker_steps"] == 1024 * cfg["nsteps"]


def test_frozen_scan_counts():
    from metrics import _scan_counts
    cfg, mod = jobs.load_config("sir-cle")
    assert (mod.STEP_OPS, mod.OBSERVE_OPS, mod.INIT_OPS, mod.NSTATS,
            mod.NSTATE, mod.NLEAVES, mod.NSERIES) == (19, 7, 4, 1, 2, 2, 1)
    n = 1 << 20
    # per walker the init (4), per step the noise (27), the step (19),
    # the observation (7) and its sum (1), the mean scaled (1); the two
    # leaves read and the mean written, the series and the seed word
    assert _scan_counts.scan_cost(mod, cfg, n) == (
        n * (4 + 100 * 54 + 1), 4 * n * 3 + 4 * 100 + 8)
    model = mod.model(cfg, mod.make_data(cfg))
    assert len(model.ref_prior) == mod.NLEAVES


@pytest.mark.chip
def test_small_run_on_the_card(cuda_card):
    # 2^18 walkers: the radix select, so the iteration replays as CUDA
    # graphs, as in the cell
    out = run.run(CELL, 12345, SECONDS, True, device=cuda_card,
                  overrides={"smc": {"nparticles": 1 << 18}},
                  traffic_overrides=TRAFFIC)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    for name in SPAN_READERS + DEVICE_READERS:
        assert name in out["metrics"], name
