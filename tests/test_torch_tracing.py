"""kissabc_tpu_torch's spans and counters (``utils/logging.py``) on the
CPU: the shared null context while nothing records, the counters always
counting, the spans of ``smc``, ``smc_stepped`` and the fused AIS sweep
(one ``smc.solve`` root, one ``smc.iter`` an iteration, every child
inside its parent, one counted read at every read site), tracing turned
on by a recording ``torch.profiler`` and on its clock, and the spans in
``trace``'s ``trace.json``. The JAX package has no spans; its
``tests/test_checkpoint_logging.py`` is mirrored by
``tests/test_torch_checkpoint_logging.py``, which keeps its ``IterLog``
and ``trace`` tests unchanged.
"""

import collections
import json
import os

import pytest
import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch import models
from kissabc_tpu_torch.ops import fused_smc
from kissabc_tpu_torch.utils import logging as L
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh_spans():
    L.reset_spans()
    yield
    L.reset_spans()


def _cost(thetas, gen):
    """A batched cost of the README model: 64 draws a walker."""
    mu, sg = thetas
    x = mu[:, None] + sg[:, None] * torch.randn(mu.shape[0], 64,
                                                generator=gen)
    return torch.hypot(x.mean(1) - 2.0, (x.std(1) - 0.04) * 50)


PRIOR = kt.Factored(kt.Uniform(1, 3), kt.TruncatedNormal(0, 0.05, 0, 100))
KW = dict(nparticles=128, epstol=0.3, cost_vectorized=True,
          quantile_impl="bisect", key=3, device="cpu")


def _moved(before):
    after = L.counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _check_tree(spans):
    """Every child inside its parent, on one root."""
    by_id = {s["id"]: s for s in spans}
    roots = [s for s in spans if s["parent"] is None]
    assert len(roots) == 1
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        assert s["root"] == roots[0]["id"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"], (p["name"], s["name"])
    return roots[0]


def test_span_off_is_the_shared_null_context_and_counters_count():
    assert L.span("smc.iter") is L.span("x", a=1) is L._NULL
    before = L.counts()
    with L.span("smc.iter") as rec:
        assert rec is None
        assert L.host_read("probe", float, torch.tensor(2.5)) == 2.5
        fused_smc.launches["fused_smc_sweep"] += 1
    assert L.spans() == []
    assert _moved(before) == {"host_syncs": 1,
                              "launches.fused_smc_sweep": 1}


def test_launch_dicts_are_registered_as_the_same_objects():
    fused_smc.launches["fused_smc_sweep"] += 3
    assert L.counts()["launches.fused_smc_sweep"] == \
        fused_smc.launches["fused_smc_sweep"]
    fused_smc.reset_launch_counts()
    assert L.counts()["launches.fused_smc_sweep"] == 0
    assert {"launches.streaming_moment_cost", "launches.fused_ais_sweep",
            "transfers.permute", "mesh_reads.shifts", "host_syncs",
            "host_copies"} <= set(L.counts())


def test_span_records_its_tree_and_counter_moves():
    with L.tracing():
        with L.span("outer", size=4) as outer:
            with L.span("inner"):
                fused_smc.launches["fused_smc_sweep"] += 2
            L.host_read("probe", int, torch.tensor(7))
    spans = L.spans()
    assert [s["name"] for s in spans] == ["outer", "inner", "sync"]
    root = _check_tree(spans)
    assert root is outer and outer["attrs"] == {"size": 4}
    assert outer["counts"] == {"launches.fused_smc_sweep": 2,
                               "host_syncs": 1}
    assert spans[1]["counts"] == {"launches.fused_smc_sweep": 2}
    assert spans[2]["attrs"] == {"site": "probe"}
    assert L.span("after") is L._NULL


def test_device_scalar_counts_a_copy_off_the_cpu_only():
    before = L.counts()
    with L.tracing():
        x = L.device_scalar("probe", float("inf"), torch.float32, "cpu")
        m = L.device_scalar("probe", 0, torch.int64, "meta")
    assert x.item() == float("inf") and m.device.type == "meta"
    assert _moved(before) == {"host_copies": 1}
    assert [s["name"] for s in L.spans()] == ["sync"]


def test_spans_beyond_the_bound_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(L, "MAX_SPANS", 3)
    with L.tracing():
        for _ in range(5):
            with L.span("x"):
                pass
    assert len(L.spans()) == 3 and L.dropped() == 2
    L.reset_spans()
    assert L.spans() == [] and L.dropped() == 0


def _smc_reads(res, nleaves):
    """The reads ``smc`` takes: the stop test at each iteration and once
    more, the resample flag at each iteration; the result's stop flag,
    alive mask, leaves, costs, eps, iteration count and evidence."""
    return 2 * res.iterations + 1 + 6 + nleaves


def test_smc_spans():
    before = L.counts()
    with L.tracing():
        res = kt.smc(PRIOR, _cost, **KW)
    moved = _moved(before)
    spans = L.spans()
    root = _check_tree(spans)
    names = collections.Counter(s["name"] for s in spans)
    assert root["name"] == "smc.solve"
    assert res.iterations > 3
    assert names["smc.iter"] == names["smc.threshold"] == \
        names["smc.resample"] == names["smc.sweep"] == res.iterations
    assert names["smc.cond"] == res.iterations + 1
    assert names["smc.init"] == names["smc.result"] == 1
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        parent = by_id.get(s["parent"], {}).get("name")
        if s["name"] in ("smc.threshold", "smc.resample", "smc.sweep"):
            assert parent == "smc.iter"
        elif s["name"] in ("smc.init", "smc.iter", "smc.cond",
                           "smc.result"):
            assert parent == "smc.solve"
    # one counted read at every read site, nothing copied on the CPU
    assert moved.get("host_copies", 0) == 0
    assert moved["host_syncs"] == _smc_reads(res, 2) == \
        root["counts"]["host_syncs"] == names["sync"]
    sites = collections.Counter(s["attrs"]["site"] for s in spans
                                if s["name"] == "sync")
    assert sites == {"cond": res.iterations + 1,
                     "resample flag": res.iterations, "result": 4,
                     "fetch": 4}


def test_smc_stepped_spans(tmp_path):
    log = kt.IterLog(enabled=False)
    before = L.counts()
    with L.tracing():
        res = kt.smc_stepped(PRIOR, _cost, log=log,
                             checkpoint_path=str(tmp_path / "c.npz"),
                             checkpoint_every=2, **KW)
    moved = _moved(before)
    spans = L.spans()
    root = _check_tree(spans)
    names = collections.Counter(s["name"] for s in spans)
    assert root["name"] == "smc.solve"
    assert names["smc.iter"] == res.iterations == len(log.records)
    # the stepped loop's four reads an iteration, and at each checkpoint
    # one a tensor of the loop state: two leaves, the costs, log-priors,
    # alive mask, eps, evidence, iteration, accept count and stop flag
    saves = res.iterations // 2
    assert moved["host_syncs"] == _smc_reads(res, 2) \
        + 4 * res.iterations + 10 * saves
    assert moved.get("host_copies", 0) == 0
    assert res.eps == kt.smc(PRIOR, _cost, **KW).eps


def test_smc_sweep_spans_by_retry_round():
    with L.tracing(), pytest.warns(RuntimeWarning, match="max_iters"):
        kt.smc(PRIOR, _cost, mcmc_retrys=2, mcmc_tol=0.9,
               **{**KW, "max_iters": 3, "epstol": 0.0})
    spans = L.spans()
    rounds = [s["attrs"]["round"] for s in spans if s["name"] == "smc.sweep"]
    assert rounds[:3] == [0, 1, 2]
    retry = [s for s in spans if s["name"] == "sync"
             and s["attrs"]["site"] == "retry flag"]
    assert len(retry) == rounds.count(1) + rounds.count(2)


def test_fused_ais_sweep_spans():
    prior, draw, reduce_cost = models.flagship()
    n = 64
    for halves in (False, True):
        sw = kt.make_fused_ais_sweep(prior, draw, reduce_cost, scale=0.5,
                                     ndraws=16, block=128, chunk=128,
                                     walker_tiles=2, halves=halves)
        gen = torch.Generator().manual_seed(5)
        th = prior.sample_tree(gen, n)
        ld = (prior.logpdf_tree(th).float(), torch.full((n,), -5.0))
        if halves:
            th = (tuple(x[:n // 2] for x in th), tuple(x[n // 2:]
                                                       for x in th))
            ld = ((ld[0][:n // 2], ld[1][:n // 2]),
                  (ld[0][n // 2:], ld[1][n // 2:]))
        L.reset_spans()
        with L.tracing():
            for _ in range(3):
                th, ld = sw(gen, th, ld)
        spans = L.spans()
        assert [s["name"] for s in spans] == ["ais.sweep", "ais.half",
                                              "ais.half"] * 3
        for k in range(3):
            _check_tree(spans[3 * k:3 * k + 3])


def test_a_recording_profiler_turns_spans_on_and_shares_its_clock():
    a = torch.randn(96, 96)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with L.span("probe"):
            a @ a
    assert L.span("probe") is L._NULL
    (probe,) = L.profiler_spans(prof)
    mm = [e for e in prof.events() if e.name == "aten::mm"]
    assert mm
    for e in mm:
        assert probe["start_us"] <= e.time_range.start
        assert e.time_range.end <= probe["end_us"]


def test_trace_json_holds_the_spans(tmp_path):
    logdir = str(tmp_path / "trace")
    with kt.trace(logdir):
        res = kt.smc(PRIOR, _cost, **KW)
    with open(os.path.join(logdir, "trace.json")) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    names = collections.Counter(e["name"] for e in spans)
    assert names["smc.solve"] == 1 and names["smc.iter"] == res.iterations
    (solve,) = [e for e in spans if e["name"] == "smc.solve"]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"] == "aten::sum"]
    assert ops
    # the spans are on the trace's clock: the solve holds its operations
    assert all(solve["ts"] <= e["ts"] and e["ts"] + e["dur"]
               <= solve["ts"] + solve["dur"] for e in ops)
    assert solve["args"]["host_syncs"] == _smc_reads(res, 2)
