"""Observability — the PyTorch counterpart of
``kissabc_tpu/utils/logging.py``:

- ``IterLog`` collects structured per-iteration records of host-stepped
  runs (``smc_stepped(log=...)``);
- ``trace`` profiles a block with ``torch.profiler`` (the CPU, and the
  card when there is one) and writes a Chrome trace into ``logdir``,
  with the block's program spans as a host track beside the operations;
- ``span`` marks a phase of the program (the smc loop's init,
  iterations, threshold, resampling, sweeps, stop test and result; the
  fused AIS sweep and its halves). Spans are recorded inside ``with
  tracing():``, inside ``trace``, and whenever a ``torch.profiler`` is
  recording; ``spans()`` returns them, ``profiler_spans(prof)`` on a
  profiler's own time base;
- the counters: every kernel's launches (the ``launches`` dicts of
  ``ops/``, registered here as the same objects), the mesh's transfers,
  and ``host_syncs`` (reads of a tensor's value into Python, each a wait
  for the card on CUDA), ``host_copies`` (blocking host-to-device
  copies) and ``graph_replays`` (replays of a CUDA graph of the smc
  iteration, ``utils/graphs.py`` ``_Captured``). They always count;
  ``counts()`` reads them all, and each span records how much each
  counter moved inside it.

A span is a dict: ``name``, ``id``, ``parent`` (the id of the innermost
span open at its start, or None), ``root`` (the id of its outermost
one), ``start_ns``/``end_ns`` (``time.time_ns()``, the clock that
``torch.profiler`` stamps its events with), ``attrs`` (the keywords
given to ``span``) and ``counts`` (the counters that moved inside it, by
how much). A ``sync`` span wraps each counted read or copy: its time is
the host waiting for the card.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time

import torch
# its ``_is_profiler_enabled`` is torch's own flag (a plain bool) for "a
# profiler is recording"
import torch.autograd.profiler as _profiler

# the spans kept in memory, at most MAX_SPANS of them; later ones are
# counted in ``dropped`` and not kept
MAX_SPANS = 200_000
_spans: list[dict] = []
_stack: list[dict] = []
_state = {"tracing": 0, "next_id": 0, "dropped": 0}

# blocking reads and copies between the host and the device, and replays
# of the smc iteration's CUDA graphs, since the process started (plain
# ints, always counted)
counters = {"host_syncs": 0, "host_copies": 0, "graph_replays": 0}
# every registered counter: its name, its dict and its key there (flat,
# so that a span reads them all in one pass)
_names: list[str] = []
_dicts: list[dict] = []
_keys: list[str] = []


def register_counters(prefix: str, group: dict) -> dict:
    """Register a dict of plain int counters (a module's ``launches``)
    under ``prefix``; returns the same dict, which its module keeps
    updating and resetting."""
    for k in group:
        _names.append(prefix + k)
        _dicts.append(group)
        _keys.append(k)
    return group


register_counters("", counters)


def _values():
    return [*map(dict.__getitem__, _dicts, _keys)]


def counts() -> dict:
    """Every registered counter now, by ``prefix + name``."""
    return dict(zip(_names, _values()))


def add_counts(delta: dict) -> None:
    """Add ``delta`` (by ``prefix + name``, as ``counts()`` names them) to
    the registered counters: what a replayed CUDA graph launches without
    running the Python that counts it."""
    for name, group, key in zip(_names, _dicts, _keys):
        if name in delta:
            group[key] += delta[name]


class _Null:
    """The context of a span while nothing is recorded."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, kind, value, tb):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("rec", "before")

    def __init__(self, name, attrs):
        self.rec = {"name": name, "id": 0, "parent": None, "root": 0,
                    "start_ns": 0, "end_ns": None, "attrs": attrs,
                    "counts": {}}

    def __enter__(self):
        rec = self.rec
        _state["next_id"] += 1
        rec["id"] = _state["next_id"]
        if _stack:
            rec["parent"], rec["root"] = _stack[-1]["id"], _stack[-1]["root"]
        else:
            rec["root"] = rec["id"]
        if len(_spans) < MAX_SPANS:
            _spans.append(rec)
        else:
            _state["dropped"] += 1
        _stack.append(rec)
        self.before = _values()
        rec["start_ns"] = time.time_ns()
        return rec

    def __exit__(self, kind, value, tb):
        rec = self.rec
        rec["end_ns"] = time.time_ns()
        after = _values()
        if after != self.before:
            rec["counts"] = {k: b - a for k, a, b in
                             zip(_names, self.before, after) if b != a}
        _stack.pop()
        return False


def span(name: str, **attrs):
    """The context of one phase of the program: ``with span("smc.iter"):
    ...``. While nothing records it is one shared context that does
    nothing (no clock read, no record, no tensor touched)."""
    if not (_state["tracing"] or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, attrs)


@contextlib.contextmanager
def tracing():
    """Record spans inside the block (nested blocks are fine)."""
    _state["tracing"] += 1
    try:
        yield
    finally:
        _state["tracing"] -= 1


def spans() -> list[dict]:
    """The spans recorded since the last ``reset_spans``, in the order
    they started; spans still open are left out."""
    return [s for s in _spans if s["end_ns"] is not None]


def dropped() -> int:
    """The spans not kept since the last ``reset_spans`` (beyond
    ``MAX_SPANS``)."""
    return _state["dropped"]


def reset_spans() -> None:
    """Forget the recorded spans (open ones stay open)."""
    _spans.clear()
    _state["dropped"] = 0


def host_read(site: str, read, x):
    """``read(x)`` (``float``, ``bool``, ``torch.Tensor.tolist``, ...):
    a read of a tensor's value into Python, which on CUDA waits for the
    card to finish it. Counted in ``host_syncs``, inside a ``sync``
    span named by ``site``."""
    counters["host_syncs"] += 1
    with span("sync", site=site):
        return read(x)


def device_scalar(site: str, value, dtype, device):
    """``torch.tensor(value, dtype=dtype, device=device)``. Made on a
    device that is not the CPU, it is a host-to-device copy that waits
    for the copy to finish: counted in ``host_copies``, inside a
    ``sync`` span named by ``site``."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.tensor(value, dtype=dtype, device=device)
    counters["host_copies"] += 1
    with span("sync", site=site):
        return torch.tensor(value, dtype=dtype, device=device)


def profiler_spans(prof) -> list[dict]:
    """``spans()`` with ``start_us``/``end_us`` on the time base of the
    ``torch.profiler`` run ``prof``: microseconds after its trace's
    start, as its events' ``time_range`` has them."""
    base = prof.profiler.kineto_results.trace_start_ns()
    return [{**s, "start_us": (s["start_ns"] - base) / 1e3,
             "end_us": (s["end_ns"] - base) / 1e3} for s in spans()]


def _chrome_events(recorded, base_ns):
    """The spans as Chrome trace events ("X", microseconds after
    ``base_ns``) on a track of their own in this process (thread id 0,
    named ``program spans``), each with its attributes and counts as
    ``args``."""
    pid = os.getpid()
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
            "args": {"name": "program spans"}}]
    for s in recorded:
        out.append({"ph": "X", "cat": "program_span", "name": s["name"],
                    "pid": pid, "tid": 0,
                    "ts": (s["start_ns"] - base_ns) / 1e3,
                    "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                    "args": {"id": s["id"], "parent": s["parent"],
                             **s["attrs"], **s["counts"]}})
    return out


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile a block: ``with trace(d): smc(...)`` writes
    ``d/trace.json`` (open it in Perfetto or chrome://tracing), with the
    block's program spans as a track of their own on the trace's clock.
    Without ``logdir`` the trace goes to ``kissabc_trace`` in the
    temporary directory. Yields the directory."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "kissabc_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    first = _state["next_id"]
    with tracing(), torch.profiler.profile(activities=activities) as prof:
        yield logdir
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    # the exported events' ts are microseconds after baseTimeNanoseconds
    base = int(doc.get("baseTimeNanoseconds", 0))
    doc["traceEvents"] += _chrome_events(
        [s for s in spans() if s["id"] > first], base)
    with open(path, "w") as f:
        json.dump(doc, f)


class IterLog:
    """Structured iteration log: ``log.emit(iteration=3, eps=0.5)``;
    lines are JSON on stderr plus kept in memory for tests."""

    def __init__(self, stream=None, enabled: bool = True):
        self.stream = stream if stream is not None else sys.stderr
        self.enabled = enabled
        self.records: list[dict] = []
        self._t0 = time.perf_counter()

    def emit(self, **fields):
        rec = {"t": round(time.perf_counter() - self._t0, 4), **fields}
        self.records.append(rec)
        if self.enabled:
            print(json.dumps(rec), file=self.stream, flush=True)
        return rec
