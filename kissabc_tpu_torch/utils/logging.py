"""Observability — the PyTorch counterpart of
``kissabc_tpu/utils/logging.py``:

- ``IterLog`` collects structured per-iteration records of host-stepped
  runs (``smc_stepped(log=...)``);
- ``trace`` profiles a block with ``torch.profiler`` (the CPU, and the
  card when there is one) and writes a Chrome trace into ``logdir``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time

import torch


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile a block: ``with trace(d): smc(...)`` writes
    ``d/trace.json`` (open it in Perfetto or chrome://tracing). Without
    ``logdir`` the trace goes to ``kissabc_trace`` in the temporary
    directory. Yields the directory."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "kissabc_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
