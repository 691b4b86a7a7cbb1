"""The load generator: what every kind of job shares, and the look-up of
a kind by name. A traffic file (``traffic/<name>.json``) names its
``kind``; the kind is ``kinds/<kind>.py``, whose ``Kind`` drives the
configuration's model with the traffic's parameters and judges it
against the plain reference after the window. A later mix of a known
kind is a new data file; a new kind is a new file beside the others.

A job takes the measured package (``kt``) as an argument and imports
nothing of it; the configuration's module gives the model and its
prior on both sides, the reference package the judges.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def derive(seed, *tags):
    """A 63-bit key from the run's seed and ``tags``."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_config(name):
    """(sizes, module) of a configuration: ``configs/<name>.json`` and the
    module it names beside it."""
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    mod = _load(HERE / "configs" / cfg["module"],
                "benchport_config_" + name.replace("-", "_"))
    return cfg, mod


def load_traffic(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def model_kwargs(cfg, model):
    kw = dict(ndraws=int(cfg["ndraws"]), noise=cfg["noise"],
              chunk=int(cfg["chunk"]))
    if model.stats is not None:
        kw["stats"] = model.stats
    else:
        kw["nmoments"] = model.nmoments
    return kw


def leaves(tree):
    return list(tree) if isinstance(tree, (tuple, list)) else [tree]


def clone(xs):
    return [x.clone() for x in xs]


class Job:
    """What the kinds share: the model, the prior, the profiler hook.

    A kind sets ``setup()``, ``window(seconds, trace, rng)`` (the
    window's record: ``window_s``, ``attempted``, ``failed``, ``each_s``
    and what its metrics read), ``judge(rng, walkers, controls)`` (a
    list of ``(index, judges)``, one judge a flag of ``controls``: False
    the program's readings, True the control's) and ``work(judge)``
    (the profiled span's launches by the frozen counts)."""

    def __init__(self, kt, cfg, mod, traffic, seed, device):
        self.kt, self.cfg, self.mod = kt, cfg, mod
        self.traffic, self.seed, self.device = traffic, int(seed), device
        self.data = mod.make_data(cfg)
        self.model = mod.model(cfg, self.data)
        self.prior = self.model.port_prior(kt)
        self.kw = model_kwargs(cfg, self.model)
        self.prof = None
        self.profiled = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def profiling(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.sync()
        with profile(activities=acts) as prof:
            yield
            self.sync()
        self.prof = prof


def make(kt, cfg, mod, traffic, seed, device):
    """The job of the traffic's kind, found as ``kinds/<kind>.py``."""
    kind = traffic["kind"]
    kmod = _load(HERE / "kinds" / f"{kind}.py",
                 "benchport_kind_" + kind.replace("-", "_").replace(".", "_"))
    return kmod.Kind(kt, cfg, mod, traffic, seed, device)
