"""The AIS program's public names and parameters in kissabc_tpu_torch
against the JAX package's (``kissabc_tpu/__init__.py:64-67,73``,
``kissabc_tpu/core/ais.py:128-130,161``): the top-level exports
``make_run``, ``make_sweep``, ``make_sweep_halves`` and ``checkpoint``;
the JAX parameter order ``(model, n, kernel, constrain, partner_scheme,
mesh)``, so that a positional JAX-style call runs and gives the outputs
of the keyword call; ``constrain`` applied to each half; ``mesh=``
refused as every other entry point of the port refuses it. On the CPU.
"""

import inspect

import pytest
import torch

import kissabc_tpu as ka
import kissabc_tpu_torch as kt
from kissabc_tpu_torch.ops.moves import mixture_one
from torch_threads import one_torch_thread  # noqa: F401

NAMES = ["make_run", "make_sweep", "make_sweep_halves", "checkpoint"]
N, D = 32, 2


def _model():
    return kt.CommonLogDensity(
        D, lambda g: torch.randn(D, generator=g),
        lambda x: -0.5 * torch.sum(x * x))


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    th = torch.randn(N, D, generator=g)
    return th, _model().loglike_batch(th, g)


def _halves(x):
    return x[:N // 2], x[N // 2:]


@pytest.mark.parametrize("name", NAMES)
def test_top_level_names_of_the_jax_package(name):
    assert hasattr(ka, name)
    assert hasattr(kt, name) and name in kt.__all__


def test_checkpoint_is_the_ports_module():
    from kissabc_tpu_torch.utils import checkpoint
    assert kt.checkpoint is checkpoint
    assert callable(kt.checkpoint.save) and callable(kt.checkpoint.load)


@pytest.mark.parametrize("name", ["make_sweep", "make_sweep_halves"])
def test_parameters_in_the_jax_order(name):
    from kissabc_tpu.core import ais as jax_ais
    ours = list(inspect.signature(getattr(kt, name)).parameters)
    assert ours == list(inspect.signature(getattr(jax_ais,
                                                  name)).parameters)
    assert ours == ["model", "n", "kernel", "constrain", "partner_scheme",
                    "mesh"]


@pytest.mark.parametrize("scheme", ["roll", "gather"])
def test_positional_jax_call_equals_the_keyword_call(scheme):
    th, ld = _state(1)
    pos = kt.make_sweep(_model(), N, mixture_one, lambda t: t, scheme)
    kw = kt.make_sweep(_model(), N, partner_scheme=scheme)
    a = pos(torch.Generator().manual_seed(2), th, ld)
    b = kw(torch.Generator().manual_seed(2), th, ld)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], th)   # some walker moved
    pos_h = kt.make_sweep_halves(_model(), N, mixture_one, lambda t: t,
                                 scheme)
    c = pos_h(torch.Generator().manual_seed(2), _halves(th), _halves(ld))
    assert torch.equal(torch.cat(c[0]), a[0])
    assert torch.equal(torch.cat(c[1]), a[1])


def test_constrain_is_applied_to_each_half():
    seen = []

    def constrain(t):
        seen.append(tuple(t.shape))
        return t

    th, ld = _state(3)
    halves = kt.make_sweep_halves(_model(), N, mixture_one, constrain)
    halves(torch.Generator().manual_seed(4), _halves(th), _halves(ld))
    assert seen == [(N // 2, D), (N // 2, D), (N // 2,), (N // 2,)]
    seen.clear()
    kt.make_sweep(_model(), N, constrain=constrain)(
        torch.Generator().manual_seed(4), th, ld)
    assert seen == [(N // 2, D), (N // 2, D), (N // 2,), (N // 2,),
                    (N, D), (N,)]


@pytest.mark.parametrize("name", ["make_sweep", "make_sweep_halves",
                                  "make_run"])
def test_mesh_is_not_ported(name):
    fn = getattr(kt, name)
    # mesh= takes a Mesh; the sharded sweeps and runs are held against
    # the unsharded ones in tests/test_torch_parallel_samplers.py
    with pytest.raises(TypeError, match="Mesh"):
        if name == "make_run":
            fn(_model(), kt.AIS(N), N, mesh=object())
        else:
            fn(_model(), N, mesh=object())
