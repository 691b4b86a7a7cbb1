"""The fused smc iteration as CUDA graphs on a card (``core/smc.py``
``_IterGraphs`` recording ``FusedSMCSweep``, kernel #3). Imports nothing
of JAX: the card's solves are compared with each other.

On a card (marked ``chip``; ``python -m pytest
tests/test_torch_smc_graphs_chip.py -m chip -rs -s``, ~1 min with the
builds): at 2^20 walkers on ``gk-ecdf``, keys 1-3, a solve whose
iterations after the first replay as two CUDA graphs equals bit for bit
a solve forced eager by wrapping the sweep in a plain function, as the
benchmark's judged replay wraps it: iterations, eps, costs, population,
evidence and the generator's final state. ``graph_replays`` counts
2 x (iterations - 1) in the graphed solve and 0 in the eager one. After
the first key the solves take no new memory from the card (no new
segment: each capture reuses the blocks of the last). Each solve's time
(host clock, the result on the host) is printed as a JSON line.
"""

import json
import time

import numpy as np
import pytest
import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.utils import logging as L
from test_torch_quantile_chip import GK_SMC, _gk_model
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _plain(sweep):
    """The sweep as a plain function: no ``graph_safe``, so eager."""
    def call(gen, thetas, xs, lps, alive, eps, flag):
        return sweep(gen, thetas, xs, lps, alive, eps, flag)
    return call


def _solve(model, key, device, eager):
    prior, cost, sweep = model
    gen = torch.Generator(device).manual_seed(key)
    replays = L.counts()["graph_replays"]
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    res = kt.smc(prior, cost, cost_vectorized=True,
                 sweep_fused=_plain(sweep) if eager else sweep, key=gen,
                 device=device, **GK_SMC)
    seconds = time.perf_counter() - t0
    return (res, gen.get_state(), L.counts()["graph_replays"] - replays,
            seconds)


def _segments(device):
    """The segments the caching allocator has taken from the card
    (``cudaMalloc`` calls), all pools and graphs' pools."""
    return torch.cuda.memory_stats(device).get("segment.all.allocated", 0)


@pytest.mark.chip
def test_graphed_gk_solve_equals_the_eager_one_at_2_20(cuda_card):
    model = _gk_model()
    for eager in (True, False):   # build, load and warm both forms
        _solve(model, 0, cuda_card, eager)
    for key in (1, 2, 3):
        if key == 2:
            segments = _segments(cuda_card)
        eager, e_gen, e_replays, e_s = _solve(model, key, cuda_card, True)
        graphed, g_gen, g_replays, g_s = _solve(model, key, cuda_card, False)
        print(json.dumps({"key": key, "iterations": graphed.iterations,
                          "eager_s": e_s, "graphed_s": g_s}), flush=True)
        assert graphed.iterations == eager.iterations > 100
        assert graphed.eps == eager.eps
        assert graphed.ess == eager.ess
        assert graphed.log_evidence == eager.log_evidence
        np.testing.assert_array_equal(graphed.C, eager.C)
        for a, b in zip(graphed.P, eager.P):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert torch.equal(g_gen, e_gen)
        assert e_replays == 0
        assert g_replays == 2 * (graphed.iterations - 1)
    assert _segments(cuda_card) == segments
