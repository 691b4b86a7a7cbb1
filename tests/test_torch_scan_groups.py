"""The scan kernel #5 (``kt_streaming_scan_cost`` of
``kissabc_tpu_torch/csrc/scan.cuh``) with emitted user models, compiled for
the host with ``g++`` against the emulation in ``tests/host_cuda/``: its
step loop in whole Philox groups of four steps with the ragged last group
peeled, and its stub loop, give the outputs of the loop it replaced (one
pair of steps at a time, the Philox words of a pair picked by ``j & 1``,
kept below as the reference) bit for bit, for AR(1), SIR with a series and
a two-leaf state, nsteps % 4 in {0, 1, 2, 3}, Philox and stub bits, and
blocks of 64 to 512 threads over a width no block divides. Skipped without
a host C++ compiler.
"""

import ctypes

import numpy as np
import pytest
import torch

from host_cuda.build import build_program
import kissabc_tpu_torch as kt
from kissabc_tpu_torch import models
from kissabc_tpu_torch.ops import scan as S
from torch_threads import one_torch_thread  # noqa: F401

N = 1000
THREADS = (64, 128, 256, 512)

# The loop of the kernel before it ran whole groups: one pair of steps at
# a time, for each walker in turn.
_RUNNER = r"""
extern "C" int run_kernel(const float* const* th, const long long* seed,
                          const float* series, float* out, int n,
                          int nsteps, float inv_n, int stub, int sb_rows,
                          int sr, int threads) {
  return kt_streaming_scan_cost(th, seed, series, out, n, n, nsteps, inv_n,
                                stub, sb_rows, sr, threads, nullptr);
}

extern "C" void run_parent(const float* const* th, const long long* seed_ptr,
                           const float* series, float* out, int n,
                           int nsteps, float inv_n, int stub, int sb_rows,
                           int sr) {
  uint32_t seed = (uint32_t)(unsigned long long)seed_ptr[0];
  for (int w = 0; w < n; ++w) {
    Walker wk;
    for (int k = 0; k < KT_NPARAMS; ++k) wk.th[k] = th[k][w];
    scan_init(wk.th, wk.x);
    for (int p = 0; p < KT_NSTATS; ++p) wk.s[p] = 0.0f;
    uint32_t pid = (uint32_t)(w / sb_rows);
    int prow = (w % sb_rows) / 128;
    uint32_t ws = (uint32_t)(prow / sr), sub = (uint32_t)(prow % sr);
    uint32_t lane = (uint32_t)(w % 128);
    int npairs = (nsteps + 1) / 2;
    PhiloxKey key = philox_key(seed);
    Words4 q = {0u, 0u, 0u, 0u};
    for (int j = 0; j < npairs; ++j) {
      uint32_t b1, b2;
      if (stub) {
        uint32_t ctr = 2u * (ws * (uint32_t)npairs + (uint32_t)j);
        b1 = stub_bits(pid, seed, ctr, sub, lane);
        b2 = stub_bits(pid, seed, ctr + 1u, sub, lane);
      } else {
        if ((j & 1) == 0)
          q = philox4x32_10((uint32_t)(j >> 1), (uint32_t)w, kStreamScan, 0u,
                            key);
        b1 = (j & 1) ? q.x2 : q.x0;
        b2 = (j & 1) ? q.x3 : q.x1;
      }
      float ea, eb;
#if KT_NOISE_NORMAL
      box_muller(b1, b2, &ea, &eb);
#else
      ea = to_unit(b1);
      eb = to_unit(b2);
#endif
      scan_one_step(wk, ea, 2 * j, series, nsteps);
      if (2 * j + 1 < nsteps) scan_one_step(wk, eb, 2 * j + 1, series, nsteps);
    }
    for (int p = 0; p < KT_NSTATS; ++p) out[(size_t)p * n + w] = wk.s[p] * inv_n;
  }
}
"""


def _two_leaf():
    """The two-component state of tests/test_scan_cost.py:151-168."""
    def step(th, xt, eps, t):
        x, acc = xt
        x = x + th[0] * 0.1 + eps
        return (x, 0.9 * acc + 0.1 * torch.abs(x))

    def init(th):
        return (th[0], torch.abs(th[0]))

    def observe(th, xt, t, obs):
        return (xt[1], xt[0] * t.float())

    return step, init, observe


def _model(name, nsteps, bits):
    """(cost, thetas) at N walkers."""
    rng = np.random.default_rng(nsteps)
    if name == "ar1":
        _, step, init, reduce_cost = models.ar1()
        cost = kt.make_streaming_scan_cost(step, init, reduce_cost,
                                           nsteps=nsteps, bits=bits)
        th = (rng.uniform(0.0, 2.0, N), rng.uniform(0.3, 2.0, N))
    elif name == "sir":
        _, step, init, observe, reduce_cost, _ = models.sir()
        series = rng.uniform(0.0, 200.0, nsteps).astype(np.float32)
        cost = kt.make_streaming_scan_cost(
            step, init, reduce_cost, observe=observe, series=series,
            nsteps=nsteps, bits=bits)
        th = (rng.uniform(0.05, 0.8, N), rng.uniform(0.02, 0.4, N))
    else:
        step, init, observe = _two_leaf()
        cost = kt.make_streaming_scan_cost(step, init, lambda th, m: m[0],
                                           observe=observe, nsteps=nsteps,
                                           bits=bits)
        th = (rng.uniform(0.5, 2.0, N),)
    return cost, tuple(torch.from_numpy(x.astype(np.float32)) for x in th)


_LIBS = {}


def _library(tmp_path_factory, cost):
    """The emitted unit with scan.cuh and the runner, built once per
    unit."""
    source = cost.unit(cost.graphs.structure).source
    if source not in _LIBS:
        root = tmp_path_factory.mktemp("scan_groups")
        (root / "unit.cpp").write_text(source + _RUNNER)
        _LIBS[source] = ctypes.CDLL(str(build_program(
            root, "scan.cuh", "unit.cpp", shared=True)))
    return _LIBS[source]


@pytest.mark.parametrize("bits", ["hw", "stub"])
@pytest.mark.parametrize("nsteps", [100, 101, 102, 103])
@pytest.mark.parametrize("name", ["ar1", "sir", "two-leaf"])
def test_grouped_loop_gives_the_parent_loop_bits(tmp_path_factory, name,
                                                 nsteps, bits):
    cost, th = _model(name, nsteps, bits)
    lib = _library(tmp_path_factory, cost)
    unit = cost.unit(cost.graphs.structure)
    sb_rows, sr = S.slab_rows(N, cost.block, cost.walker_tiles,
                              cost.sub_rows)
    ptrs = (ctypes.c_void_p * len(th))(*(t.data_ptr() for t in th))
    seed = torch.tensor([123456789], dtype=torch.int64)
    series = (cost.series.on(torch.device("cpu")) if cost.series is not None
              else torch.zeros(1))
    inv_n = ctypes.c_float(float(np.float32(1.0 / nsteps)))
    args = (ptrs, ctypes.c_void_p(seed.data_ptr()),
            ctypes.c_void_p(series.data_ptr()))
    want = torch.full((unit.nstats, N), float("nan"))
    lib.run_parent(*args, ctypes.c_void_p(want.data_ptr()), N, nsteps, inv_n,
                   int(bits == "stub"), sb_rows, sr)
    assert bool(torch.isfinite(want).all())
    for threads in THREADS:
        got = torch.full_like(want, float("nan"))
        err = lib.run_kernel(*args, ctypes.c_void_p(got.data_ptr()), N,
                             nsteps, inv_n, int(bits == "stub"), sb_rows, sr,
                             threads)
        assert err == 0
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            threads
    # a block size the kernel cannot take is refused
    assert lib.run_kernel(*args, ctypes.c_void_p(want.data_ptr()), N, nsteps,
                          inv_n, 0, sb_rows, sr, 48) == 9
