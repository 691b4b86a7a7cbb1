"""Kernel #3 (``fused_smc_sweep_kernel`` of
``kissabc_tpu_torch/csrc/generic.cuh``) compiled for the host with ``g++``
against the emulation in ``tests/host_cuda/cuda_runtime.h`` and called
through its entry point ``kt_fused_smc_sweep``, against the plain version
``fused_smc_sweep_plain`` on the same inputs, with the partners read from
the walkers' own leaves (null partner pointers) or, as a shard of a mesh
runs it, from two other sets of leaves: on the mixed discrete prior
of tests/test_pallas.py:873 the kernel pushes the proposal (m rounded
half to even) for the prior and the simulator and commits the raw
proposal, as the JAX kernel does (pallas_kernels.py:2270-2280); on the
flagship prior the push is a copy. The commit masks agree but within
1e-4 of eps, committed values within rtol 2e-4, atol 2e-5 (the golden
tolerance), uncommitted outputs equal their inputs bit for bit. Skipped
without a host C++ compiler (~25 s with the four g++ builds, by
``pytest --durations``).
"""

import ctypes

import numpy as np
import pytest
import torch

import kissabc_tpu_torch as kt
from host_cuda.build import build_program
from kissabc_tpu_torch import models
from kissabc_tpu_torch.ops import fused_smc as F
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
N, NDRAWS, CHUNK, THREADS = 256, 64, 32, 64


def _mixed():
    prior, draw, reduce_cost = models.mixed_discrete()
    rng = np.random.default_rng(5)
    th = [rng.uniform(0.6, 10.4, N), rng.uniform(0.1, 1.0, N)]
    return prior, draw, reduce_cost, th


def _flagship():
    """The flagship prior and draw with the golden test's linear reduce
    (the README cost's var = m2 - m1^2 cancels: tests/
    test_torch_fused_smc.py CANCEL_ATOL)."""
    prior, draw, _ = models.flagship()
    rng = np.random.default_rng(6)
    return prior, draw, (lambda th, m: m[0] + 10.0 * m[1]), [
        rng.uniform(1.6, 2.4, N), rng.uniform(0.0, 0.1, N)]


MODELS = {"mixed-discrete": _mixed, "flagship": _flagship}


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


@pytest.mark.parametrize("bits", ["hw", "stub"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_kernel_matches_the_plain_version(tmp_path, name, bits):
    _check(tmp_path, name, bits, partners=False)


@pytest.mark.parametrize("bits", ["hw", "stub"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_kernel_reads_the_given_partners(tmp_path, name, bits):
    _check(tmp_path, name, bits, partners=True)


def _check(tmp_path, name, bits, partners):
    prior, draw, reduce_cost, th = MODELS[name]()
    sw = kt.make_fused_smc_sweep(prior, draw, reduce_cost, ndraws=NDRAWS,
                                 chunk=CHUNK, bits=bits)
    (tmp_path / "unit.cpp").write_text(sw.unit.source)
    lib = ctypes.CDLL(str(build_program(tmp_path, None, "unit.cpp",
                                        shared=True)))
    leaves = [torch.tensor(x, dtype=torch.float32) for x in th]
    lps = prior.logpdf_tree(prior.push_tree(tuple(leaves))).to(torch.float32)
    xs = torch.full((N,), 1e6)
    alive = torch.arange(N) % 7 != 0
    r1, r2, seed = 5, N // 2 + 3, 2024
    parts = None
    if partners:
        # a shard's form on a mesh: shifts 0 and the partners given as
        # two other sets of leaves, here not rolls of the walkers' own,
        # so a partner read from the wrong set or row shows
        rng = np.random.default_rng(7)
        parts = tuple([torch.tensor(rng.permutation(x), dtype=torch.float32)
                       for x in th] for _ in range(2))
        r1 = r2 = 0
    probe = F.fused_smc_sweep_plain(sw, leaves, xs, lps, alive, 1e6, False,
                                    r1, r2, seed, partners=parts)
    eps = float(probe[1][probe[3]].median())
    want = F.fused_smc_sweep_plain(sw, leaves, xs, lps, alive, eps, False,
                                   r1, r2, seed, partners=parts)
    oth = [torch.full((N,), -7.0) for _ in leaves]
    oxs, olps = torch.full((N,), -7.0), torch.full((N,), -7.0)
    ocm = torch.zeros(N, dtype=torch.uint8)
    alive_u8 = alive.to(torch.uint8)
    eps_t = torch.tensor([eps], dtype=torch.float32)
    flag_t = torch.zeros(1, dtype=torch.uint8)
    rs = torch.tensor([r1, r2, seed], dtype=torch.int64)
    lib.kt_fused_smc_sweep.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                  ctypes.c_float] + [ctypes.c_int] * 5
        + [ctypes.c_void_p] * 3)
    err = lib.kt_fused_smc_sweep(
        ctypes.cast(_ptrs(leaves), ctypes.c_void_p), xs.data_ptr(),
        lps.data_ptr(), alive_u8.data_ptr(), eps_t.data_ptr(),
        flag_t.data_ptr(), rs.data_ptr(),
        ctypes.cast(_ptrs(oth), ctypes.c_void_p), oxs.data_ptr(),
        olps.data_ptr(), ocm.data_ptr(), N, NDRAWS,
        float(np.float32(1.0 / NDRAWS)), sw.w_scale, int(bits == "stub"),
        sw._sb_rows(N), CHUNK, N // THREADS, THREADS, None,
        *((None, None) if parts is None else
          (ctypes.cast(_ptrs(p), ctypes.c_void_p) for p in parts)))
    assert err == 0
    got_cm, want_cm = ocm.to(torch.bool), want[3]
    border = (want[1] - eps).abs() < 1e-4
    assert bool(((got_cm == want_cm) | border).all())
    both = got_cm & want_cm
    assert int(both.sum()) > 5
    for g, w in zip(oth + [oxs, olps], list(want[0]) + [want[1], want[2]]):
        np.testing.assert_allclose(g[both].numpy(), w[both].numpy(),
                                   rtol=RTOL, atol=ATOL)
    for g, x in zip(oth + [oxs, olps], leaves + [xs, lps]):
        assert torch.equal(g[~got_cm], x[~got_cm])
    if name == "mixed-discrete":   # the raw m is committed, not the pushed
        m = oth[0][got_cm]
        assert bool((m != torch.round(m)).all())
