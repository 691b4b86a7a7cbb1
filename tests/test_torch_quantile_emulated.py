"""The radix select of ``kissabc_tpu_torch/csrc/select.cu`` compiled for
the host with ``g++`` against the emulation in
``tests/host_cuda/cuda_runtime.h`` and called through its entry point
``kt_masked_quantile``, against its plain version
``masked_quantile_bisect_plain`` and the JAX package's
``masked_quantile_bisect`` on the same float32 input: the same bits
(tolerance 0).

The battery: n in {1, 7, 1000, 2^12 + 3}; masks all dead, one alive,
90% alive and all alive; values with negatives, with ties at every rank,
and with +-inf; q in {0, 0.5, 0.95, 1}; grids of one to four blocks of
32 to 128 threads, so the grid barrier runs between blocks. Then ties
placed at rank k and at k + 1, signed zeros, NaN, a misaligned vector
(the kernel's scalar loads) and the geometries the entry refuses.

The case where the sort (``masked_quantile``) already disagrees with
the bisection is named here rather than dropped: an alive NaN, which
the sort puts last as NaN (with every entry alive its top quantiles are
NaN) and the bisection counts as +inf. Signed zeros do not make one:
the sort, the bisection and the kernel agree (a zero xlo interpolates to
+0.0 in each). Skipped without a host C++
compiler (~30 s, the g++ build ~2 s).
"""

import ctypes
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from host_cuda.build import build_program
from kissabc_tpu.ops import quantile as jq
from kissabc_tpu_torch.ops import quantile as tq
from torch_threads import one_torch_thread  # noqa: F401

NS = (1, 7, 1000, (1 << 12) + 3)
MASKS = ("dead", "one", "most", "all")
VALUES = ("normal", "ties", "inf")
QS = (0.0, 0.5, 0.95, 1.0)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_jax_bisect = jax.jit(jq.masked_quantile_bisect)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    root = tmp_path_factory.mktemp("select")
    (root / "unit.cpp").write_text('#include "select.cu"\n')
    lib = ctypes.CDLL(str(build_program(root, "select.cu", "unit.cpp",
                                        shared=True)))
    lib.kt_masked_quantile.argtypes = [_P, _P, _I, _F, _P, _P, _I, _I, _P]
    lib.kt_masked_quantile.restype = _I
    lib.kt_masked_quantile_scratch_words.argtypes = []
    lib.kt_masked_quantile_scratch_words.restype = _I
    return lib


def _kernel(lib, x, mask, q, blocks, threads):
    """The kernel's result on CPU tensors, its scratch and output first
    filled with garbage (the kernel zeroes what it uses)."""
    out = torch.full((1,), 12345.0)
    scratch = torch.full((lib.kt_masked_quantile_scratch_words(),),
                         0x5A5A5A5A, dtype=torch.int32)
    err = lib.kt_masked_quantile(x.data_ptr(), mask.data_ptr(), x.shape[0],
                                 q, out.data_ptr(), scratch.data_ptr(),
                                 blocks, threads, None)
    assert err == 0
    return out[0]


def _bits(v):
    return int(np.asarray(v, np.float32).view(np.uint32))


def _check(lib, x, mask, q, blocks=3, threads=64):
    """Kernel, plain version and JAX give the same bits; returns them."""
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    got = _bits(_kernel(lib, xt, mt, q, blocks, threads))
    plain = _bits(tq.masked_quantile_bisect_plain(xt, mt, q))
    jax_ = _bits(_jax_bisect(jnp.asarray(x), jnp.asarray(mask), q))
    assert got == plain == jax_, (q, got, plain, jax_)
    return got


def _values(kind, n, rng):
    x = rng.normal(size=n).astype(np.float32)
    if kind == "ties":        # seven values: ties at every rank
        x = (rng.integers(-3, 4, n) * 0.5).astype(np.float32)
    elif kind == "inf":
        x[rng.random(n) < 0.15] = np.inf
        x[rng.random(n) < 0.1] = -np.inf
    return x


def _mask(kind, n, rng):
    if kind == "dead":
        return np.zeros(n, bool)
    if kind == "one":
        m = np.zeros(n, bool)
        m[rng.integers(n)] = True
        return m
    if kind == "most":
        return rng.random(n) < 0.9
    return np.ones(n, bool)


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("values", VALUES)
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("n", NS)
def test_kernel_bits_equal_the_bisection(lib, n, mask, values, q):
    case = (NS.index(n), MASKS.index(mask), VALUES.index(values),
            QS.index(q))
    rng = np.random.default_rng(case)
    blocks = 1 + sum(case) % 4
    threads = (32, 64, 128)[sum(case) % 3]
    got = _check(lib, _values(values, n, rng), _mask(mask, n, rng), q,
                 blocks, threads)
    if mask == "dead":
        assert got == _bits(np.inf)


@pytest.mark.parametrize("where", ["k", "k+1", "both", "neither"])
@pytest.mark.parametrize("q", [0.25, 0.5, 0.9])
def test_ties_at_rank_k_and_k_plus_1(lib, where, q):
    """Sorted alive values with a tie placed on rank k (with k - 1), on
    rank k + 1 (with k + 2), on both (k and k + 1 equal) or on neither,
    shuffled and with dead entries between them."""
    rng = np.random.default_rng(7)
    m = 1001
    k = math.floor(np.float32(m - 1) * np.float32(q))
    s = np.arange(m, dtype=np.float32) * 0.125 - 40.0
    if where == "k":
        s[k - 1] = s[k]
    elif where == "k+1":
        s[k + 2] = s[k + 1]
    elif where == "both":
        s[k + 1] = s[k]
    n = m + 300
    x = rng.normal(size=n).astype(np.float32) * 100
    mask = np.zeros(n, bool)
    pos = rng.permutation(n)[:m]
    x[pos], mask[pos] = rng.permutation(s), True
    _check(lib, x, mask, q, blocks=4, threads=64)


def test_signed_zeros(lib):
    """-0.0 keys below +0.0; the kernel, the bisection, JAX and the sort
    agree on every q (a zero xlo interpolates to +0.0 in each)."""
    x = np.array([-1.0, 0.0, -0.0, 0.0, -0.0, 2.0, 3.0, -0.0, 5.0],
                 np.float32)
    mask = np.ones(len(x), bool)
    mask[3] = False
    for q in np.linspace(0, 1, 33, dtype=np.float32):
        got = _check(lib, x, mask, float(q), blocks=2, threads=32)
        sort = tq.masked_quantile(torch.from_numpy(x),
                                  torch.from_numpy(mask), float(q))
        assert _bits(sort) == got, q


def test_nan_counts_as_inf(lib):
    """An alive NaN ranks as +inf in the kernel and the bisection (they
    agree with JAX); the sort puts it last as NaN, after the dead entries'
    +inf, so where every entry is alive the sort's quantiles near the top
    are NaN where the bisection's are values or +inf: a disagreement of
    sort and bisection, named here. With dead entries they agree."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=500).astype(np.float32)
    x[rng.random(500) < 0.1] = np.nan
    x[:3] = np.array([np.inf, -np.inf, -np.nan], np.float32)
    for mask in (rng.random(500) < 0.8, np.ones(500, bool)):
        mask[:3] = True
        differ = 0
        for q in (0.0, 0.3, 0.5, 0.85, 0.9, 0.95, 1.0):
            got = _check(lib, x, mask, q, blocks=3, threads=64)
            assert not math.isnan(np.uint32(got).view(np.float32))
            sort = tq.masked_quantile(torch.from_numpy(x),
                                      torch.from_numpy(mask), q)
            if _bits(sort) != got:
                assert mask.all() and math.isnan(sort), q
                differ += 1
        assert differ == (3 if mask.all() else 0)


def test_misaligned_vectors_take_the_scalar_loads(lib):
    rng = np.random.default_rng(11)
    xs = torch.from_numpy(rng.normal(size=2050).astype(np.float32))
    ms = torch.from_numpy(rng.random(2050) < 0.6)
    x, mask = xs[1:2046], ms[3:2048]   # 4 and 3 bytes past the start
    assert x.data_ptr() % 16 and mask.data_ptr() % 4
    for q in QS:
        got = _bits(_kernel(lib, x, mask, q, 2, 64))
        want = tq.masked_quantile_bisect_plain(x.clone(), mask.clone(), q)
        assert got == _bits(want), q


@pytest.mark.parametrize("blocks,threads", [(0, 64), (2, 48), (2, 16),
                                            (2, 2048)])
def test_refused_geometry(lib, blocks, threads):
    x = torch.zeros(8)
    mask = torch.ones(8, dtype=torch.bool)
    out = torch.zeros(1)
    scratch = torch.zeros(lib.kt_masked_quantile_scratch_words(),
                          dtype=torch.int32)
    err = lib.kt_masked_quantile(x.data_ptr(), mask.data_ptr(), 8, 0.5,
                                 out.data_ptr(), scratch.data_ptr(), blocks,
                                 threads, None)
    assert err == 9   # cudaErrorInvalidConfiguration
