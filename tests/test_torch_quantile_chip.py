"""Where ``masked_quantile_bisect`` goes, and the radix select of
``kissabc_tpu_torch/csrc/select.cu`` on a card. Imports nothing of JAX:
the card's tests compare with the plain version.

Without a card: a CPU vector goes to the plain bisection and ``Sharded``
vectors to the bisection over the shards, neither launching the kernel;
the kernel's wrapper refuses CPU tensors; its operands are made
contiguous float32 and bool vectors, and an ``x`` of another dtype is
refused.

On a card (marked ``chip``; ``python -m pytest
tests/test_torch_quantile_chip.py -m chip -rs``, ~2 min with the builds):

- at 2^20 entries, on 20 seeds, the kernel's bits equal the plain
  version's on the same tensors;
- a strided vector and a uint8 mask give the bits of their contiguous
  float32 and bool copies;
- a 2^20-walker smc solve of g-and-k through 7 streamed ecdf probes
  (the ``gk-ecdf`` configuration, built here with the port's API)
  through the kernel runs the same eps trajectory and number of
  iterations as with ``quantile_impl="sort"``, which never reaches it;
- ``launches.masked_quantile`` counts one launch an iteration, in each
  ``smc.threshold`` span's counts, and the threshold makes no copy;
- ``Sharded`` vectors on the card still go to the bisection.
"""

import numpy as np
import pytest
import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.ops import quantile as tq
from kissabc_tpu_torch.parallel.mesh import join, make_mesh, place
from kissabc_tpu_torch.utils import logging as L
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _bits(t):
    return t.detach().to("cpu", torch.float32).reshape(()).view(
        torch.int32).item()


def _case(seed, n, device):
    """Values with negatives, ties, +-inf and NaN, a mask with a share
    alive from all to few, and q, all from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=g)
    if seed % 2:
        x = torch.round(x * 64) / 64          # ties at every rank
    u = torch.rand(n, generator=g)
    if seed % 5 == 0:
        x[u < 0.01] = float("inf")
        x[u > 0.995] = -float("inf")
    if seed % 7 == 0:
        x[(u > 0.5) & (u < 0.501)] = float("nan")
    alive = torch.rand(n, generator=g) < (1.0, 0.9, 0.5, 1e-5)[seed % 4]
    q = (0.0, 0.5, 0.95, 1.0, 0.3)[seed % 5]
    return x.to(device), alive.to(device), q


def _launches():
    return tq.launches["masked_quantile"]


def test_cpu_vectors_go_to_the_plain_bisection():
    x, alive, q = _case(3, 4099, "cpu")
    before = _launches()
    got = tq.masked_quantile_bisect(x, alive, q)
    assert _launches() == before
    assert _bits(got) == _bits(tq.masked_quantile_bisect_plain(x, alive, q))
    with pytest.raises(ValueError, match="on one CUDA device"):
        tq.masked_quantile_select(x, alive, q)


def test_select_operands_are_contiguous_float32_and_bool():
    x, alive, _ = _case(9, 64, "cpu")
    xs, ms = tq._select_operands(x[::2], alive[::2].to(torch.uint8))
    assert xs.is_contiguous() and ms.is_contiguous()
    assert xs.dtype == torch.float32 and ms.dtype == torch.bool
    assert torch.equal(xs, x[::2]) and torch.equal(ms, alive[::2])
    with pytest.raises(TypeError, match="float32"):
        tq._select_operands(x.double(), alive)
    with pytest.raises(ValueError, match="one length"):
        tq._select_operands(x, alive[1:])


def _sharded_goes_to_the_mesh_bisection(device):
    mesh = make_mesh(walker=2, devices=[device] * 2)
    x, alive, q = _case(5, 4100, device)
    xs, ms = place(mesh, x), place(mesh, alive)
    before = _launches()
    got = tq.masked_quantile_bisect(xs, ms, q)
    assert _launches() == before
    want = tq.masked_quantile_bisect_plain(join(xs).cpu(), join(ms).cpu(), q)
    assert _bits(got) == _bits(want)


def test_sharded_vectors_go_to_the_mesh_bisection():
    _sharded_goes_to_the_mesh_bisection("cpu")


@pytest.mark.chip
def test_sharded_vectors_on_the_card_go_to_the_mesh_bisection(cuda_card):
    _sharded_goes_to_the_mesh_bisection(str(cuda_card))


@pytest.mark.chip
def test_kernel_bits_equal_the_plain_version_at_2_20(cuda_card):
    n = 1 << 20
    for seed in range(20):
        x, alive, q = _case(seed, n, cuda_card)
        before = _launches()
        got = tq.masked_quantile_bisect(x, alive, q)
        assert _launches() == before + 1
        want = tq.masked_quantile_bisect_plain(x, alive, q)
        assert got.shape == () and got.dtype == torch.float32
        assert _bits(got) == _bits(want), (seed, got.item(), want.item())


@pytest.mark.chip
def test_strided_operands_give_the_bits_of_their_copies(cuda_card):
    x, alive, q = _case(13, (1 << 20) + 6, cuda_card)
    xs, ms = x[1::2], alive[::2].to(torch.uint8)
    got = tq.masked_quantile_bisect(xs, ms, q)
    want = tq.masked_quantile_bisect_plain(xs.contiguous(),
                                           ms.to(torch.bool), q)
    assert _bits(got) == _bits(want)


# g-and-k (Allingham, King and Mengersen 2009) at (3, 1, 2, 0.5), c = 0.8,
# 2000 draws a walker through 7 ecdf indicators at the octiles of the
# truth: the sizes and settings of benchport/configs/gk-ecdf.json
GK_TRUE, GK_C, GK_NDRAWS = (3.0, 1.0, 2.0, 0.5), 0.8, 2000
OCTILES = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875)
GK_SMC = dict(nparticles=1 << 20, alpha=0.95, min_r_ess=0.5, epstol=0.02,
              mcmc_retrys=0, mcmc_tol=0.015, max_stretch=2.0,
              max_iters=10000, resample="replicate")


def _gk(theta, z):
    a, b, g, k = theta
    return a + b * (1.0 + GK_C * torch.tanh(g * z / 2.0)) * z * torch.exp(
        k * torch.log1p(z * z))


def _gk_reduce(theta, m):
    err = [mk - o for mk, o in zip(m, OCTILES)]
    acc = err[0] * err[0]
    for e in err[1:]:
        acc = acc + e * e
    return torch.sqrt(acc)


def _gk_model():
    """(prior, streamed cost, fused sweep) of the g-and-k ecdf fit; the
    probes the float32 octiles of 200000 draws at the truth (NumPy,
    seed 0)."""
    z = np.random.default_rng(0).standard_normal(200_000)
    a, b, g, k = GK_TRUE
    draws = a + b * (1.0 + GK_C * np.tanh(g * z / 2.0)) * z * np.exp(
        k * np.log1p(z * z))
    probes = [float(np.float32(t)) for t in np.quantile(draws, OCTILES)]
    stats = [(lambda x, t=t: (x < t).to(torch.float32)) for t in probes]
    kw = dict(ndraws=GK_NDRAWS, noise="normal", chunk=512, stats=stats)
    prior = kt.Factored(kt.Uniform(0, 10), kt.Uniform(0, 5),
                        kt.Uniform(0, 10), kt.Uniform(0, 2.5))
    return (prior, kt.make_streaming_moment_cost(_gk, _gk_reduce, **kw),
            kt.make_fused_smc_sweep(prior, _gk, _gk_reduce,
                                    max_stretch=GK_SMC["max_stretch"], **kw))


def _stepped(model, impl, key, device):
    prior, cost, sweep = model
    log = kt.IterLog(enabled=False)
    res = kt.smc_stepped(prior, cost, log=log, cost_vectorized=True,
                         sweep_fused=sweep, quantile_impl=impl, key=key,
                         device=device, **GK_SMC)
    return res, [r["eps"] for r in log.records]


@pytest.mark.chip
def test_gk_solve_through_the_kernel_follows_the_sort(cuda_card):
    model = _gk_model()
    sort, sort_eps = _stepped(model, "sort", 11, cuda_card)
    L.reset_spans()
    before = _launches()
    with L.tracing():
        res, eps = _stepped(model, "auto", 11, cuda_card)
    assert res.iterations == sort.iterations == len(eps)
    assert eps == sort_eps
    assert _launches() - before == res.iterations
    threshold = [s for s in L.spans() if s["name"] == "smc.threshold"]
    assert len(threshold) == res.iterations
    for s in threshold:
        assert s["counts"].get("launches.masked_quantile") == 1, s["counts"]
        assert "host_copies" not in s["counts"], s["counts"]
