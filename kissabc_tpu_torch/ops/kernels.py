"""The flagship model's two kernels — the PyTorch counterpart of
``normal_summary_cost`` / ``make_flagship_cost_batched`` and
``_fused_sweep_call`` / ``make_fused_flagship_sweep`` in
``kissabc_tpu/ops/pallas_kernels.py``.

Each kernel is hand-written CUDA C++ for Hopper (``csrc/flagship.cu``)
behind a wrapper here. Beside each wrapper is the kernel's plain PyTorch
version, which repeats its arithmetic op by op:

- a wrapper given CPU tensors runs the plain version (the CPU tests);
- a wrapper given CUDA tensors launches the kernel or raises — there is
  no fallback;
- ``launches`` counts each kernel's launches, so a run can show that it
  went through the kernel.

Random bits come in two modes, both reproduced exactly by the plain
versions: ``bits="hw"`` is Philox4x32-10 (the counterpart of the TPU's
hardware PRNG; the same bits on the CPU and the card), ``bits="stub"``
is the JAX package's multiply-xorshift test stream at the TPU kernels'
own (program, counter, sublane, lane) coordinates, so the plain versions
can be held against the JAX interpret-mode kernels. Unsigned 32-bit
arithmetic is carried in int64 tensors, with every product split so
nothing overflows.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from scipy import special as sps

from ..utils.rng import uint32_words
from . import _build, lane_groups
from .moves import roll_shifts

# launches of each CUDA kernel since the last reset (plain ints)
launches = {"normal_summary_cost": 0, "fused_sweep": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


_M32 = 0xFFFFFFFF
# float32 constants of _sincos_2pi (pallas_kernels.py:32-43)
_HALF_PI = float(np.float32(math.pi / 2.0))
_SIN_P = tuple(float(np.float32(v)) for v in (
    1.0, -0.16666652, 0.008332964, -0.00019804755, 2.5981096e-06))
_COS_P = tuple(float(np.float32(v)) for v in (
    0.99999994, -0.49999925, 0.04166409, -0.0013857422, 2.3237642e-05))
# Philox4x32-10 multipliers and Weyl key increments
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
# Philox streams (third counter word), as in csrc/flagship.cu
STREAM_COST, STREAM_SWEEP_WALKER, STREAM_SWEEP_SIM = 0, 1, 2
# elements per plain-version slab: bounds its memory at any population
_SLAB = 1 << 22


# ---------------------------------------------------------------------------
# shared helpers (plain versions of the device functions)
# ---------------------------------------------------------------------------

def _mul32(a, c: int):
    """Low 32 bits of ``a * c`` for uint32 values ``a`` (int or int64
    tensor) and a constant ``c``, without int64 overflow."""
    if isinstance(a, int):
        return (a * c) & _M32
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mulhilo32(a, c: int):
    """(high, low) 32-bit halves of the 64-bit product ``a * c``."""
    lo16 = a * (c & 0xFFFF)
    hi16 = a * (c >> 16)
    mid = lo16 + ((hi16 & 0xFFFF) << 16)
    return (hi16 >> 16) + (mid >> 32), mid & _M32


def stub_bits(pid, seed, ctr, sub, lane):
    """The JAX package's ``_stub_bits`` uint32 stream (pallas_kernels.py
    :76-110) at explicit coordinates; arguments broadcast."""
    x = _mul32(sub, 0x9E3779B9) ^ _mul32(lane, 0x85EBCA6B)
    x = x ^ _mul32(pid, 0xC2B2AE35)
    x = x ^ ((seed + _mul32(ctr, 0x27D4EB2F)) & _M32)
    for shift in (15, 13, 16):
        x = _mul32(x, 0x2C1B3C6D)
        x = x ^ (x >> shift)
    return x


def philox4x32_10(c0, c1, c2, c3, k0, k1=0):
    """Philox4x32-10 over broadcastable uint32 counters; returns the four
    output words. Bit-identical to ``philox4x32_10`` in flagship.cu."""
    ref = next(v for v in (c0, c1, c2, c3, k0) if torch.is_tensor(v))
    c = [v if torch.is_tensor(v) else torch.full_like(ref, v)
         for v in (c0, c1, c2, c3)]
    c0, c1, c2, c3 = torch.broadcast_tensors(*c)
    for _ in range(10):
        hi0, lo0 = _mulhilo32(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo32(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _M32
        k1 = (k1 + _PHILOX_W1) & _M32
    return c0, c1, c2, c3


def to_unit(b):
    """uint32 -> U[0, 1) float32 by the [1, 2) mantissa trick."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def sincos_2pi(t):
    """(cos(2 pi t), sin(2 pi t)) for t in [0, 1): the quadrant reduction
    and polynomials of ``_sincos_2pi`` (pallas_kernels.py:46-66)."""
    t4 = 4.0 * t
    q = torch.floor(t4)
    x = (t4 - q) * _HALF_PI
    z = x * x
    s = torch.full_like(z, _SIN_P[4])
    for c in _SIN_P[3::-1]:
        s = s * z + c
    s = s * x
    cp = torch.full_like(z, _COS_P[4])
    for c in _COS_P[3::-1]:
        cp = cp * z + c
    odd = (q == 1.0) | (q == 3.0)
    neg_sin = q >= 2.0
    cosv = torch.where(odd, s, cp)
    sinv = torch.where(odd, cp, s)
    cosv = torch.where(odd != neg_sin, -cosv, cosv)
    sinv = torch.where(neg_sin, -sinv, sinv)
    return cosv, sinv


def _box_muller(b1, b2):
    r = torch.sqrt(-2.0 * torch.log1p(-to_unit(b1)))
    cv, sv = sincos_2pi(to_unit(b2))
    return r * cv, r * sv


def plan_tiles(n: int, block: int, walker_tiles: int):
    """Padded walker count and walker tiles per program of the TPU
    ``normal_summary_cost`` grid (pallas_kernels.py:113-128): the stub
    stream's coordinates depend on them."""
    npad = -(-n // block) * block
    npad = 1 << (npad - 1).bit_length()
    npad = max(npad, block)
    npad = -(-npad // block) * block
    wt = max(1, min(walker_tiles, npad // block))
    while (npad // block) % wt:
        wt -= 1
    return npad, wt


def _moments_stub(seed, pid, ctr0, sub, ndraws, chunk):
    """z-moment sums of the stub stream in the TPU kernels' order (see
    ``moments_stub`` in moments.cuh). ``pid``, ``ctr0``, ``sub``: [n]."""
    n = pid.shape[0]
    nchunks = -(-ndraws // (2 * chunk))
    lane = torch.arange(chunk, device=pid.device)
    s1 = torch.zeros(n, dtype=torch.float32, device=pid.device)
    s2 = torch.zeros_like(s1)
    step = max(1, _SLAB // chunk)
    for w0 in range(0, n, step):
        sl = slice(w0, min(n, w0 + step))
        p, c0, sb = pid[sl, None], ctr0[sl, None], sub[sl, None]
        for j in range(nchunks):
            za, zb = _box_muller(
                stub_bits(p, seed, c0 + 2 * j, sb, lane),
                stub_bits(p, seed, c0 + 2 * j + 1, sb, lane))
            for zh, start in ((za, 2 * j * chunk), (zb, (2 * j + 1) * chunk)):
                if start >= ndraws:
                    continue
                zh = torch.where(start + lane < ndraws, zh, 0.0)
                s1[sl] = s1[sl] + zh.sum(1)
                s2[sl] = s2[sl] + (zh * zh).sum(1)
    return s1, s2


def _moments_philox(seed, stream, n, ndraws, device, walker0=0):
    """z-moment sums of Philox draws (see ``moments_philox`` in
    moments.cuh): group q gives draws 4q .. 4q+3; walkers are numbered
    from ``walker0``."""
    ngroups = -(-ndraws // 4)
    walker = walker0 + torch.arange(n, device=device)
    s1 = torch.zeros(n, dtype=torch.float32, device=device)
    s2 = torch.zeros_like(s1)
    gstep = min(ngroups, max(1, _SLAB // (4 * max(n, 1))))
    wstep = max(1, _SLAB // (4 * gstep))
    for w0 in range(0, n, wstep):
        sl = slice(w0, min(n, w0 + wstep))
        for g0 in range(0, ngroups, gstep):
            q = torch.arange(g0, min(ngroups, g0 + gstep), device=device)
            x0, x1, x2, x3 = philox4x32_10(q[None, :], walker[sl, None],
                                           stream, 0, seed)
            za, zb = _box_muller(x0, x1)
            zc, zd = _box_muller(x2, x3)
            z = torch.stack((za, zb, zc, zd), dim=2).flatten(1)
            idx = 4 * g0 + torch.arange(z.shape[1], device=device)
            z = torch.where(idx < ndraws, z, 0.0)
            s1[sl] = s1[sl] + z.sum(1)
            s2[sl] = s2[sl] + (z * z).sum(1)
    return s1, s2


def _summary_cost(mu, sg, s1, s2, ndraws, target_mu, target_sd, sd_weight):
    inv_n = float(np.float32(1.0 / ndraws))
    mz = s1 * inv_n
    vz = s2 * inv_n - mz * mz
    d1 = (mu + sg * mz) - float(np.float32(target_mu))
    d2 = (sg * torch.sqrt(torch.clamp(vz, min=0.0))
          - float(np.float32(target_sd))) * float(np.float32(sd_weight))
    return torch.sqrt(d1 * d1 + d2 * d2)


def _seed_tensor(seed, device):
    """A uint32 seed as a one-element int64 tensor on ``device`` (the
    kernels read it from device memory, so drawing it costs no sync)."""
    if torch.is_tensor(seed):
        return seed.to(device=device, dtype=torch.int64).reshape(1)
    return torch.tensor([int(seed) & _M32], dtype=torch.int64, device=device)


def _check_vectors(n, **tensors):
    dev = None
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.dim() != 1 or t.shape[0] != n:
            raise ValueError(
                f"{name} must be a float32 vector of length {n}, got "
                f"{t.dtype} of shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_bits(bits, block, chunk):
    if bits not in ("hw", "stub"):
        raise ValueError(f"bits must be 'hw' or 'stub', got {bits!r}")
    if bits == "stub" and (block % 128 or chunk < 1):
        raise ValueError(
            f"stub bits need block a multiple of 128 and chunk >= 1, got "
            f"block={block}, chunk={chunk}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# kernel 1: normal_summary_cost
# ---------------------------------------------------------------------------

def normal_summary_cost_plain(mu, sigma, seed, *, ndraws=1000,
                              target_mu=2.0, target_sd=0.04, sd_weight=50.0,
                              block=1024, chunk=512, bits="hw",
                              walker_tiles=8):
    """Plain PyTorch version of ``kt_normal_summary_cost``."""
    n = mu.shape[0]
    seed = _seed_tensor(seed, mu.device)
    if bits == "stub":
        _, wt = plan_tiles(n, block, walker_tiles)
        nchunks = -(-ndraws // (2 * chunk))
        w = torch.arange(n, device=mu.device)
        s1, s2 = _moments_stub(seed, w // (wt * block),
                               2 * ((w // block) % wt) * nchunks, w % block,
                               ndraws, chunk)
    else:
        s1, s2 = _moments_philox(seed, STREAM_COST, n, ndraws, mu.device)
    return _summary_cost(mu, sigma, s1, s2, ndraws, target_mu, target_sd,
                         sd_weight)


def normal_summary_cost(mu, sigma, seed, *, ndraws: int = 1000,
                        target_mu: float = 2.0, target_sd: float = 0.04,
                        sd_weight: float = 50.0, block: int = 1024,
                        chunk: int = 512, bits: str = "hw",
                        walker_tiles: int = 8):
    """Batched README-model cost: per walker, ``ndraws`` N(0,1) draws by
    two-sided Box-Muller, then ``hypot(mu + sigma*mean_z - target_mu,
    (sigma*sd_z - target_sd) * sd_weight)``.

    mu, sigma: [n] float32 on one device; seed: uint32 int or a
    one-element integer tensor. ``block``, ``chunk`` and
    ``walker_tiles`` only place the stub stream (``bits="stub"``).
    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    n = mu.shape[0]
    dev = _check_vectors(n, mu=mu, sigma=sigma)
    _check_bits(bits, block, chunk)
    kw = dict(ndraws=ndraws, target_mu=target_mu, target_sd=target_sd,
              sd_weight=sd_weight, block=block, chunk=chunk, bits=bits,
              walker_tiles=walker_tiles)
    if dev.type == "cpu":
        return normal_summary_cost_plain(mu, sigma, seed, **kw)
    out = torch.empty_like(mu)
    launch_normal_summary_cost(n, mu, sigma, _seed_tensor(seed, dev), out,
                               **kw)
    launches["normal_summary_cost"] += 1
    return out


def launch_normal_summary_cost(n, mu, sigma, seed, out, *, ndraws,
                               target_mu, target_sd, sd_weight, block, chunk,
                               bits, walker_tiles):
    """Launch ``kt_normal_summary_cost`` over the first ``n`` walkers of
    already-checked CUDA buffers; raises on a launch error."""
    lib = _build.load()
    wt = plan_tiles(n, block, walker_tiles)[1] if bits == "stub" else 1
    err = lib.kt_normal_summary_cost(
        mu.data_ptr(), sigma.data_ptr(), seed.data_ptr(), out.data_ptr(), n,
        ndraws, float(np.float32(1.0 / ndraws)), target_mu, target_sd,
        sd_weight, int(bits == "stub"), block, chunk, wt, _stream())
    _build.check(lib, err, "normal_summary_cost")


def make_flagship_cost_batched(ndraws: int = 1000, target_mu: float = 2.0,
                               target_sd: float = 0.04,
                               sd_weight: float = 50.0):
    """Batched flagship cost ``(thetas, gen) -> costs[n]`` for
    ``smc(..., cost_vectorized=True)``: one uint32 seed per call is drawn
    from ``gen`` on its device, and the cost runs where the thetas lie
    (the CUDA kernel on the card, the plain version on the CPU), always
    on the Philox stream. Unlike the JAX package, nothing switches
    random streams by device. ``batched.seeded(thetas, seed)`` takes the
    seed instead (``shard_batched_cost`` folds the shard into it)."""

    def seeded(thetas, seed):
        mu, sigma = thetas
        return normal_summary_cost(
            mu.to(torch.float32).contiguous(),
            sigma.to(torch.float32).contiguous(), seed,
            ndraws=ndraws, target_mu=target_mu, target_sd=target_sd,
            sd_weight=sd_weight)

    def batched(thetas, gen):
        return seeded(thetas, uint32_words(gen, 1))

    batched.seeded = seeded
    return batched


# ---------------------------------------------------------------------------
# kernel 2: the fused flagship sweep
# ---------------------------------------------------------------------------

def fused_sweep_constants(*, max_stretch, mu_lo, mu_hi, sg_sigma, sg_lo,
                          sg_hi):
    """Host constants of the fused sweep's proposal and prior, computed as
    the JAX package does (pallas_kernels.py:325-337)."""
    zlo = (sg_lo - 0.0) / sg_sigma
    zhi = (sg_hi - 0.0) / sg_sigma
    mass = float(sps.ndtr(zhi) - sps.ndtr(zlo))
    tn_const = np.float32(
        -math.log(sg_sigma) - 0.5 * math.log(2 * math.pi) - math.log(mass))
    lp_mu = np.float32(-math.log(mu_hi - mu_lo))
    return dict(
        inv_sqrt_d=float(np.float32(max_stretch / math.sqrt(2.0))),
        lp_const=float(lp_mu + tn_const),
        half_inv_var=float(np.float32(0.5 / (sg_sigma * sg_sigma))),
        mu_lo=float(np.float32(mu_lo)), mu_hi=float(np.float32(mu_hi)),
        sg_lo=float(np.float32(sg_lo)), sg_hi=float(np.float32(sg_hi)))


def fused_sweep_plain(mu, sg, dmu, dsg, xs, lps, eps, seed, *, consts,
                      ndraws, target_mu, target_sd, sd_weight, block, chunk,
                      bits):
    """Plain PyTorch version of ``kt_fused_sweep``; returns
    ``(omu, osg, oxs, olps, commit)``."""
    n = mu.shape[0]
    dev = mu.device
    seed = _seed_tensor(seed, dev)
    pmu, psg, lpp, gate1 = fused_sweep_proposal_plain(
        mu, sg, dmu, dsg, lps, seed, consts=consts, block=block, bits=bits)
    w = torch.arange(n, device=dev)
    pid = w // block
    if bits == "stub":
        s1, s2 = _moments_stub(seed, pid, torch.zeros_like(w), w % block,
                               ndraws, chunk)
    else:
        s1, s2 = _moments_philox(seed, STREAM_SWEEP_SIM, n, ndraws, dev)
    xp = _summary_cost(pmu, psg, s1, s2, ndraws, target_mu, target_sd,
                       sd_weight)
    eps = torch.as_tensor(eps, dtype=torch.float32, device=dev)
    commit = gate1 & (xp < eps)
    return (torch.where(commit, pmu, mu), torch.where(commit, psg, sg),
            torch.where(commit, xp, xs), torch.where(commit, lpp, lps),
            commit)


def fused_sweep_proposal_plain(mu, sg, dmu, dsg, lps, seed, *, consts,
                               block, bits):
    """The fused sweep's steps before the simulator, in plain PyTorch:
    the proposal, the prior logpdf and gate 1. Returns ``(pmu, psg, lpp,
    gate1)``; the mask says which walkers' outputs depend on the
    simulation."""
    n = mu.shape[0]
    dev = mu.device
    seed = _seed_tensor(seed, dev)
    w = torch.arange(n, device=dev)
    pid = w // block
    if bits == "stub":
        csub, clane = (w % block) // 128, w % 128
        bu1, bu2, bu3 = (stub_bits(pid, seed, c, csub, clane)
                         for c in (10_000, 10_001, 10_002))
    else:
        bu1, bu2, bu3, _ = philox4x32_10(0, w, STREAM_SWEEP_WALKER, 0, seed)
    z = torch.sqrt(-2.0 * torch.log1p(-to_unit(bu1))) \
        * sincos_2pi(to_unit(bu2))[0]
    wv = z * consts["inv_sqrt_d"]
    lprob = torch.log1p(-to_unit(bu3))
    pmu = mu + dmu * wv
    psg = sg + dsg * wv
    inside = ((pmu >= consts["mu_lo"]) & (pmu <= consts["mu_hi"])
              & (psg >= consts["sg_lo"]) & (psg <= consts["sg_hi"]))
    lpp = torch.where(inside,
                      consts["lp_const"] - psg * psg * consts["half_inv_var"],
                      float("-inf"))
    gate1 = inside & (lprob < torch.clamp(lpp - lps, max=0.0))
    return pmu, psg, lpp, gate1


def _sweep_kw(ndraws, target_mu, target_sd, sd_weight, block, chunk, bits):
    return dict(ndraws=ndraws, target_mu=target_mu, target_sd=target_sd,
                sd_weight=sd_weight, block=block, chunk=chunk, bits=bits)


def fused_sweep(mu, sg, dmu, dsg, xs, lps, eps, seed, *, ndraws=1000,
                target_mu=2.0, target_sd=0.04, sd_weight=50.0,
                max_stretch=2.0, mu_lo=1.0, mu_hi=3.0, sg_sigma=0.05,
                sg_lo=0.0, sg_hi=100.0, block=2048, chunk=512, bits="hw"):
    """One fused smc rejuvenation sweep of the flagship model in the JAX
    kernel's form (``_fused_sweep_call``): per walker, the proposal
    ``theta + dtheta*w`` with ``w ~ N(0,1) * max_stretch/sqrt(2)``, the
    Uniform x TruncatedNormal prior logpdf, the prior-only MH gate on log
    u, the simulator, and a commit where the gate passed and the cost is
    below ``eps``.

    ``dmu``/``dsg`` are the partner differences (two rolls, made by the
    caller). Returns ``(omu, osg, oxs, olps, commit)``; outputs of
    walkers that do not commit equal their inputs bit for bit. CPU
    tensors only (the plain version): the kernel takes the step's raw
    words and makes the partner differences itself, so on the card the
    sweep is ``fused_sweep_words``.
    """
    n = mu.shape[0]
    dev = _check_vectors(n, mu=mu, sg=sg, dmu=dmu, dsg=dsg, xs=xs, lps=lps)
    _check_bits(bits, block, chunk)
    if dev.type != "cpu":
        raise ValueError(
            "fused_sweep takes partner differences and runs on the CPU; "
            "on the card the kernel derives them from the step's words: "
            "call fused_sweep_words")
    consts = fused_sweep_constants(max_stretch=max_stretch, mu_lo=mu_lo,
                                   mu_hi=mu_hi, sg_sigma=sg_sigma,
                                   sg_lo=sg_lo, sg_hi=sg_hi)
    return fused_sweep_plain(
        mu, sg, dmu, dsg, xs, lps, eps, seed, consts=consts,
        **_sweep_kw(ndraws, target_mu, target_sd, sd_weight, block, chunk,
                    bits))


def sweep_partners(mu, sg, words):
    """The partner differences of a step's two shift words: ``roll(x,
    r2) - roll(x, r1)`` with ``roll_shifts``' shifts (a host read of the
    words; the kernel derives them in the card)."""
    r1, r2 = roll_shifts([int(w) for w in words[:2].tolist()], mu.shape[0])
    return (torch.roll(mu, r2) - torch.roll(mu, r1),
            torch.roll(sg, r2) - torch.roll(sg, r1))


def fused_sweep_words(mu, sg, xs, lps, eps, words, *, ndraws=1000,
                      target_mu=2.0, target_sd=0.04, sd_weight=50.0,
                      max_stretch=2.0, mu_lo=1.0, mu_hi=3.0, sg_sigma=0.05,
                      sg_lo=0.0, sg_hi=100.0, block=2048, chunk=512,
                      bits="hw", geometry=None):
    """``fused_sweep`` on the step's raw words: ``words`` int64 [3], two
    uint32 shift words and the seed. The partners are the rolls of
    ``roll_shifts(words[:2], n)`` (``sweep_partners``). CPU tensors run
    the plain version on those rolls; CUDA tensors launch
    ``kt_fused_sweep``, which derives the shifts and the differences
    itself (``words`` and a tensor ``eps`` must lie on the walkers' card;
    a float ``eps`` is passed as an argument). ``geometry``: a
    ``check_sweep_geometry`` result (default ``sweep_geometry``). This is
    the sweep ``make_fused_flagship_sweep`` runs."""
    n = mu.shape[0]
    dev = _check_vectors(n, mu=mu, sg=sg, xs=xs, lps=lps)
    _check_bits(bits, block, chunk)
    if n < 3:
        raise ValueError(f"the fused sweep needs n >= 3 walkers, got {n}")
    if words.dtype != torch.int64 or words.shape != (3,):
        raise ValueError(f"words must be int64 of shape (3,), got "
                         f"{words.dtype} of shape {tuple(words.shape)}")
    consts = fused_sweep_constants(max_stretch=max_stretch, mu_lo=mu_lo,
                                   mu_hi=mu_hi, sg_sigma=sg_sigma,
                                   sg_lo=sg_lo, sg_hi=sg_hi)
    kw = _sweep_kw(ndraws, target_mu, target_sd, sd_weight, block, chunk,
                   bits)
    if dev.type == "cpu":
        dmu, dsg = sweep_partners(mu, sg, words)
        return fused_sweep_plain(mu, sg, dmu, dsg, xs, lps, eps, words[2:],
                                 consts=consts, **kw)
    outs = tuple(torch.empty_like(mu) for _ in range(4)) + (
        torch.empty(n, dtype=torch.bool, device=dev),)
    launch_fused_sweep(n, (mu, sg, xs, lps), outs, eps, words,
                       consts=consts, geometry=geometry, **kw)
    return outs


# as in csrc/flagship.cu: threads a block, walkers a block at most
SWEEP_MAX_THREADS, SWEEP_MAX_WALKERS = 1024, 1024


def check_sweep_geometry(n, walkers, threads):
    """The geometry of a launch of ``kt_fused_sweep`` over ``n`` walkers,
    as a ``lane_groups.Geometry`` of one lane a walker, or ``ValueError``
    for what the kernel cannot take (it returns
    ``cudaErrorInvalidConfiguration``): threads a multiple of 32 in [32,
    ``SWEEP_MAX_THREADS``], 1 to ``SWEEP_MAX_WALKERS`` walkers a block."""
    if threads % 32 or not 32 <= threads <= SWEEP_MAX_THREADS:
        raise ValueError(f"threads must be a multiple of 32 in [32, "
                         f"{SWEEP_MAX_THREADS}], got {threads}")
    if not 1 <= walkers <= SWEEP_MAX_WALKERS:
        raise ValueError(f"walkers per block must be in [1, "
                         f"{SWEEP_MAX_WALKERS}], got {walkers}")
    return lane_groups.Geometry(-(-n // walkers), walkers, threads, 1)


def sweep_geometry(n, sms=lane_groups.H100_SMS):
    """The launch of ``kt_fused_sweep`` over ``n`` walkers on a card of
    ``sms`` SMs: the walkers a block of ``lane_groups.pick`` for a light
    model (about one block an SM, at most 1024 walkers), one thread each.
    At n = 131072 on the H100, 1024 walkers on 1024 threads was the
    fastest of the timed geometries on both the prior (44% pass gate 1)
    and the population after 50 steps of ``fused-sweep`` (67%) (PERF.md
    section 6): every compacted walker of a block then has its thread in
    one pass."""
    walkers = lane_groups.pick(n, sms, light=True)[0]
    return check_sweep_geometry(n, walkers, walkers)


def sweep_consts(consts, *, ndraws, target_mu, target_sd, sd_weight, block,
                 chunk, bits):
    """The float32 and int32 constant arrays ``kt_fused_sweep`` takes."""
    f = np.array([np.float32(1.0 / ndraws), target_mu, target_sd, sd_weight,
                  consts["inv_sqrt_d"], consts["mu_lo"], consts["mu_hi"],
                  consts["sg_lo"], consts["sg_hi"], consts["lp_const"],
                  consts["half_inv_var"]], np.float32)
    i = np.array([ndraws, block, chunk, int(bits == "stub")], np.int32)
    return f, i


def launch_fused_sweep(n, ins, outs, eps, words, *, consts, ndraws,
                       target_mu, target_sd, sd_weight, block, chunk, bits,
                       geometry=None):
    """Launch ``kt_fused_sweep`` over the first ``n`` walkers: ``ins`` =
    (mu, sg, xs, lps), ``outs`` = (omu, osg, oxs, olps, commit)
    already-checked CUDA buffers, ``words`` the step's int64 [3] words
    and ``eps`` a float or a one-element float32 tensor, both on the
    walkers' card; raises on a launch error. Counts one launch."""
    dev = ins[0].device
    if words.device != dev:
        raise ValueError(f"words lie on {words.device}, the walkers on {dev}")
    if torch.is_tensor(eps):
        if eps.device != dev or eps.dtype != torch.float32 or \
                eps.numel() != 1:
            raise ValueError(f"eps must be a float or a one-element float32 "
                             f"tensor on {dev}, got {eps.dtype} on "
                             f"{eps.device}")
        eps_ptr, eps_value = eps.data_ptr(), 0.0
    else:
        eps_ptr, eps_value = None, float(eps)
    g = geometry or sweep_geometry(n, lane_groups.sm_count(dev.index))
    f, i = sweep_consts(consts, ndraws=ndraws, target_mu=target_mu,
                        target_sd=target_sd, sd_weight=sd_weight, block=block,
                        chunk=chunk, bits=bits)
    lib = _build.load()
    err = lib.kt_fused_sweep(
        *(t.data_ptr() for t in ins), eps_ptr, eps_value,
        words.contiguous().data_ptr(), *(t.data_ptr() for t in outs), n,
        f.ctypes.data_as(ctypes.c_void_p), i.ctypes.data_as(ctypes.c_void_p),
        g.walkers, g.threads, _stream())
    _build.check(lib, err, "fused_sweep")
    launches["fused_sweep"] += 1


def make_fused_flagship_sweep(n, *, ndraws: int = 1000,
                              target_mu: float = 2.0, target_sd: float = 0.04,
                              sd_weight: float = 50.0,
                              max_stretch: float = 2.0, mu_lo: float = 1.0,
                              mu_hi: float = 3.0, sg_sigma: float = 0.05,
                              sg_lo: float = 0.0, sg_hi: float = 100.0,
                              block: int = 2048, chunk: int = 512,
                              bits: str = "hw"):
    """Fused one-kernel smc sweep for the flagship model. Returns
    ``step(gen, (mu, sg), xs, lps, eps) -> ((mu, sg), xs, lps, acc)``.
    ``gen`` gives three uint32 words a step, the two rotation shifts'
    words and the kernel seed; the step is ``fused_sweep_words`` on them:
    on the card one draw of words and one launch, nothing read on the
    host. ``eps`` a float or a one-element float32 tensor on the walkers'
    device. There is no ``alive`` or ``flag``: this step is not an
    ``smc(sweep_fused=)`` sweep."""
    if n < 3:
        raise ValueError(f"the fused sweep needs n >= 3 walkers, got {n}")
    kw = dict(ndraws=ndraws, target_mu=target_mu, target_sd=target_sd,
              sd_weight=sd_weight, max_stretch=max_stretch, mu_lo=mu_lo,
              mu_hi=mu_hi, sg_sigma=sg_sigma, sg_lo=sg_lo, sg_hi=sg_hi,
              block=block, chunk=chunk, bits=bits)

    def step(gen, thetas, xs, lps, eps):
        mu, sg = thetas
        words = uint32_words(gen, 3).to(mu.device)
        omu, osg, oxs, olps, commit = fused_sweep_words(
            mu, sg, xs, lps, eps, words, **kw)
        return (omu, osg), oxs, olps, commit.sum()

    return step


# ---------------------------------------------------------------------------
# work counts for the bound of each kernel (used by chip_smoke.py)
# ---------------------------------------------------------------------------

# arithmetic operations per draw, counting a transcendental (log1p, sqrt)
# as one: half a Philox4x32-10 call (100 integer ops per four words, i.e.
# 25 per word and two words per Box-Muller pair) = 25, the mantissa trick
# 3, r = sqrt(-2 log1p(-u)) 4 per pair, sincos 26 per pair, r*c 1, and
# the two moment sums 3
OPS_PER_DRAW = 25 + 3 + 4 / 2 + 26 / 2 + 1 + 3
# per-walker work of the sweep outside the simulator: three words of one
# Philox call, the proposal scale, the proposal, the prior and the gates
OPS_PER_SWEEP_WALKER = 100 + 9 + 4 + 26 + 2 + 4 + 10 + 8 + 6


def normal_summary_cost_work(n, ndraws):
    """(bytes, operations) the cost must move and do: mu, sigma and the
    seed read once, the costs written once."""
    return 12 * n + 8, n * (ndraws * OPS_PER_DRAW + 12)


def fused_sweep_work(n, ndraws, nsim=None):
    """(bytes, operations) of one fused sweep over ``n`` walkers of which
    ``nsim`` (default all) pass gate 1: six [n] float32 inputs, eps and
    the seed read once, four [n] float32 outputs and the [n] commit mask
    written once. Every walker costs the proposal, the prior and the
    gates; only a walker that passes gate 1 needs the simulator and the
    cost, since no output of any other walker depends on them."""
    nsim = n if nsim is None else nsim
    return 41 * n + 12, (n * OPS_PER_SWEEP_WALKER
                         + nsim * (ndraws * OPS_PER_DRAW + 12))
