"""The fused AIS sweeps — the PyTorch counterparts of three Pallas TPU
kernels of ``kissabc_tpu/ops/pallas_kernels.py``:

- ``make_fused_flagship_ais_sweep`` (``_fused_ais_half_call``,
  pallas_call at :692): one kernel per red/black half-update of the
  flagship model, ``kt_fused_ais_half`` (``csrc/ais.cu``);
- ``make_fused_flagship_ais_sweep_onekernel`` (``_fused_ais_full_call``,
  pallas_call at :1022): both halves in one cooperative launch,
  ``kt_fused_ais_full`` (``csrc/ais.cu``); each block of #7 and #8
  compacts its walkers inside the prior (about one block an SM,
  ``flagship_geometry``), and the kernels derive the partner shifts from
  the raw words themselves;
- ``make_fused_ais_sweep`` (``half_call``, pallas_call at :1440): the
  generic half-update with the user's prior, ``draw``, ``stats`` and
  ``reduce_cost`` compiled in by ``ops/codegen.py``,
  ``kt_fused_ais_sweep`` (``csrc/generic.cuh``); each block compacts
  its walkers inside the prior and gives each a group of lanes that
  share its draws (``ops/lane_groups.py``).

Per walker of the updated half each kernel makes the 4:2:1 stretch /
DE / walk proposal against six partners ``comp[(i + r_j) % h]`` of the
complementary half (the rotations of ``_rot_shifts6``), pushes it, takes
the prior's logpdf, runs the simulator where the prior is finite, and
accepts by the kernelized MH rule on ``lp + ll``; the raw proposal is
committed. Beside each kernel is its plain PyTorch version, which
repeats its arithmetic (the int64-emulated uint32 stub and Philox bits of
``ops/kernels.py``):

- a wrapper given CPU tensors runs the plain version;
- a wrapper given CUDA tensors launches the kernel or raises;
- ``launches`` counts each kernel's launches.

The sweeps' words (shifts and seeds) are drawn on the generator's
device, so a sweep reads nothing on the host; every kernel here (and #9,
``ops/fused_tempered.py``) takes the raw words and derives the shifts by
``rot_shifts6``'s rule in the kernel, so a sweep issues one draw of words
and one launch a half (#6, #7, #9), or one of each a sweep (#8). The plain
versions take the shifts that ``rot_shifts6`` makes of the same words.
``bits="stub"`` replays the TPU
kernels' stub stream at their coordinates (see ``csrc/ais.cu`` and
``csrc/generic.cuh``); ``bits="hw"`` is Philox4x32-10.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..parallel import layout as L
from ..parallel import mesh as M
from ..utils.logging import register_counters, span
from ..utils.rng import uint32_words
from . import _build, codegen, lane_groups
from .kernels import (OPS_PER_DRAW, _box_muller, _check_bits, _moments_philox,
                      _moments_stub, _seed_tensor, _stream, _summary_cost,
                      fused_sweep_constants, philox4x32_10, plan_tiles,
                      stub_bits, to_unit)
from .moves import _distinct_shifts
from .streaming import (NOISE_OPS, leaves_of, streaming_moment_cost_plain,
                        tree_of, validate)

# launches of each CUDA kernel since the last reset (plain ints), registered
# with the counters that each span records (utils/logging.py)
launches = register_counters("launches.", {
    "fused_ais_half": 0, "fused_ais_full": 0, "fused_ais_sweep": 0})

# as in csrc/ais.cu: threads a block, walkers a block at most
AIS_MAX_THREADS, AIS_MAX_WALKERS = 512, 1024

# Philox streams (third counter word), as in csrc/ais.cu and generic.cuh
STREAM_AIS_WALKER, STREAM_AIS_SIM = 6, 7
STREAM_GEN_AIS_WALKER, STREAM_GEN_AIS_SIM = 8, 9
_NEG_INF = float("-inf")
# per-walker operations outside the simulator of the flagship sweeps:
# three Philox calls (300), four mantissa tricks (12), three Box-Muller
# pairs (3 x 34), the move constants (z, corr, gamma: 8), the proposal of
# two leaves (2 x 24), the prior (10) and the accept and commit (14)
AIS_OPS_PER_WALKER = 300 + 12 + 102 + 8 + 48 + 10 + 14
# the generic sweep: per word 25 (a quarter Philox call) and 3, per
# normal pair 34, the move constants 8, per leaf the proposal 24 and the
# commit 1, the accept 14
GEN_AIS_OPS_PER_WORD, GEN_AIS_OPS_PER_PAIR = 28, 34


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def rot_shifts6(words, h):
    """Six rotation shifts from six uint32 words, distinct within each
    move (stretch s1; DE d1 != d2; walk w1, w2, w3 distinct): the rule of
    ``_rot_shifts6`` (pallas_kernels.py:1116-1135), as an int64 tensor on
    the words' device."""
    return torch.stack(_distinct_shifts(words, h, (1, 2, 3)))


def _f32(x):
    return float(np.float32(x))


def move_constants(a_stretch, d):
    """float32 constants of the fused kernels' moves, rounded from double
    as the JAX kernels round them: (g_lo, g_span, de_scale, inv300,
    third, p_s_hi, p_d_hi)."""
    sa = math.sqrt(a_stretch)
    return (_f32(1.0 / sa), _f32(sa - 1.0 / sa), _f32(2.38 / math.sqrt(2 * d)),
            _f32(1.0 / 300.0), _f32(1.0 / 3.0), _f32(4.0 / 7.0),
            _f32(6.0 / 7.0))


def _walker_words(bits, seed, count, *, pid, cbase, sub, lane, stream,
                  walker):
    """``count`` uint32 words per walker: the stub stream at counters
    ``cbase + k``, or Philox words k from counter ``(k // 4, walker,
    stream, 0)``."""
    if bits == "stub":
        return [stub_bits(pid, seed, cbase + k, sub, lane)
                for k in range(count)]
    words = []
    for g in range(-(-count // 4)):
        words.extend(philox4x32_10(g, walker, stream, 0, seed))
    return words[:count]


def _mixture_setup(words, d, mc):
    """The per-walker move quantities of the fused kernels from their
    words ``(move, stretch z, accept, [normal pair words])``: (is_s, is_d,
    z, corr, gamma, normals, u_acc). The normals come in pair order: the
    DE gamma's first, then the jitters and the walk weights."""
    w_mid, w_z, w_acc, pair_words = words
    g_lo, g_span, dscale, _, _, p_s_hi, p_d_hi = mc
    u_mid, u_z = to_unit(w_mid), to_unit(w_z)
    normals = []
    for b1, b2 in pair_words:
        normals.extend(_box_muller(b1, b2))
    is_s = u_mid < p_s_hi
    is_d = (u_mid >= p_s_hi) & (u_mid < p_d_hi)
    zroot = u_z * g_span + g_lo
    corr = torch.where(is_s, _f32(2 * (d - 1)) * torch.log(zroot), 0.0)
    gamma = dscale * torch.exp(0.1 * normals[0])
    return is_s, is_d, zroot * zroot, corr, gamma, normals, to_unit(w_acc)


def _propose(is_s, is_d, z, gamma, r, nz, xi, p, mc):
    """One leaf's mixture proposal, in the kernels' operation order.
    ``p``: the stretch partner, the DE pair and the walk triple."""
    inv300, third = mc[3], mc[4]
    p_s = p[0] + z * (xi - p[0])
    tri = torch.abs(p[1] - p[2]) + torch.abs(xi - p[2]) + torch.abs(p[1] - xi)
    p_d = xi + gamma * (p[1] - p[2]) + gamma * tri * inv300 * nz
    cen = (p[3] + p[4] + p[5]) * third
    p_w = xi + (r[0] * (p[3] - cen) + r[1] * (p[4] - cen)
                + r[2] * (p[5] - cen))
    return torch.where(is_s, p_s, torch.where(is_d, p_d, p_w))


def _rolled(comp, shifts):
    """``comp[(i + r_j) % h]`` for the six shifts (``jnp.roll(comp,
    -r_j)``)."""
    h = comp.shape[0]
    pos = torch.arange(h, device=comp.device)
    return [comp[torch.remainder(pos + r, h)] for r in shifts]


def _accept(corr, lpp, llp, lp, ll, valid, u_acc):
    """The kernelized MH accept on ``lp + ll``: (commit mask, margin).
    The margin is the log-ratio less the accept draw; a walker inside
    the prior commits where it is >= 0."""
    lw = corr + (lpp + llp) - (lp + ll)
    logu = torch.log1p(-u_acc)
    return valid & (logu <= lw), lw - logu


def _kernelized_ll(valid, cost, lpp, inv_scale):
    return torch.where(valid, -0.5 * torch.square(cost * inv_scale), lpp)


# ---------------------------------------------------------------------------
# kernels #7 and #8: the flagship model
# ---------------------------------------------------------------------------

class FlagshipAIS:
    """The flagship model's constants and the per-walker update shared by
    the half (#7) and one-launch (#8) sweeps."""

    def __init__(self, *, scale, ndraws, target_mu, target_sd, sd_weight,
                 a_stretch, mu_lo, mu_hi, sg_sigma, sg_lo, sg_hi, block,
                 chunk, bits):
        _check_bits(bits, block, chunk)
        self.ndraws, self.block, self.chunk, self.bits = (ndraws, block,
                                                          chunk, bits)
        self.target = (target_mu, target_sd, sd_weight)
        self.prior = fused_sweep_constants(
            max_stretch=2.0, mu_lo=mu_lo, mu_hi=mu_hi, sg_sigma=sg_sigma,
            sg_lo=sg_lo, sg_hi=sg_hi)
        self.mc = move_constants(a_stretch, 2)
        self.inv_scale = _f32(1.0 / scale)
        p = self.prior
        self.fconsts = np.array(
            [_f32(1.0 / ndraws), _f32(target_mu), _f32(target_sd),
             _f32(sd_weight), *self.mc, self.inv_scale, p["mu_lo"],
             p["mu_hi"], p["sg_lo"], p["sg_hi"], p["lp_const"],
             p["half_inv_var"]], np.float32)
        self.iconsts = np.array([ndraws, chunk, block, int(bits == "stub")],
                                np.int32)

    def _consts(self):
        return (self.fconsts.ctypes.data_as(ctypes.c_void_p),
                self.iconsts.ctypes.data_as(ctypes.c_void_p))

    def update_plain(self, mu, sg, lp, ll, cmu, csg, shifts, seed, *, pid,
                     cbase, sub, lane, walker, sim):
        """The plain per-walker update of one half: ``sim`` gives the
        z-moment sums ``(s1, s2)``. Returns (mu, sg, lp, ll, inside,
        margin): the mask says which walkers proposed inside the prior
        (the walkers the kernel simulates), ``margin`` is the MH
        log-ratio less the accept draw (a walker commits where it is >= 0
        and inside)."""
        words = _walker_words(self.bits, seed, 9, pid=pid, cbase=cbase,
                              sub=sub, lane=lane, stream=STREAM_AIS_WALKER,
                              walker=walker)
        is_s, is_d, z, corr, gamma, nrm, u_acc = _mixture_setup(
            (words[0], words[1], words[8],
             [(words[2], words[3]), (words[4], words[5]),
              (words[6], words[7])]), 2, self.mc)
        gam_n, nz_mu, nz_sg, r1, r2, r3 = nrm
        del gam_n
        r = (r1, r2, r3)
        pmu = _propose(is_s, is_d, z, gamma, r, nz_mu, mu,
                       _rolled(cmu, shifts), self.mc)
        psg = _propose(is_s, is_d, z, gamma, r, nz_sg, sg,
                       _rolled(csg, shifts), self.mc)
        p = self.prior
        inside = ((pmu >= p["mu_lo"]) & (pmu <= p["mu_hi"])
                  & (psg >= p["sg_lo"]) & (psg <= p["sg_hi"]))
        lpp = torch.where(inside, p["lp_const"] - psg * psg
                          * p["half_inv_var"], _NEG_INF)
        s1, s2 = sim()
        cost = _summary_cost(pmu, psg, s1, s2, self.ndraws, *self.target)
        llp = _kernelized_ll(inside, cost, lpp, self.inv_scale)
        acc, margin = _accept(corr, lpp, llp, lp, ll, inside, u_acc)
        return (torch.where(acc, pmu, mu), torch.where(acc, psg, sg),
                torch.where(acc, lpp, lp), torch.where(acc, llp, ll), inside,
                margin)

    def half_plain(self, mu, sg, lp, ll, cmu, csg, shifts, seed):
        """Plain version of ``kt_fused_ais_half``: returns (mu, sg, lp,
        ll, inside, margin) of the updated half."""
        h = mu.shape[0]
        seed = _seed_tensor(seed, mu.device)
        i = torch.arange(h, device=mu.device)
        pid = i // self.block

        def sim():
            if self.bits == "stub":
                return _moments_stub(seed, pid, torch.zeros_like(i),
                                     i % self.block, self.ndraws, self.chunk)
            return _moments_philox(seed, STREAM_AIS_SIM, h, self.ndraws,
                                   mu.device)

        return self.update_plain(
            mu, sg, lp, ll, cmu, csg, shifts, seed, pid=pid, cbase=20_000,
            sub=(i % self.block) // 128, lane=i % 128, walker=i, sim=sim)

    def full_plain(self, mu, sg, lp, ll, shifts, seed):
        """Plain version of ``kt_fused_ais_full``: half A against the old
        half B, then half B against the updated half A. Returns full
        ``[n]`` (mu, sg, lp, ll, inside, margin)."""
        n = mu.shape[0]
        h = n // 2
        dev = mu.device
        seed = _seed_tensor(seed, dev)
        i = torch.arange(h, device=dev)
        nchunks = -(-self.ndraws // (2 * self.chunk))
        zero = torch.zeros_like(i)
        out = []
        for half, cbase in ((0, 100_000), (1, 200_000)):
            lo = half * h
            sl = slice(lo, lo + h)
            cmu, csg = ((mu[h:], sg[h:]) if half == 0 else out[0][:2])

            def sim(cbase=cbase, lo=lo):
                if self.bits == "stub":
                    return _moments_stub(
                        seed, zero, cbase + 16 + 2 * (i // self.block)
                        * nchunks, i % self.block, self.ndraws, self.chunk)
                return _moments_philox(seed, STREAM_AIS_SIM, h, self.ndraws,
                                       dev, walker0=lo)

            out.append(self.update_plain(
                mu[sl], sg[sl], lp[sl], ll[sl], cmu, csg,
                shifts[6 * half:6 * half + 6], seed, pid=zero, cbase=cbase,
                sub=i // 128, lane=i % 128, walker=lo + i, sim=sim))
        return tuple(torch.cat([a, b]) for a, b in zip(*out))

    def launch_half(self, ins, comp, words, outs, geometry=None):
        """Launch ``kt_fused_ais_half`` on checked CUDA buffers: ``ins`` =
        (mu, sg, lp, ll) of the updated half, ``comp`` = (mu, sg) of the
        other half, ``words`` int64 [7] (the six raw shift words, then the
        seed), ``outs`` four buffers of the half's length; ``geometry``
        one of ``check_geometry`` (default ``flagship_geometry`` on the
        walkers' card)."""
        h = ins[0].shape[0]
        g = geometry or flagship_geometry(
            h, lane_groups.sm_count(ins[0].device.index))
        lib = _build.load()
        err = lib.kt_fused_ais_half(
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in comp),
            words.data_ptr(), *(t.data_ptr() for t in outs), h,
            *self._consts(), g.walkers, g.threads, _stream())
        _build.check(lib, err, "fused_ais_half")
        launches["fused_ais_half"] += 1

    def launch_full(self, ins, words, outs, geometry=None):
        """Launch ``kt_fused_ais_full`` (one cooperative launch) on checked
        CUDA buffers of length n: ``words`` int64 [13] (half A's six shift
        words, half B's six, the seed); ``geometry`` as ``launch_half``
        takes it."""
        h = ins[0].shape[0] // 2
        g = geometry or flagship_geometry(
            h, lane_groups.sm_count(ins[0].device.index))
        lib = _build.load()
        err = lib.kt_fused_ais_full(
            *(t.data_ptr() for t in ins), words.data_ptr(),
            *(t.data_ptr() for t in outs), h, *self._consts(), g.walkers,
            g.threads, _stream())
        _build.check(lib, err, "fused_ais_full")
        launches["fused_ais_full"] += 1

    def work(self, n, nsim=None):
        """(bytes, operations) of one sweep over ``n`` walkers of which
        ``nsim`` (default all) propose inside the prior: each walker's
        mu, sg, lp and ll read once and written once; the simulator only
        for the walkers inside the prior, since no output of another
        walker depends on it."""
        nsim = n if nsim is None else nsim
        return 32 * n + 104, (n * AIS_OPS_PER_WALKER
                              + nsim * (self.ndraws * OPS_PER_DRAW + 16))


def check_geometry(h, walkers, threads):
    """The geometry of a launch of #7 or #8 over a half of ``h`` walkers,
    as a ``lane_groups.Geometry`` of one lane a walker, or ``ValueError``
    for what the kernels cannot take (they return
    ``cudaErrorInvalidConfiguration``): threads a multiple of 32 in [32,
    ``AIS_MAX_THREADS``], 1 to ``AIS_MAX_WALKERS`` walkers a block."""
    if threads % 32 or not 32 <= threads <= AIS_MAX_THREADS:
        raise ValueError(f"threads must be a multiple of 32 in [32, "
                         f"{AIS_MAX_THREADS}], got {threads}")
    if not 1 <= walkers <= AIS_MAX_WALKERS:
        raise ValueError(f"walkers per block must be in [1, "
                         f"{AIS_MAX_WALKERS}], got {walkers}")
    return lane_groups.Geometry(-(-h // walkers), walkers, threads, 1)


def flagship_geometry(h, sms=lane_groups.H100_SMS):
    """The launch of #7 or #8 over a half of ``h`` walkers on a card of
    ``sms`` SMs: ``lane_groups.pick`` for a light model (the flagship
    draw), whose draws run on one lane a walker, with no more threads than
    walkers. At h = 65536 on the H100: blocks of 512 walkers on 512
    threads, about one an SM."""
    walkers, threads, _ = lane_groups.pick(h, sms, light=True)
    return check_geometry(h, walkers, min(threads, walkers))


def full_grid(h, geometry):
    """(blocks per SM, SMs, grid) of ``kt_fused_ais_full``'s cooperative
    launch for halves of ``h`` walkers at ``geometry`` on the current
    card."""
    lib = _build.load()
    out = (ctypes.c_int * 3)()
    _build.check(lib, lib.kt_fused_ais_full_grid(
        h, geometry.walkers, geometry.threads, out), "fused_ais_full")
    return tuple(out)


def _check_flagship(thetas, lds, n):
    mu, sg = thetas
    lp, ll = lds
    for name, t in (("mu", mu), ("sigma", sg), ("lp", lp), ("ll", ll)):
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"{name} must be a float32 vector of length {n},"
                             f" got {t.dtype} of shape {tuple(t.shape)}")
    devs = {t.device for t in (mu, sg, lp, ll)}
    if len(devs) != 1:
        raise ValueError(f"the sweep's inputs lie on several devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return [t.contiguous() for t in (mu, sg, lp, ll)], dev


def _sweep_words(gen, count, dev):
    """``count`` uint32 words from ``gen``, on the sweep's device ``dev``
    (a generator may live on another device than the walkers)."""
    return uint32_words(gen, count).to(dev)


def make_fused_flagship_ais_sweep(n, *, scale: float = 0.005,
                                  ndraws: int = 1000, target_mu: float = 2.0,
                                  target_sd: float = 0.04,
                                  sd_weight: float = 50.0,
                                  a_stretch: float = 3.0, mu_lo: float = 1.0,
                                  mu_hi: float = 3.0, sg_sigma: float = 0.05,
                                  sg_lo: float = 0.0, sg_hi: float = 100.0,
                                  block: int = 2048, chunk: int = 512,
                                  bits: str = "hw"):
    """Fused AIS red/black sweep of the flagship model with the kernelized
    density: ``sweep(gen, (mu, sg), (lp, ll)) -> ((mu, sg), (lp, ll))``,
    one ``kt_fused_ais_half`` launch per half. Each half draws seven words
    from ``gen``: six partner shifts by ``rot_shifts6``'s rule (which the
    kernel applies to the raw words) and the kernel seed. Outputs are
    fresh tensors; inputs are not written."""
    kw = dict(locals())   # the model's keywords: every argument but n
    del kw["n"]
    if n % 2:
        raise ValueError(
            f"the fused AIS sweep needs an even walker count, got {n} "
            "(the red/black halves must be equal)")
    h = n // 2
    if h < 3:
        raise ValueError("need at least 6 walkers for the fused AIS sweep")
    if block % 128:
        raise ValueError(f"block must be a multiple of 128, got {block}")
    model = FlagshipAIS(**kw)

    def sweep(gen, thetas, lds):
        ins, dev = _check_flagship(thetas, lds, n)
        outs = [torch.empty_like(t) for t in ins]
        for half in (0, 1):
            words = _sweep_words(gen, 7, dev)
            sl, co = (slice(0, h), slice(h, n)) if half == 0 else (
                slice(h, n), slice(0, h))
            comp = [(ins if half == 0 else outs)[k][co] for k in (0, 1)]
            upd = [t[sl] for t in ins]
            if dev.type == "cpu":
                for o, v in zip(outs, model.half_plain(
                        *upd, *comp, rot_shifts6(words[:6], h),
                        words[6:])[:4]):
                    o[sl] = v
            else:
                model.launch_half(upd, comp, words, [o[sl] for o in outs])
        return (outs[0], outs[1]), (outs[2], outs[3])

    sweep.model = model
    return sweep


def make_fused_flagship_ais_sweep_onekernel(
        n, *, scale: float = 0.005, ndraws: int = 1000,
        target_mu: float = 2.0, target_sd: float = 0.04,
        sd_weight: float = 50.0, a_stretch: float = 3.0, mu_lo: float = 1.0,
        mu_hi: float = 3.0, sg_sigma: float = 0.05, sg_lo: float = 0.0,
        sg_hi: float = 100.0, block: int = 1024, chunk: int = 512,
        bits: str = "hw"):
    """The flagship AIS sweep with both halves in one cooperative launch
    (``kt_fused_ais_full``): half B proposes against the updated half A
    after a grid-wide barrier. Thirteen words per sweep from ``gen``: the
    two halves' shift words and the seed. Same contract as
    ``make_fused_flagship_ais_sweep``."""
    kw = dict(locals())
    del kw["n"]
    if n % 2 or (n // 2) % block or n % 256:
        raise ValueError(
            f"one-kernel AIS sweep needs n even, n % 256 == 0 and "
            f"n/2 % block == 0; got n={n}, block={block}")
    if block % 128:
        raise ValueError(f"block must be a multiple of 128, got {block}")
    h = n // 2
    model = FlagshipAIS(**kw)

    def sweep(gen, thetas, lds):
        ins, dev = _check_flagship(thetas, lds, n)
        words = _sweep_words(gen, 13, dev)
        if dev.type == "cpu":
            shifts = torch.cat([rot_shifts6(words[0:6], h),
                                rot_shifts6(words[6:12], h)])
            outs = model.full_plain(*ins, shifts, words[12:])[:4]
        else:
            outs = [torch.empty_like(t) for t in ins]
            model.launch_full(ins, words, outs)
        return (outs[0], outs[1]), (outs[2], outs[3])

    sweep.model = model
    return sweep


# ---------------------------------------------------------------------------
# kernel #6: the generic sweep
# ---------------------------------------------------------------------------

class MixtureHalfSweep:
    """The parts of a red/black half-update that the generic AIS sweep
    (#6) and the tempered sweep (#9, ``ops/fused_tempered.py``) share:
    the prior, the move constants, the stub layout, the leaf checks and
    the plain version of ``mixture_propose`` (``csrc/walkers.cuh``).
    ``walker_stream`` is the Philox stream of the walkers' words and
    ``name`` the public factory, for messages."""

    walker_stream = STREAM_GEN_AIS_WALKER
    name = "make_fused_ais_sweep"

    def __init__(self, prior, *, a_stretch, block, walker_tiles, bits):
        self.prior, self.block = prior, block
        self.walker_tiles, self.bits = walker_tiles, bits
        self.d = prior.nparams
        self.structure = codegen.prior_marginals(prior)[1]
        self.mc = move_constants(a_stretch, self.d)
        self.npairs = -(-(self.d + 4) // 2)

    def _sb_rows(self, h):
        return plan_tiles(h, self.block, self.walker_tiles)[1] * self.block

    @staticmethod
    def _draws(gen):
        """A half-update's one draw from ``gen``: seven uint32 words, six
        from which the kernel derives the partner shifts by
        ``rot_shifts6``'s rule, and the kernel seed."""
        return uint32_words(gen, 7)

    def _device_words(self, words, dev):
        """A half's seven words as a contiguous int64 vector on ``dev``."""
        if not (torch.is_tensor(words) and words.device == dev
                and words.dtype == torch.int64):
            words = torch.as_tensor(words, device=dev).to(torch.int64)
        if words.shape != (7,):
            raise ValueError(f"{self.name}: a half-update takes seven "
                             f"words, got shape {tuple(words.shape)}")
        return words.contiguous()

    def _cpu_only(self, dev):
        """Given shifts run the plain version only: the kernel takes
        words."""
        if dev.type != "cpu":
            raise ValueError(
                f"{self.name}: given shifts run on the CPU only; on {dev} "
                "the kernel derives them from the half's words "
                "(half_words)")

    def _check_leaves(self, leaves, what):
        if any(x.dim() != 1 for x in leaves):
            raise ValueError(
                f"{self.name} expects per-walker scalar parameters "
                f"([n] leaves); got {what} shapes "
                f"{[tuple(x.shape) for x in leaves]}")
        if len(leaves) != self.d:
            raise ValueError(
                f"prior has {self.d} scalar marginals but thetas has "
                f"{len(leaves)} leaves")

    @staticmethod
    def _shard_words(seed, dev):
        """A shard's seven words for the partners-given form: six unread
        shift words, then the shard's seed (int64 on ``dev``)."""
        seed = torch.as_tensor(seed).to(dev, torch.int64).reshape(1)
        return torch.cat([torch.zeros(6, dtype=torch.int64, device=dev),
                          seed])

    def _sharded_halves(self, th, ld):
        """The halves and their (lp, ll) placed on ``self.mesh``, as
        ``Sharded`` leaf tuples: ((leaves a, leaves b), ((lp_a, ll_a),
        (lp_b, ll_b)), structure)."""
        mesh = self.mesh

        def place(t):
            return t if isinstance(t, M.Sharded) else M.place(mesh, t)

        for t in th:
            L.check_divides(t.n if isinstance(t, M.Sharded) else
                            leaves_of(t, self.name)[0][0].shape[0], mesh,
                            "half size {n}")
        tha, thb = place(th[0]), place(th[1])
        (lpa, lla), (lpb, llb) = ld
        structure = leaves_of(tha.shards[0], self.name)[1]
        lva, lvb = (t.map(lambda x: tuple(leaves_of(x, self.name)[0]))
                    for t in (tha, thb))
        self._check_leaves(list(lva.shards[0]), "half-A")
        if tha.n < 3:
            raise ValueError("need at least 6 walkers")
        return (lva, lvb), tuple((place(a), place(b)) for a, b in (
            (lpa, lla), (lpb, llb))), structure

    def _sharded_half(self, gen, upd, lp, ll, comp, *extra):
        """One half-update of ``Sharded`` leaf tuples: the half's seven
        words from ``gen``, the six partners as shard-sized transfers
        (``partner_rolls``: the shifts read on the host once), then the
        kernel once per shard with the shard's folded seed
        (``half_parts``). On a mesh of one shard the seed is not folded,
        as in the JAX sweep, whose single-device form runs there: the
        partner form given the rolls gives the snapshot form's bits.
        Returns Sharded (leaves, lp, ll)."""
        mesh = self.mesh
        words = self._draws(gen)
        parts = M.partner_rolls(comp, rot_shifts6(words[:6], upd.n), mesh)
        outs = []
        for j, g in enumerate(upd.index):
            dev = mesh.device_of(g)
            seed = (M.fold_seed(words[6], g) if upd.ndev > 1
                    else words[6])
            outs.append(self.half_parts(
                list(upd.shards[j]), lp.shards[j], ll.shards[j],
                parts.shards[j], seed.to(dev),
                *(torch.as_tensor(e).to(dev) for e in extra)))
        return tuple(M.Sharded(mesh, [tuple(o[0]) if k == 0 else o[k]
                                      for o in outs], upd.n)
                     for k in range(3))

    def _mesh_sweep(self, gen, th, ld, *extra):
        """A sweep on ``self.mesh`` (``extra``: tsmc's temperature): each
        half a ``Sharded``, the kernel once per shard a half-update."""
        (lva, lvb), ((lpa, lla), (lpb, llb)), structure = \
            self._sharded_halves(th, ld)
        lva, lpa, lla = self._sharded_half(gen, lva, lpa, lla, lvb, *extra)
        lvb, lpb, llb = self._sharded_half(gen, lvb, lpb, llb, lva, *extra)

        def tree(sh):
            return sh.map(lambda t: tree_of(list(t), structure))

        return (tree(lva), tree(lvb)), ((lpa, lla), (lpb, llb))

    def pushed(self, props):
        """The proposal as the prior and the simulator see it: pushed by
        the prior (discrete marginals rounded half to even), as float32."""
        pushed = self.prior.push_tree(tree_of(props, self.structure))
        return _f32_tree(pushed)

    def proposal_plain(self, upd, comp, shifts, seed, partners=None):
        """The half-update's steps before the simulator or likelihood, in
        plain PyTorch: returns (proposal leaves, pushed tree, logpdf,
        inside mask, corr, accept uniform). The mask says which walkers
        propose inside the prior's support. ``partners``: the
        partners-given form, the 6 K partner leaves leaf-major (a shard's
        blocks of ``partner_rolls``), read at each walker's own index in
        place of ``comp`` and ``shifts``."""
        h = upd[0].shape[0]
        dev = upd[0].device
        sb_rows = self._sb_rows(h)
        i = torch.arange(h, device=dev)
        words = _walker_words(
            self.bits, _seed_tensor(seed, dev), 3 + 2 * self.npairs,
            pid=i // sb_rows, cbase=50_000, sub=(i % sb_rows) // 128,
            lane=i % 128, stream=self.walker_stream, walker=i)
        pairs = [(words[3 + 2 * q], words[4 + 2 * q])
                 for q in range(self.npairs)]
        is_s, is_d, z, corr, gamma, nrm, u_acc = _mixture_setup(
            (words[0], words[1], words[2], pairs), self.d, self.mc)
        nzs, r = nrm[1:1 + self.d], nrm[1 + self.d:4 + self.d]
        parts = ([_rolled(c, shifts) for c in comp] if partners is None
                 else [partners[6 * k:6 * k + 6] for k in range(len(upd))])
        props = [_propose(is_s, is_d, z, gamma, r, nz, x, p, self.mc)
                 for x, nz, p in zip(upd, nzs, parts)]
        pushed = self.pushed(props)
        lpp = self.prior.logpdf_tree(pushed).to(torch.float32)
        return props, pushed, lpp, lpp > _NEG_INF, corr, u_acc


class FusedAISSweep(MixtureHalfSweep):
    """``make_fused_ais_sweep``'s sweep: ``sweep(gen, thetas, (lp, ll))``
    over full ``[n]`` tuples, or, with ``halves=True``, ``sweep(gen,
    (tree_a, tree_b), ((lp_a, ll_a), (lp_b, ll_b)))``. ``half_words``
    runs one half-update from its seven words (CPU or CUDA), ``half``
    one with given shifts and seed (CPU)."""

    def __init__(self, prior, draw, reduce_cost, *, scale, stats, nstats,
                 ndraws, noise, a_stretch, block, chunk, walker_tiles, bits,
                 halves, mesh=None):
        super().__init__(prior, a_stretch=a_stretch, block=block,
                         walker_tiles=walker_tiles, bits=bits)
        self.mesh = mesh
        self.draw, self.reduce_cost = draw, reduce_cost
        self.stats, self.nstats, self.ndraws = stats, nstats, ndraws
        self.noise, self.chunk, self.halves = noise, chunk, halves
        self.inv_scale = _f32(1.0 / scale)
        # trace now: an unsupported op or prior family raises here
        self.unit = codegen.generate(
            draw, structure=self.structure, nstats=nstats, stats=stats,
            nmoments=nstats, noise=noise, reduce_cost=reduce_cost,
            prior=prior, ais=True)
        self.fconsts = np.array(
            [_f32(1.0 / ndraws), *self.mc, self.inv_scale,
             _f32(2 * (self.d - 1))], np.float32)

    def half_plain(self, upd, lp, ll, comp, shifts, seed, terms=False,
                   partners=None):
        """Plain version of ``kt_fused_ais_sweep``: returns (theta leaves,
        lp, ll) of the updated half; with ``terms``, also (inside mask,
        margin): the margin is the MH log-ratio less the accept draw (a
        walker commits where it is >= 0 and inside). ``partners``: the
        partners-given form (``kt_fused_ais_sweep_parts``; ``comp`` and
        ``shifts`` unused)."""
        h = upd[0].shape[0]
        seed = _seed_tensor(seed, upd[0].device)
        props, pushed, lpp, valid, corr, u_acc = self.proposal_plain(
            upd, comp, shifts, seed, partners)
        moments = streaming_moment_cost_plain(
            self.draw, self.stats, self.nstats, pushed, seed, n=h,
            ndraws=self.ndraws, chunk=self.chunk, noise=self.noise,
            bits=self.bits, sb_rows=self._sb_rows(h),
            stream=STREAM_GEN_AIS_SIM)
        cost = self.reduce_cost(pushed, moments).to(torch.float32)
        llp = _kernelized_ll(valid, cost, lpp, self.inv_scale)
        acc, margin = _accept(corr, lpp, llp, lp, ll, valid, u_acc)
        out = ([torch.where(acc, p, x) for p, x in zip(props, upd)],
               torch.where(acc, lpp, lp), torch.where(acc, llp, ll))
        return out + ((valid, margin),) if terms else out

    def geometry(self, h):
        """``lane_groups.geometry`` of a half of ``h`` walkers for this
        model on the current card."""
        return lane_groups.geometry(
            h, self.nstats, lane_groups.sm_count(torch.cuda.current_device()),
            lane_groups.is_light(self.unit))

    def launch(self, upd, lp, ll, comp, words, outs, geometry=None,
               partners=None):
        """Launch ``kt_fused_ais_sweep`` on checked CUDA buffers of one
        half: ``words`` int64 [7], ``outs`` = (theta leaves, lp, ll);
        ``geometry`` a ``lane_groups.Geometry`` (default
        ``self.geometry(h)``); ``partners``: the 6 K partner leaves of
        the partners-given form (``kt_fused_ais_sweep_parts``, which reads
        only the seed of ``words``)."""
        lib = _build.load_generated(self.unit.source)
        oth, olp, oll = outs
        h = upd[0].shape[0]
        g = self.geometry(h) if geometry is None else lane_groups.check(
            h, geometry.walkers, geometry.threads, geometry.lanes,
            self.nstats, lane_groups.unit_lanes(self.unit.source))
        args = (_build.pointers(upd), lp.data_ptr(), ll.data_ptr(),
                _build.pointers(comp), words.data_ptr(), _build.pointers(oth),
                olp.data_ptr(), oll.data_ptr(), h, self.ndraws,
                self.fconsts.ctypes.data_as(ctypes.c_void_p),
                int(self.bits == "stub"), self._sb_rows(h), self.chunk,
                g.walkers, g.threads, g.lanes, _stream())
        if partners is None:
            err = lib.kt_fused_ais_sweep(*args)
        else:
            err = lib.kt_fused_ais_sweep_parts(
                *args, _build.pointers([x.contiguous() for x in partners]))
        _build.check(lib, err, "fused_ais_sweep")
        launches["fused_ais_sweep"] += 1

    def occupancy(self, geometry):
        """Blocks of ``geometry`` of the kernel (Philox bits) resident on
        one SM of the current card."""
        lib = _build.load_generated(self.unit.source)
        out = ctypes.c_int(0)
        _build.check(lib, lib.kt_fused_ais_sweep_occupancy(
            geometry.walkers, geometry.threads, geometry.lanes,
            ctypes.byref(out)), "fused_ais_sweep occupancy")
        return out.value

    def half(self, upd, lp, ll, comp, shifts, seed, outs=None):
        """One half-update with given ``shifts`` (six, int64) and ``seed``
        on CPU tensors, by the plain version (on CUDA tensors it raises:
        the kernel takes words, ``half_words``). Returns (theta leaves,
        lp, ll); ``outs`` are written when given."""
        self._cpu_only(upd[0].device)
        res = self.half_plain(upd, lp, ll, comp, shifts, seed)
        if outs is None:
            return res
        for o, v in zip(list(outs[0]) + list(outs[1:]),
                        list(res[0]) + list(res[1:])):
            o.copy_(v)
        return outs

    def half_words(self, upd, lp, ll, comp, words, outs=None,
                   geometry=None):
        """One half-update from the half's seven ``words`` (six shift
        words, then the seed): the plain version fed ``rot_shifts6`` of
        them for CPU tensors, the kernel (which derives the shifts) for
        CUDA tensors (``geometry`` as ``launch`` takes it). Returns (theta
        leaves, lp, ll); ``outs`` are written when given."""
        dev = upd[0].device
        words = self._device_words(words, dev)
        if dev.type == "cpu":
            return self.half(upd, lp, ll, comp,
                             rot_shifts6(words[:6], upd[0].shape[0]),
                             words[6:], outs)
        if outs is None:
            outs = ([torch.empty_like(x) for x in upd], torch.empty_like(lp),
                    torch.empty_like(ll))
        self.launch(upd, lp.contiguous(), ll.contiguous(), comp, words, outs,
                    geometry)
        return outs

    def half_parts(self, upd, lp, ll, partners, seed, outs=None,
                   geometry=None):
        """One half-update of a shard of a mesh in the partners-given form:
        ``partners`` the 6 K partner leaves leaf-major (the shard's blocks
        of ``partner_rolls``), ``seed`` the shard's seed (a 0-d or [1]
        int64 tensor holding a uint32): the plain version for CPU tensors,
        ``kt_fused_ais_sweep_parts`` for CUDA tensors. Returns (theta
        leaves, lp, ll)."""
        dev = upd[0].device
        if dev.type == "cpu":
            res = self.half_plain(upd, lp, ll, None, None, seed,
                                  partners=partners)
            if outs is None:
                return res
            for o, v in zip(list(outs[0]) + list(outs[1:]),
                            list(res[0]) + list(res[1:])):
                o.copy_(v)
            return outs
        if outs is None:
            outs = ([torch.empty_like(x) for x in upd], torch.empty_like(lp),
                    torch.empty_like(ll))
        self.launch([x.contiguous() for x in upd], lp.contiguous(),
                    ll.contiguous(), upd, self._shard_words(seed, dev), outs,
                    geometry, partners=partners)
        return outs

    def sweep_halves(self, gen, th, ld):
        """A sweep of the halves carry, in an ``ais.sweep`` span with one
        ``ais.half`` child a half-update (its words' draw and its
        launch; on a mesh the whole sweep is one span)."""
        with span("ais.sweep"):
            if self.mesh is not None:
                return self._mesh_sweep(gen, th, ld)
            tha_l, sa = leaves_of(th[0], "make_fused_ais_sweep")
            thb_l, _ = leaves_of(th[1], "make_fused_ais_sweep")
            self._check_leaves(tha_l, "half-A")
            (lpa, lla), (lpb, llb) = ld
            h = tha_l[0].shape[0]
            if h < 3:
                raise ValueError("need at least 6 walkers")
            with span("ais.half"):
                tha_l, lpa, lla = self.half_words(tha_l, lpa, lla, thb_l,
                                                  self._draws(gen))
            with span("ais.half"):
                thb_l, lpb, llb = self.half_words(thb_l, lpb, llb, tha_l,
                                                  self._draws(gen))
            return ((tree_of(tha_l, sa), tree_of(thb_l, sa)),
                    ((lpa, lla), (lpb, llb)))

    def sweep(self, gen, thetas, lds):
        """A sweep of the full ensemble, in an ``ais.sweep`` span with
        one ``ais.half`` child a half-update (its words' draw and its
        launch)."""
        with span("ais.sweep"):
            leaves, structure = leaves_of(thetas, "make_fused_ais_sweep")
            self._check_leaves(leaves, "thetas")
            lp, ll = (t.to(torch.float32).contiguous() for t in lds)
            n = leaves[0].shape[0]
            if n % 2:
                raise ValueError(
                    f"the fused AIS sweep needs an even walker count, got {n}")
            h = n // 2
            if h < 3:
                raise ValueError("need at least 6 walkers")
            oth = [torch.empty_like(x) for x in leaves]
            olp, oll = torch.empty_like(lp), torch.empty_like(ll)
            for half in (0, 1):
                sl, co = (slice(0, h), slice(h, n)) if half == 0 else (
                    slice(h, n), slice(0, h))
                comp = [(x if half == 0 else o)[co]
                        for x, o in zip(leaves, oth)]
                with span("ais.half"):
                    self.half_words(
                        [x[sl] for x in leaves], lp[sl], ll[sl], comp,
                        self._draws(gen),
                        outs=([o[sl] for o in oth], olp[sl], oll[sl]))
            return tree_of(oth, structure), (olp, oll)

    def __call__(self, gen, thetas, lds):
        if self.halves:
            return self.sweep_halves(gen, thetas, lds)
        return self.sweep(gen, thetas, lds)

    def work(self, h, nsim=None):
        """(bytes, operations) of one half-update over ``h`` walkers of
        which ``nsim`` (default all) propose inside the prior: the K
        leaves, lp and ll of the half and the K leaves of the other half
        read once, the K leaves, lp and ll written once; per walker the
        words, the normals, the proposal, the push and prior and the
        accept; the simulator, the moments' scaling and reduce_cost only
        for the walkers inside the prior."""
        u = self.unit
        k = u.nparams
        nsim = h if nsim is None else nsim
        per_walker = ((3 + 2 * self.npairs) * GEN_AIS_OPS_PER_WORD
                      + self.npairs * GEN_AIS_OPS_PER_PAIR + 8 + 25 * k
                      + u.prior_ops + u.push_ops + 14)
        per_draw = NOISE_OPS[self.noise] + u.draw_ops + u.stat_ops + u.nstats
        per_sim = self.ndraws * per_draw + u.reduce_ops + u.nstats
        return h * (4 * (3 * k + 4)) + 56, h * per_walker + nsim * per_sim


def _f32_tree(tree):
    """Every leaf as float32 (the kernel's pushed leaves are floats)."""
    if torch.is_tensor(tree):
        return tree.to(torch.float32)
    return tuple(x.to(torch.float32) for x in tree)


def make_fused_ais_sweep(prior, draw, reduce_cost, *, scale,
                         nmoments: int = 2, stats=None, ndraws: int = 1000,
                         noise: str = "normal", a_stretch: float = 3.0,
                         block: int = 1024, chunk: int = 512,
                         walker_tiles: int = 8, bits: str = "hw",
                         halves: bool = False, mesh=None):
    """Generic fused AIS red/black sweep: bring your own model to one
    kernel per half-update.

    ``prior``: a ``Factored`` of scalar marginals (or one marginal) from
    the families of ``ops/codegen.py``'s prior table; discrete marginals
    are pushed in the kernel (rounded half to even) for the prior and the
    simulator, and the committed walker stays the raw float proposal.
    ``draw``, ``stats`` and ``reduce_cost`` follow
    ``make_streaming_moment_cost``, with ``reduce_cost`` compiled into
    the kernel too (elementwise PyTorch of the supported ops). ``scale``:
    the kernelized density's target average cost. Returns
    ``sweep(gen, thetas, (lp, ll)) -> (thetas, (lp, ll))`` over full
    ``[n]`` tuples, or with ``halves=True`` the halves-carry contract of
    ``make_sweep_halves``.

    ``mesh`` (with ``halves=True``): each half is a ``Sharded`` over the
    mesh's walker axis (plain halves are placed on it), the six partners
    of a half-update come as shard-sized transfers (``partner_rolls``,
    which reads the half's shifts on the host once), and the kernel runs
    once per shard in its partners-given form with the shard folded into
    its seed (``fold_seed``), as the JAX sweep runs under ``shard_map``:
    statistical parity with the single-device sweep. ``sweep.mesh`` is
    the mesh."""
    if mesh is not None and not halves:
        raise ValueError(
            "make_fused_ais_sweep(mesh=...) requires halves=True: "
            "slicing a sharded full ensemble into halves would reshard "
            "every sweep — carry the halves (make_sweep_halves layout)")
    if mesh is not None:
        L.check_mesh(mesh, "make_fused_ais_sweep")
    stats, nstats = validate(stats, nmoments, noise, block, bits, chunk)
    return FusedAISSweep(
        prior, draw, reduce_cost, scale=scale, stats=stats, nstats=nstats,
        ndraws=ndraws, noise=noise, a_stretch=a_stretch, block=block,
        chunk=chunk, walker_tiles=walker_tiles, bits=bits, halves=halves,
        mesh=mesh)
