"""The fused tempered sweep — the PyTorch counterpart of
``make_fused_tempered_sweep`` in ``kissabc_tpu/ops/pallas_kernels.py``
(TPU kernel ``half_call``, pallas_call at :1748).

One launch of ``kt_fused_tempered_sweep`` (``csrc/tempered.cuh``) per
red/black half-update of tsmc's rejuvenation runs, per walker of the
updated half: the 4:2:1 stretch / DE / walk proposal against six partners
``comp[(i + r_j) % h]`` of the other half (the words and moves of the
generic AIS sweep, ``csrc/walkers.cuh``), the push, the prior's logpdf,
the user's deterministic ``loglike`` of the pushed value, and the
tempered MH accept at the temperature ``lam``::

    lw = corr + where(lpp > -inf, lpp + lam * llp, -inf) - (lp + lam * ll)

The raw float proposal is committed with its raw ``lpp`` and ``llp``.
``loglike`` and the prior's logpdf and push are compiled into the kernel
by ``ops/codegen.py``. The kernel takes the half's seven raw words (one
draw from the generator) and derives the six partner shifts from them by
``rot_shifts6``'s rule; ``lam`` and the words are read from device
memory, so a sweep reads nothing on the host and costs one word draw and
one launch a half. Beside the kernel, ``FusedTemperedSweep.half_plain`` repeats its arithmetic (the
int64-emulated uint32 words of ``ops/fused_ais.py``) on given shifts:

- a wrapper given CPU tensors runs the plain version;
- a wrapper given CUDA tensors launches the kernel or raises;
- ``launches`` counts the kernel's launches.

``bits="stub"`` replays the TPU kernel's stub stream at its coordinates;
``bits="hw"`` is Philox4x32-10.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..parallel import layout as L
from ..utils.logging import register_counters
from . import _build, codegen
from .fused_ais import (GEN_AIS_OPS_PER_PAIR, GEN_AIS_OPS_PER_WORD,
                        MixtureHalfSweep, _f32, rot_shifts6)
from .kernels import _check_bits, _seed_tensor, _stream
from .streaming import leaves_of, tree_of

# launches of the CUDA kernel since the last reset (plain ints), registered
# with the counters that each span records (utils/logging.py)
launches = register_counters("launches.", {"fused_tempered_sweep": 0})

# Philox stream (third counter word) of the walkers' words, as in
# csrc/tempered.cuh
STREAM_TEMPERED_WALKER = 10
# the tempered accept: two products, four sums, the select, log1p, the
# compare and the valid test; and the commit of lp and ll
TEMPERED_ACCEPT_OPS = 12 + 2
_NEG_INF = float("-inf")


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _lam_tensor(lam, dev):
    """The temperature as a float32 [1] tensor on ``dev`` (a view of a
    float32 scalar tensor there already)."""
    if not (torch.is_tensor(lam) and lam.device == dev
            and lam.dtype == torch.float32):
        lam = torch.as_tensor(lam, device=dev).to(torch.float32)
    return lam.reshape(1)


class FusedTemperedSweep(MixtureHalfSweep):
    """``make_fused_tempered_sweep``'s sweep: ``sweep(gen, (tree_a,
    tree_b), ((lp_a, ll_a), (lp_b, ll_b)), lam)``. ``half_words`` runs
    one half-update from its seven words (CPU or CUDA), ``half`` one with
    given shifts and seed (CPU)."""

    walker_stream = STREAM_TEMPERED_WALKER
    name = "make_fused_tempered_sweep"

    def __init__(self, prior, loglike, *, a_stretch, block, walker_tiles,
                 bits, mesh=None):
        super().__init__(prior, a_stretch=a_stretch, block=block,
                         walker_tiles=walker_tiles, bits=bits)
        self.loglike = loglike
        # trace now: an unsupported op or prior family raises here
        self.unit = codegen.generate_tempered(loglike, prior)
        self.fconsts = np.array([*self.mc, _f32(2 * (self.d - 1))],
                                np.float32)
        self._fconsts_ptr = self.fconsts.ctypes.data_as(ctypes.c_void_p)
        self.mesh = mesh

    def half_plain(self, upd, lp, ll, comp, shifts, seed, lam, terms=False,
                   partners=None):
        """Plain version of ``kt_fused_tempered_sweep``: returns (theta
        leaves, lp, ll) of the updated half; with ``terms``, also (inside
        mask, margin): the margin is the tempered MH log-ratio less the
        accept draw (a walker commits where it is >= 0 and inside).
        ``partners``: the partners-given form
        (``kt_fused_tempered_sweep_parts``; ``comp`` and ``shifts``
        unused)."""
        dev = upd[0].device
        seed = _seed_tensor(seed, dev)
        props, pushed, lpp, valid, corr, u_acc = self.proposal_plain(
            upd, comp, shifts, seed, partners)
        llp = torch.as_tensor(self.loglike(pushed), device=dev).to(
            torch.float32).expand(lpp.shape)
        lam = torch.as_tensor(lam, device=dev).to(torch.float32)
        new = torch.where(valid, lpp + lam * llp, _NEG_INF)
        lw = (corr + new) - (lp + lam * ll)
        logu = torch.log1p(-u_acc)
        acc = valid & (logu <= lw)
        out = ([torch.where(acc, p, x) for p, x in zip(props, upd)],
               torch.where(acc, lpp, lp), torch.where(acc, llp, ll))
        return out + ((valid, lw - logu),) if terms else out

    def launch(self, upd, lp, ll, comp, words, lam, outs, partners=None):
        """Launch ``kt_fused_tempered_sweep`` on checked CUDA buffers of
        one half: ``words`` int64 [7], ``lam`` float32 [1], ``outs`` =
        (theta leaves, lp, ll); ``partners``: the 6 K partner leaves of
        the partners-given form (``kt_fused_tempered_sweep_parts``, which
        reads only the seed of ``words``)."""
        lib = _build.load_generated(self.unit.source)
        oth, olp, oll = outs
        h = upd[0].shape[0]
        args = (_build.pointers(upd), lp.data_ptr(), ll.data_ptr(),
                _build.pointers(comp), words.data_ptr(), lam.data_ptr(),
                _build.pointers(oth), olp.data_ptr(), oll.data_ptr(), h,
                self._fconsts_ptr, int(self.bits == "stub"),
                self._sb_rows(h), _stream())
        if partners is None:
            err = lib.kt_fused_tempered_sweep(*args)
        else:
            err = lib.kt_fused_tempered_sweep_parts(
                *args, _build.pointers([x.contiguous() for x in partners]))
        _build.check(lib, err, "fused_tempered_sweep")
        launches["fused_tempered_sweep"] += 1

    def half(self, upd, lp, ll, comp, shifts, seed, lam, outs=None):
        """One half-update with given ``shifts`` (six, int64), ``seed``
        and temperature ``lam`` on CPU tensors, by the plain version (on
        CUDA tensors it raises: the kernel takes words, ``half_words``).
        Returns (theta leaves, lp, ll); ``outs`` are written when
        given."""
        upd, comp, lp, ll, dev = self._checked(upd, comp, lp, ll)
        self._cpu_only(dev)
        res = self.half_plain(upd, lp, ll, comp, shifts, seed, lam)
        if outs is None:
            return res
        for o, v in zip(list(outs[0]) + list(outs[1:]),
                        list(res[0]) + list(res[1:])):
            o.copy_(v)
        return outs

    def half_words(self, upd, lp, ll, comp, words, lam, outs=None):
        """One half-update from the half's seven ``words`` (six shift
        words, then the seed) at temperature ``lam``: the plain version
        fed ``rot_shifts6`` of them for CPU tensors, the kernel (which
        derives the shifts) for CUDA tensors. Returns (theta leaves, lp,
        ll); ``outs`` are written when given."""
        upd, comp, lp, ll, dev = self._checked(upd, comp, lp, ll)
        words = self._device_words(words, dev)
        if dev.type == "cpu":
            return self.half(upd, lp, ll, comp,
                             rot_shifts6(words[:6], upd[0].shape[0]),
                             words[6:], lam, outs)
        if outs is None:
            outs = ([torch.empty_like(x) for x in upd], torch.empty_like(lp),
                    torch.empty_like(ll))
        self.launch(upd, lp, ll, comp, words, _lam_tensor(lam, dev), outs)
        return outs

    def half_parts(self, upd, lp, ll, partners, seed, lam, outs=None):
        """One half-update of a shard of a mesh in the partners-given form
        at temperature ``lam``: ``partners`` the 6 K partner leaves
        leaf-major, ``seed`` the shard's seed: the plain version for CPU
        tensors, ``kt_fused_tempered_sweep_parts`` for CUDA tensors.
        Returns (theta leaves, lp, ll)."""
        upd, _, lp, ll, dev = self._checked(upd, upd, lp, ll)
        if dev.type == "cpu":
            res = self.half_plain(upd, lp, ll, None, None, seed, lam,
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
        self.launch(upd, lp, ll, upd, self._shard_words(seed, dev),
                    _lam_tensor(lam, dev), outs, partners=partners)
        return outs

    def _checked(self, upd, comp, lp, ll):
        """The half's leaves, the other half's leaves, lp and ll as
        float32 contiguous vectors of one length h on one CPU or CUDA
        device (the kernel reads partners ``comp[(i + r) % h]``, so the
        halves must be equal), and that device."""
        h, dev = upd[0].shape[0], upd[0].device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        vecs = list(upd) + list(comp) + [lp, ll]
        if len(comp) != len(upd) or any(
                t.shape != (h,) or t.device != dev for t in vecs):
            raise ValueError(
                f"{self.name}: the halves' leaves, lp and ll must be "
                f"vectors of one length on {dev} (equal red/black halves), "
                f"got {[(tuple(t.shape), str(t.device)) for t in vecs]}")
        vecs = [t if t.dtype == torch.float32 and t.is_contiguous()
                else t.to(torch.float32).contiguous() for t in vecs]
        k = len(upd)
        return vecs[:k], vecs[k:2 * k], vecs[-2], vecs[-1], dev

    def __call__(self, gen, th, ld, lam):
        if self.mesh is not None:
            return self._mesh_sweep(gen, th, ld, torch.as_tensor(lam))
        tha_l, structure = leaves_of(th[0], self.name)
        thb_l, _ = leaves_of(th[1], self.name)
        self._check_leaves(tha_l, "half-A")
        (lpa, lla), (lpb, llb) = ld
        h = tha_l[0].shape[0]
        if h < 3:
            raise ValueError("need at least 6 walkers")
        # seven words a half, half A's first: one draw each
        wa, wb = self._draws(gen), self._draws(gen)
        tha_l, lpa, lla = self.half_words(tha_l, lpa, lla, thb_l, wa, lam)
        thb_l, lpb, llb = self.half_words(thb_l, lpb, llb, tha_l, wb, lam)
        return ((tree_of(tha_l, structure), tree_of(thb_l, structure)),
                ((lpa, lla), (lpb, llb)))

    def work(self, h):
        """(bytes, operations) of one half-update over ``h`` walkers: the
        K leaves, lp and ll of the half and the K leaves of the other
        half read once, the shifts, seed and lam, the K leaves, lp and ll
        written once; per walker the words, the normals, the proposal,
        the push, the prior, the log-likelihood and the tempered
        accept."""
        u = self.unit
        k = u.nparams
        per_walker = ((3 + 2 * self.npairs) * GEN_AIS_OPS_PER_WORD
                      + self.npairs * GEN_AIS_OPS_PER_PAIR + 8 + 25 * k
                      + u.prior_ops + u.push_ops + u.loglike_ops
                      + TEMPERED_ACCEPT_OPS)
        return h * (4 * (3 * k + 4)) + 60, h * per_walker


def make_fused_tempered_sweep(prior, loglike, *, a_stretch: float = 3.0,
                              block: int = 1024, walker_tiles: int = 8,
                              bits: str = "hw", mesh=None):
    """Generic fused tempered rejuvenation sweep for ``tsmc(...,
    sweep_fused=...)``: one kernel per half-update.

    ``prior``: a ``Factored`` of scalar marginals (or one marginal) from
    the families of ``ops/codegen.py``'s prior table; discrete marginals
    are pushed in the kernel (rounded half to even) before the prior and
    ``loglike`` see them, and the committed walker stays the raw float
    proposal. ``loglike(theta) -> ll``: a deterministic, elementwise
    log-likelihood of the pushed parameters in PyTorch of the supported
    ops, compiled into the kernel; data enter as Python or numpy
    constants (a loop over data points, or sufficient statistics). No
    randomness, nothing reduced over walkers: a stochastic likelihood
    needs tsmc's split path.

    Returns ``sweep(gen, (tree_a, tree_b), ((lp_a, ll_a), (lp_b, ll_b)),
    lam)``: ``lp``/``ll`` are carried raw (unscaled), so ``lam`` (a float
    or a 0-d tensor, read by the kernel from device memory) can change
    between sweeps. ``mesh``: each half is a ``Sharded`` over the mesh's
    walker axis, the six partners come as shard-sized transfers and the
    kernel runs once per shard in its partners-given form with the shard
    folded into its seed, as ``make_fused_ais_sweep(mesh=...)``; pass the
    same mesh to ``tsmc(..., mesh=...)``. ``sweep.mesh`` is the mesh."""
    if mesh is not None:
        L.check_mesh(mesh, "make_fused_tempered_sweep")
    if block % 128:
        raise ValueError(f"block must be a multiple of 128, got {block}")
    _check_bits(bits, block, 1)
    return FusedTemperedSweep(prior, loglike, a_stretch=a_stretch,
                              block=block, walker_tiles=walker_tiles,
                              bits=bits, mesh=mesh)
