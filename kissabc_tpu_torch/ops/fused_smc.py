"""The generic fused smc sweep — the PyTorch counterpart of
``make_fused_smc_sweep`` in ``kissabc_tpu/ops/pallas_kernels.py`` (TPU
kernel ``full_call``, pallas_call at :2391).

One kernel launch, ``kt_fused_smc_sweep`` (``csrc/generic.cuh``), runs
the whole rejuvenation sweep per walker: the Gaussian-difference
proposal against the partners ``(w - r1) mod n`` and ``(w - r2) mod n``
(``jnp.roll(x, r)[w]``), the prior's push and logpdf, gate 1 (prior-only
MH), then, for the walkers that pass gate 1, the user's streamed
simulator and ``reduce_cost`` on the pushed proposal, gate 2 (``<`` or
``<=`` eps by the boundary flag) and the commit of the raw proposal.
Each block of ``SWEEP_THREADS`` threads compacts its gate-1 walkers onto
its first threads before the simulator (``sweep_geometry``,
``lane_share``). The user's ``draw``,
``stats`` and ``reduce_cost`` and the prior's logpdf are compiled into it
by ``ops/codegen.py``. ``fused_smc_sweep_plain`` repeats the kernel's
arithmetic with the user's callables and the port's prior on tensors;
it takes ``r1``, ``r2`` and the seed explicitly, so tests can give it
the JAX sweep's own.

The contract is ``smc``'s inner sweep, so the sweep plugs into
``smc(..., sweep_fused=...)``::

    sweep(gen, thetas, xs, lps, alive, eps, flag)
        -> (thetas, xs, lps, naccept)

Nothing of it is read on the host: the shifts and the seed are drawn on
the generator's device and the kernel reads them, ``eps`` and ``flag``
from device memory; ``naccept`` is a device tensor.

On a mesh (``make_fused_smc_sweep(..., mesh=mesh)``, the population a
``Sharded``), as the JAX sweep: the two partner rolls of the snapshot go
through ``roll_walkers`` (two shard-sized transfers per leaf and shard;
the shifts are read on the host once a sweep, since they choose the
transfers' sources), the kernel runs once per shard on the shard's
device with its partners read from the rolled copies and its own seed
``seed + (shard + 1) * 2**20`` (pallas_kernels.py:2467-2472), and the
accept count is summed over the mesh.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..parallel import mesh as M
from ..utils.rng import uint32_words
from . import _build, codegen
from .kernels import (_seed_tensor, _stream, philox4x32_10, plan_tiles,
                      sincos_2pi, stub_bits, to_unit)
from .moves import roll_shifts
from .streaming import (NOISE_OPS, STREAM_GEN_SWEEP_SIM,
                        STREAM_GEN_SWEEP_WALKER, _device_of, leaves_of,
                        streaming_moment_cost_plain, tree_of, validate)

# launches of the CUDA kernel since the last reset (plain ints)
launches = {"fused_smc_sweep": 0}

# threads per block of the kernel, which compacts the block's gate-1
# walkers onto its first threads: the block size at most
# (kSweepMaxThreads in csrc/generic.cuh), and the one launched, chosen by
# measurement on the card (chip_smoke.py kernel-times, PERF.md)
MAX_SWEEP_THREADS = 1024
SWEEP_THREADS = 512

# per-walker operations of the sweep outside the simulator, the prior and
# reduce_cost: one Philox call (100), three mantissa tricks (9), the
# proposal scale (sqrt, log1p, sincos: 30), the MH log-u (2), the gates
# and the eps test (10); per leaf the proposal (3) and the commit (1)
SWEEP_OPS, SWEEP_OPS_PER_LEAF = 100 + 9 + 30 + 1 + 2 + 10 + 3, 4


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def sweep_geometry(n: int, threads: int = SWEEP_THREADS) -> tuple[int, int]:
    """(blocks, threads) of one launch over ``n`` walkers: blocks of
    ``threads``, a multiple of 32 up to ``MAX_SWEEP_THREADS``, one walker
    a thread."""
    if threads % 32 or not 32 <= threads <= MAX_SWEEP_THREADS:
        raise ValueError(f"threads must be a multiple of 32 in [32, "
                         f"{MAX_SWEEP_THREADS}], got {threads}")
    return max(1, -(-n // threads)), threads


def lane_share(gate1, threads: int = SWEEP_THREADS) -> float:
    """The share of the draw loop's lanes that do useful work when each
    block of ``threads`` compacts its gate-1 walkers (``gate1``, a bool
    vector over the walkers): the block's p passing walkers run on
    ceil(p / 32) warps, so the share is sum p / sum 32 ceil(p / 32) over
    the blocks (1.0 where none passes). ``threads=32`` gives the share of
    one warp per 32 walkers without compaction, where a warp runs the
    loop while any of its walkers needs it."""
    n = gate1.shape[0]
    blocks, threads = sweep_geometry(n, threads)
    padded = torch.zeros(blocks * threads, dtype=torch.int64,
                         device=gate1.device)
    padded[:n] = gate1.to(torch.int64)
    p = padded.view(blocks, threads).sum(1)
    lanes = int((torch.div(p + 31, 32, rounding_mode="floor") * 32).sum())
    return int(p.sum()) / lanes if lanes else 1.0


class FusedSMCSweep:
    """``sweep(gen, thetas, xs, lps, alive, eps, flag)``, made by
    ``make_fused_smc_sweep``."""

    def __init__(self, prior, draw, reduce_cost, *, max_stretch, stats,
                 nstats, ndraws, noise, block, chunk, walker_tiles, bits,
                 mesh=None):
        self.mesh = mesh
        self.prior, self.draw, self.reduce_cost = prior, draw, reduce_cost
        self.stats, self.nstats, self.ndraws = stats, nstats, ndraws
        self.noise, self.block, self.chunk = noise, block, chunk
        self.walker_tiles, self.bits = walker_tiles, bits
        self.d = prior.nparams
        self.w_scale = float(np.float32(max_stretch / math.sqrt(self.d)))
        self.structure = codegen.prior_marginals(prior)[1]
        # trace now: an unsupported op or prior family raises here
        self.unit = codegen.generate(
            draw, structure=self.structure, nstats=nstats, stats=stats,
            nmoments=nstats, noise=noise, reduce_cost=reduce_cost,
            prior=prior)

    def _leaves(self, thetas):
        """(leaves, n, the caller's structure). As the JAX sweep, only
        the leaf count and shapes are checked: a 1-tuple population for
        a single marginal runs, and comes back as a 1-tuple."""
        leaves, structure = leaves_of(thetas, "make_fused_smc_sweep")
        if len(leaves) != self.d:
            raise ValueError(
                f"prior has {self.d} scalar marginals but thetas has "
                f"{len(leaves)} leaves")
        n = leaves[0].shape[0]
        if n < 3:
            raise ValueError("need at least 3 walkers")
        return leaves, n, structure

    def _sb_rows(self, n):
        return plan_tiles(n, self.block, self.walker_tiles)[1] * self.block

    def __call__(self, gen, thetas, xs, lps, alive, eps, flag):
        if self.mesh is not None:
            return self._sharded(gen, thetas, xs, lps, alive, eps, flag)
        return self._one(gen, thetas, xs, lps, alive, eps, flag)

    def _one(self, gen, thetas, xs, lps, alive, eps, flag):
        """The sweep of a population on one device."""
        leaves, n, structure = self._leaves(thetas)
        words = uint32_words(gen, 3)
        r1, r2 = roll_shifts(words[:2], n)
        rs = torch.stack((r1, r2, words[2]))
        out, oxs, olps, commit = self.run(leaves, xs, lps, alive, eps, flag,
                                          rs)
        return tree_of(out, structure), oxs, olps, commit.sum()

    def _sharded(self, gen, thetas, xs, lps, alive, eps, flag):
        """The sweep of a population on the mesh: the partner rolls as
        shard-sized transfers, then the kernel once per shard."""
        mesh = self.mesh
        place = M.constrainer(mesh, "walker")
        thetas, xs, lps, alive = map(place, (thetas, xs, lps, alive))
        if thetas.ndev == 1:   # one shard: the sweep of one device
            out = self._one(gen, thetas.shards[0], xs.shards[0],
                            lps.shards[0], alive.shards[0], eps, flag)
            return tuple(M.Sharded(mesh, [o], thetas.n) for o in out[:3]) \
                + (out[3],)
        n = thetas.n
        if n < 3:
            raise ValueError("need at least 3 walkers")
        structure = leaves_of(thetas.shards[0], "make_fused_smc_sweep")[1]
        lv = thetas.map(lambda t: tuple(leaves_of(t, "make_fused_smc_sweep")
                                        [0]))
        if len(lv.shards[0]) != self.d:
            raise ValueError(
                f"prior has {self.d} scalar marginals but thetas has "
                f"{len(lv.shards[0])} leaves")
        words = uint32_words(gen, 3)
        r1, r2 = roll_shifts(words[:2].tolist(), n)
        ta = M.roll_walkers(lv, r2, mesh)
        tb = M.roll_walkers(lv, r1, mesh)
        outs = []
        for j, g in enumerate(thetas.index):
            dev = mesh.device_of(g)
            lseed = M.fold_seed(words[2], g)
            rs = torch.stack((torch.zeros_like(lseed),
                              torch.zeros_like(lseed), lseed)).to(dev)
            outs.append(self.run(list(lv.shards[j]), xs.shards[j],
                                 lps.shards[j], alive.shards[j],
                                 torch.as_tensor(eps).to(dev),
                                 torch.as_tensor(flag).to(dev), rs,
                                 partners=(list(ta.shards[j]),
                                           list(tb.shards[j]))))
        naccept = M.psum(mesh, [o[3].sum() for o in outs])

        def sharded(k):
            return M.Sharded(mesh, [o[k] for o in outs], n)

        return (sharded(0).map(lambda t: tree_of(t, structure)), sharded(1),
                sharded(2), naccept)

    def run(self, leaves, xs, lps, alive, eps, flag, rs, partners=None):
        """One sweep with given shifts and seed, ``rs = (r1, r2, seed)``
        (an int64 tensor on the population's device): the plain version
        for CPU tensors, the kernel for CUDA tensors. ``partners``: the
        leaves rolled by r2 and by r1 (a shard of a mesh; then ``rs``
        holds shifts 0). Returns (theta leaves, xs, lps, commit mask)."""
        n = leaves[0].shape[0]
        dev = _device_of(leaves)
        if dev.type == "cpu":
            return fused_smc_sweep_plain(self, leaves, xs, lps, alive, eps,
                                         flag, rs[0], rs[1], rs[2:],
                                         partners=partners)
        ins = self._inputs(n, dev, xs, lps, alive, eps, flag)
        outs = ([torch.empty_like(x) for x in leaves],
                torch.empty_like(ins[0]), torch.empty_like(ins[1]),
                torch.empty(n, dtype=torch.bool, device=dev))
        self.launch(n, leaves, ins, rs, outs, partners=partners)
        launches["fused_smc_sweep"] += 1
        return outs

    @staticmethod
    def _inputs(n, dev, xs, lps, alive, eps, flag):
        def vec(t, dtype, name):
            if t.shape != (n,) or t.device != dev:
                raise ValueError(f"{name} must be a vector of length {n} "
                                 f"on {dev}, got {tuple(t.shape)} on "
                                 f"{t.device}")
            return t.to(dtype).contiguous()

        return (vec(xs, torch.float32, "xs"), vec(lps, torch.float32, "lps"),
                vec(alive, torch.bool, "alive"),
                torch.as_tensor(eps, device=dev).to(torch.float32)
                .reshape(1),
                torch.as_tensor(flag, device=dev).to(torch.bool).reshape(1))

    def launch(self, n, leaves, ins, rs, outs, threads=SWEEP_THREADS,
               partners=None):
        """Launch over the first ``n`` walkers of checked CUDA buffers:
        ``ins`` = (xs, lps, alive, eps[1], flag[1]), ``rs`` = (r1, r2,
        seed) int64, ``outs`` = (theta leaves, xs, lps, commit); blocks
        of ``threads`` (``sweep_geometry``); ``partners`` = (leaves
        rolled by r2, by r1) or None."""
        blocks, threads = sweep_geometry(n, threads)
        lib = _build.load_generated(self.unit.source)
        xs, lps, alive, eps, flag = ins
        oth, oxs, olps, ocm = outs
        parts = None if partners is None else [
            [x.contiguous() for x in p] for p in partners]
        p2, p1 = ((None, None) if parts is None else
                  (_build.pointers(parts[0]), _build.pointers(parts[1])))
        err = lib.kt_fused_smc_sweep(
            _build.pointers(leaves), xs.data_ptr(), lps.data_ptr(),
            alive.data_ptr(), eps.data_ptr(), flag.data_ptr(),
            rs.data_ptr(), _build.pointers(oth), oxs.data_ptr(),
            olps.data_ptr(), ocm.data_ptr(), n, self.ndraws,
            float(np.float32(1.0 / self.ndraws)), self.w_scale,
            int(self.bits == "stub"), self._sb_rows(n), self.chunk, blocks,
            threads, _stream(), p2, p1)
        _build.check(lib, err, "fused_smc_sweep")

    def occupancy(self, threads=SWEEP_THREADS):
        """Blocks of ``threads`` of the kernel (Philox bits) resident on
        one SM of the current card."""
        lib = _build.load_generated(self.unit.source)
        out = ctypes.c_int(0)
        _build.check(lib, lib.kt_fused_smc_sweep_occupancy(
            sweep_geometry(1, threads)[1], ctypes.byref(out)),
            "fused_smc_sweep occupancy")
        return out.value

    def work(self, n, nsim=None):
        """(bytes, operations) of one sweep over ``n`` walkers of which
        ``nsim`` (default all) pass gate 1: the K leaves, xs, lps and
        alive read once (the partners re-read leaves already counted),
        eps, flag and the shifts and seed; the K leaves, xs, lps and the
        commit mask written once. Every walker costs the proposal, the
        prior and the commit; only a walker that passes gate 1 needs the
        simulator (operations per draw as the streaming cost), the
        moments' scaling and reduce_cost, since no output of any other
        walker depends on them."""
        u = self.unit
        k = u.nparams
        nsim = n if nsim is None else nsim
        per_draw = NOISE_OPS[self.noise] + u.draw_ops + u.stat_ops + u.nstats
        per_walker = (SWEEP_OPS + SWEEP_OPS_PER_LEAF * k + u.prior_ops
                      + u.push_ops)
        per_sim = self.ndraws * per_draw + u.reduce_ops + u.nstats
        return n * (8 * k + 17) + 29, n * per_walker + nsim * per_sim


def fused_smc_sweep_plain(sweep, leaves, xs, lps, alive, eps, flag, r1,
                          r2, seed, partners=None):
    """Plain PyTorch version of ``kt_fused_smc_sweep`` for the model of
    ``sweep`` (a ``FusedSMCSweep``), with explicit partner shifts ``r1``,
    ``r2`` and kernel ``seed`` (ints or tensors), so tests can pass the
    JAX sweep's own; ``partners`` as ``FusedSMCSweep.run``. Returns
    (theta leaves, xs, lps, commit mask)."""
    n = leaves[0].shape[0]
    dev = leaves[0].device
    seed = _seed_tensor(seed, dev)
    props, pushed, lpp, gate1 = proposal_plain(sweep, leaves, lps, alive,
                                               r1, r2, seed, partners)
    moments = streaming_moment_cost_plain(
        sweep.draw, sweep.stats, sweep.nstats, pushed, seed, n=n,
        ndraws=sweep.ndraws, chunk=sweep.chunk, noise=sweep.noise,
        bits=sweep.bits, sb_rows=sweep._sb_rows(n),
        stream=STREAM_GEN_SWEEP_SIM)
    xp = sweep.reduce_cost(pushed, moments).to(torch.float32)
    eps = torch.as_tensor(eps, device=dev).to(torch.float32)
    flag = torch.as_tensor(flag, device=dev).to(torch.bool)
    commit = gate1 & ((xp < eps) | (flag & (xp == eps)))
    return ([torch.where(commit, p, x) for p, x in zip(props, leaves)],
            torch.where(commit, xp, xs), torch.where(commit, lpp, lps),
            commit)


def proposal_plain(sweep, leaves, lps, alive, r1, r2, seed, partners=None):
    """The sweep's steps before the simulator, in plain PyTorch: the
    proposal, its push and prior logpdf, and gate 1 (alive, inside the
    prior's support, prior-only MH). The partners are read at ``(w - r)
    mod n`` from ``partners`` = (leaves rolled by r2, by r1), the leaves
    themselves by default. Returns (proposal leaves, pushed tree, logpdf,
    gate-1 mask); the mask says which walkers' outputs depend on the
    simulation."""
    n = leaves[0].shape[0]
    dev = leaves[0].device
    seed = _seed_tensor(seed, dev)
    sb_rows = sweep._sb_rows(n)
    w = torch.arange(n, device=dev)
    pid, row, lane = w // sb_rows, (w % sb_rows) // 128, w % 128
    if sweep.bits == "stub":
        bu1, bu2, bu3 = (stub_bits(pid, seed, c, row, lane)
                         for c in (40_000, 40_001, 40_002))
    else:
        bu1, bu2, bu3, _ = philox4x32_10(0, w, STREAM_GEN_SWEEP_WALKER,
                                         0, seed)
    z = torch.sqrt(-2.0 * torch.log1p(-to_unit(bu1))) \
        * sincos_2pi(to_unit(bu2))[0]
    wv = z * sweep.w_scale
    lprob = torch.log1p(-to_unit(bu3))
    i2 = torch.remainder(w - r2, n)
    i1 = torch.remainder(w - r1, n)
    p2, p1 = (leaves, leaves) if partners is None else partners
    props = [x + (a[i2] - b[i1]) * wv for x, a, b in zip(leaves, p2, p1)]
    pushed = sweep.prior.push_tree(tree_of(props, sweep.structure))
    lpp = sweep.prior.logpdf_tree(pushed).to(torch.float32)
    gate1 = (alive.to(torch.bool) & (lpp > float("-inf"))
             & (lprob < torch.clamp(lpp - lps, max=0.0)))
    return props, pushed, lpp, gate1


def make_fused_smc_sweep(prior, draw, reduce_cost, *,
                         max_stretch: float = 2.0, nmoments: int = 2,
                         stats=None, ndraws: int = 1000,
                         noise: str = "normal", block: int = 1024,
                         chunk: int = 512, walker_tiles: int = 8,
                         bits: str = "hw", mesh=None):
    """Generic fused smc rejuvenation sweep: bring your own model to one
    kernel per sweep, for ``smc(..., sweep_fused=...)``.

    ``prior``: a ``Factored`` of scalar marginals (or one marginal) from
    the families of ``ops/codegen.py``'s prior table; as in the JAX
    kernel, the proposal is pushed (a discrete marginal rounded half to
    even) for the prior and the simulator, and the raw proposal is
    committed. A vector or matrix marginal is refused, as the JAX
    kernel refuses it. ``draw``, ``stats`` and ``reduce_cost`` follow
    ``make_streaming_moment_cost``, with ``reduce_cost`` also compiled
    into the kernel: elementwise PyTorch of the supported ops. Anything
    the kernel cannot hold raises when the sweep is built. ``mesh``: a
    ``Mesh`` with a ``walker`` axis makes the sweep run on a population
    sharded over it (the module docstring); pass the same mesh to
    ``smc(..., mesh=...)``. ``sweep.mesh`` is the mesh.
    """
    if mesh is not None and not isinstance(mesh, M.Mesh):
        raise TypeError(f"make_fused_smc_sweep(mesh=...) takes a Mesh "
                        f"(parallel/mesh.py), got {type(mesh).__name__}")
    stats, nstats = validate(stats, nmoments, noise, block, bits, chunk)
    return FusedSMCSweep(
        prior, draw, reduce_cost, max_stretch=max_stretch, stats=stats,
        nstats=nstats, ndraws=ndraws, noise=noise, block=block, chunk=chunk,
        walker_tiles=walker_tiles, bits=bits, mesh=mesh)
