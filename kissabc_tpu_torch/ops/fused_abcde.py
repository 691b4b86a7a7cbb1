"""The fused ABC-DE generation — the PyTorch counterpart of
``make_fused_abcde_generation`` in ``kissabc_tpu/ops/pallas_kernels.py``
(TPU kernel ``full_call``, pallas_call at :2071).

The population-global parts of an ABCDE generation (the annealed
thresholds, the rank-trick base draw, the DE partner draws and the one
gather of the three parents) stay in ``core/abcde.py``. One launch of
``kt_fused_abcde_generation`` (``csrc/generic.cuh``, ``KT_HAS_ABCDE``)
runs the rest per walker: the DE proposal ``ts + gamma * (ta - tb)``, the
push and the prior's logpdf, the prior-MH gate ``active and log U <=
min(lpp - lps, 0)``, then, only for the walkers that pass it, the user's
streamed simulator on the raw or the pushed proposal (``cost_on``),
``reduce_cost`` and the commit ``dp <= max(eps_i, ds)``. Each block
compacts the walkers that pass the gate and gives each a group of lanes
that share its draws; ``lane_groups.geometry`` picks the walkers a block
covers, its threads and the lanes from ``n`` (``ops/lane_groups.py``).
The user's ``draw``, ``stats`` and ``reduce_cost`` and the prior's push
and logpdf are compiled into it by ``ops/codegen.py``. Beside the kernel,
``FusedABCDEGeneration.generation_plain`` repeats its arithmetic:

- a wrapper given CPU tensors runs the plain version;
- a wrapper given CUDA tensors launches the kernel or raises;
- ``launches`` counts the kernel's launches.

The seed is drawn on the generator's device and read by the kernel from
device memory, so a generation reads nothing on the host. ``bits="stub"``
replays the TPU kernel's stub stream at its coordinates; ``bits="hw"``
is Philox4x32-10.

On a mesh (``mesh=``) the gathers of ``core/abcde.py`` have already moved
everything that crosses shards, as in the JAX package
(pallas_kernels.py:1876-1879): the generation runs once per shard on the
shard's slices of the population, the parents, ``lps``, ``ds``,
``active`` and ``eps_i``, with the shard folded into the seed
(``fold_seed``), and needs no transfer of its own.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..parallel import layout as L
from ..parallel import mesh as M
from ..utils.logging import register_counters
from ..utils.rng import uint32_words
from . import _build, codegen, lane_groups
from .kernels import (_seed_tensor, _stream, philox4x32_10, plan_tiles,
                      stub_bits, to_unit)
from .streaming import (NOISE_OPS, leaves_of, streaming_moment_cost_plain,
                        tree_of, validate)

# launches of the CUDA kernel since the last reset (plain ints), registered
# with the counters that each span records (utils/logging.py)
launches = register_counters("launches.", {"fused_abcde_generation": 0})

# Philox streams (third counter word), as in csrc/generic.cuh
STREAM_ABCDE_WALKER, STREAM_ABCDE_SIM = 11, 12
# per-walker operations outside the user's functions: a Philox call (100),
# the mantissa trick and log1p (4), the gate (5), the commit's max and
# compare (4) and the selects of lps, ds and gate (3); per leaf the
# proposal (2) and the commit (1)
ABCDE_OPS, ABCDE_OPS_PER_LEAF = 100 + 4 + 5 + 4 + 3, 3


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _f32_tree(tree):
    if torch.is_tensor(tree):
        return tree.to(torch.float32)
    return tuple(x.to(torch.float32) for x in tree)


class FusedABCDEGeneration:
    """``gen(gen_, thetas, (ts, ta, tb), lps, ds, active, eps_i) ->
    (thetas, lps, ds, gate)``, made by ``make_fused_abcde_generation``;
    ``gamma`` and ``mesh`` as the JAX function sets them."""

    name = "make_fused_abcde_generation"

    def __init__(self, prior, draw, reduce_cost, *, gamma, stats, nstats,
                 ndraws, noise, cost_on, block, chunk, walker_tiles, bits,
                 mesh=None):
        self.prior, self.draw, self.reduce_cost = prior, draw, reduce_cost
        self.stats, self.nstats, self.ndraws = stats, nstats, ndraws
        self.noise, self.block, self.chunk = noise, block, chunk
        self.walker_tiles, self.bits = walker_tiles, bits
        self.push_cost = cost_on == "pushed"
        self.gamma = float(gamma)
        self.gam = float(np.float32(gamma))   # as the kernel rounds it
        self.mesh = mesh
        self.d = prior.nparams
        self.structure = codegen.prior_marginals(prior)[1]
        # trace now: an unsupported op or prior family raises here
        self.unit = codegen.generate(
            draw, structure=self.structure, nstats=nstats, stats=stats,
            nmoments=nstats, noise=noise, reduce_cost=reduce_cost,
            prior=prior, abcde=True)

    def _sb_rows(self, n):
        return plan_tiles(n, self.block, self.walker_tiles)[1] * self.block

    def _leaves(self, tree, what="thetas"):
        leaves, structure = leaves_of(tree, self.name)
        if len(leaves) != self.d:
            raise ValueError(
                f"prior has {self.d} scalar marginals but {what} has "
                f"{len(leaves)} leaves")
        return leaves, structure

    def gate_plain(self, bases, lps, active, seed):
        """The generation's steps before the simulator, in plain
        PyTorch: returns (proposal leaves, pushed tree, logpdf, gate
        mask). The mask says which walkers the kernel simulates."""
        ts, ta, tb = bases
        n = ts[0].shape[0]
        dev = ts[0].device
        sb_rows = self._sb_rows(n)
        w = torch.arange(n, device=dev)
        if self.bits == "stub":
            bu = stub_bits(w // sb_rows, seed, 40_000, (w % sb_rows) // 128,
                           w % 128)
        else:
            bu = philox4x32_10(0, w, STREAM_ABCDE_WALKER, 0, seed)[0]
        lprob = torch.log1p(-to_unit(bu))
        props = [s + self.gam * (a - b) for s, a, b in zip(ts, ta, tb)]
        pushed = _f32_tree(self.prior.push_tree(
            tree_of(props, self.structure)))
        lpp = self.prior.logpdf_tree(pushed).to(torch.float32)
        gate = active.to(torch.bool) & (
            lprob <= torch.clamp(lpp - lps, max=0.0))
        return props, pushed, lpp, gate

    def generation_plain(self, leaves, bases, lps, ds, active, eps_i, seed,
                         terms=False):
        """Plain version of ``kt_fused_abcde_generation``: returns (theta
        leaves, lps, ds, gate as float 0/1); with ``terms``, also the
        simulated cost ``dp`` of every walker (meaningful where the gate
        passes), so a check can look at the commit's margin."""
        n = leaves[0].shape[0]
        seed = _seed_tensor(seed, leaves[0].device)
        props, pushed, lpp, gate = self.gate_plain(bases, lps, active, seed)
        sim = pushed if self.push_cost else tree_of(props, self.structure)
        moments = streaming_moment_cost_plain(
            self.draw, self.stats, self.nstats, sim, seed, n=n,
            ndraws=self.ndraws, chunk=self.chunk, noise=self.noise,
            bits=self.bits, sb_rows=self._sb_rows(n),
            stream=STREAM_ABCDE_SIM)
        dp = torch.as_tensor(self.reduce_cost(sim, moments)).to(
            torch.float32).expand(n)
        commit = gate & (dp <= torch.maximum(eps_i, ds))
        out = ([torch.where(commit, p, x) for p, x in zip(props, leaves)],
               torch.where(commit, lpp, lps), torch.where(commit, dp, ds),
               gate.to(torch.float32))
        return out + (dp,) if terms else out

    def geometry(self, n):
        """``lane_groups.geometry`` for this model on the current card."""
        return lane_groups.geometry(
            n, self.nstats, lane_groups.sm_count(torch.cuda.current_device()),
            lane_groups.is_light(self.unit))

    def launch(self, leaves, bases, ins, seed, outs, geometry=None):
        """Launch ``kt_fused_abcde_generation`` on checked CUDA buffers of
        length n: ``bases`` the 3K leaves of ts, ta, tb; ``ins`` = (lps,
        ds, active as float 0/1, eps_i); ``outs`` = (theta leaves, lps,
        ds, gate); ``geometry`` a ``lane_groups.Geometry`` (default
        ``self.geometry(n)``)."""
        lib = _build.load_generated(self.unit.source)
        lps, ds, active, eps_i = ins
        oth, olps, ods, ogate = outs
        n = leaves[0].shape[0]
        g = self.geometry(n) if geometry is None else lane_groups.check(
            n, geometry.walkers, geometry.threads, geometry.lanes,
            self.nstats, lane_groups.unit_lanes(self.unit.source))
        err = lib.kt_fused_abcde_generation(
            _build.pointers(leaves), _build.pointers(bases), lps.data_ptr(),
            ds.data_ptr(), active.data_ptr(), eps_i.data_ptr(),
            seed.data_ptr(), _build.pointers(oth), olps.data_ptr(),
            ods.data_ptr(), ogate.data_ptr(), n, self.ndraws,
            float(np.float32(1.0 / self.ndraws)), self.gam,
            int(self.push_cost), int(self.bits == "stub"), self._sb_rows(n),
            self.chunk, g.walkers, g.threads, g.lanes, _stream())
        _build.check(lib, err, "fused_abcde_generation")
        launches["fused_abcde_generation"] += 1

    def occupancy(self, geometry):
        """Blocks of ``geometry`` of the kernel (Philox bits) resident on
        one SM of the current card."""
        lib = _build.load_generated(self.unit.source)
        out = ctypes.c_int(0)
        _build.check(lib, lib.kt_fused_abcde_generation_occupancy(
            geometry.walkers, geometry.threads, geometry.lanes,
            ctypes.byref(out)), "fused_abcde_generation occupancy")
        return out.value

    def run(self, leaves, bases, lps, ds, active, eps_i, seed,
            geometry=None):
        """One generation with a given seed: the plain version for CPU
        tensors, the kernel for CUDA tensors (``geometry`` as ``launch``
        takes it). Returns (theta leaves, lps, ds, gate)."""
        n = leaves[0].shape[0]
        dev = leaves[0].device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        named = ([("thetas", x) for x in leaves]
                 + [(w, x) for w, b in zip(("ts", "ta", "tb"), bases)
                    for x in b]
                 + [("lps", lps), ("ds", ds), ("active", active),
                    ("eps_i", eps_i)])
        for name, t in named:
            if t.shape != (n,) or t.device != dev:
                raise ValueError(f"{name} must be a vector of length {n} on "
                                 f"{dev}, got {tuple(t.shape)} on "
                                 f"{t.device}")
        if len(bases) != 3 or any(len(b) != self.d for b in bases):
            raise ValueError(f"bases must be (ts, ta, tb) of {self.d} "
                             "leaves each")
        leaves = [x.to(torch.float32).contiguous() for x in leaves]
        bases = [[x.to(torch.float32).contiguous() for x in b] for b in bases]
        vec = [t.to(torch.float32).contiguous()
               for t in (lps, ds, active, eps_i)]
        if dev.type == "cpu":
            return self.generation_plain(leaves, bases, vec[0], vec[1],
                                         vec[2], vec[3], seed)
        outs = ([torch.empty_like(x) for x in leaves],
                *(torch.empty_like(vec[0]) for _ in range(3)))
        self.launch(leaves, [x for b in bases for x in b], vec,
                    _seed_tensor(seed, dev), outs, geometry)
        return outs

    def __call__(self, gen, thetas, bases, lps, ds, active, eps_i):
        if self.mesh is not None:
            return self._sharded(gen, thetas, bases, lps, ds, active, eps_i)
        leaves, structure = self._leaves(thetas)
        bl = [self._leaves(b, what)[0]
              for what, b in zip(("ts", "ta", "tb"), bases)]
        seed = uint32_words(gen, 1)
        out_th, olps, ods, gate = self.run(leaves, bl, lps, ds, active,
                                           eps_i, seed)
        return tree_of(out_th, structure), olps, ods, gate

    def _sharded(self, gen, thetas, bases, lps, ds, active, eps_i):
        """The generation on ``self.mesh``: every input a ``Sharded`` (a
        whole tensor or tree is placed first), one seed word from
        ``gen``, then the kernel once per shard with the shard's folded
        seed. Returns Sharded (thetas, lps, ds, gate)."""
        mesh = self.mesh

        def place(t):
            return t if isinstance(t, M.Sharded) else M.place(mesh, t)

        thetas = place(thetas)
        L.check_divides(thetas.n, mesh)
        bases = [place(b) for b in bases]
        lps, ds, active, eps_i = map(place, (lps, ds, active, eps_i))
        structure = self._leaves(thetas.shards[0])[1]
        seed = uint32_words(gen, 1)
        outs = []
        for j, g in enumerate(thetas.index):
            bl = [self._leaves(b.shards[j], what)[0]
                  for what, b in zip(("ts", "ta", "tb"), bases)]
            outs.append(self.run(
                self._leaves(thetas.shards[j])[0], bl, lps.shards[j],
                ds.shards[j], active.shards[j], eps_i.shards[j],
                M.fold_seed(seed, g).to(mesh.device_of(g))))
        sh = [M.Sharded(mesh, [o[k] for o in outs], thetas.n)
              for k in range(4)]
        return (sh[0].map(lambda t: tree_of(t, structure)),) + tuple(sh[1:])

    def work(self, n, nsim=None):
        """(bytes, operations) of one generation over ``n`` walkers of
        which ``nsim`` (default all) pass the prior gate: the K leaves
        and the 3K parent leaves, lps, ds, active and eps_i read once and
        the seed; the K leaves, lps, ds and gate written once. Every
        walker costs the gate draw, the proposal, the push, the prior and
        the commit; only a walker that passes the gate needs the
        simulator, the moments' scaling and reduce_cost, since no output
        of another walker depends on them."""
        u = self.unit
        k = u.nparams
        nsim = n if nsim is None else nsim
        per_draw = NOISE_OPS[self.noise] + u.draw_ops + u.stat_ops + u.nstats
        per_walker = (ABCDE_OPS + ABCDE_OPS_PER_LEAF * k + u.prior_ops
                      + u.push_ops)
        per_sim = self.ndraws * per_draw + u.reduce_ops + u.nstats
        return n * 4 * (5 * k + 7) + 8, n * per_walker + nsim * per_sim


def make_fused_abcde_generation(prior, draw, reduce_cost, *, gamma: float,
                                nmoments: int = 2, stats=None,
                                ndraws: int = 1000, noise: str = "normal",
                                cost_on: str = "raw", block: int = 1024,
                                chunk: int = 512, walker_tiles: int = 8,
                                bits: str = "hw", mesh=None):
    """Generic fused ABC-DE generation for ``ABCDE(...,
    sweep_fused=...)``: one kernel per generation.

    ``prior``: a ``Factored`` of scalar marginals (or one marginal) from
    the families of ``ops/codegen.py``'s prior table; discrete marginals
    are pushed in the kernel for the prior (and for the simulator with
    ``cost_on="pushed"``; ``"raw"``, the default, feeds it the raw float
    proposal as the split path does). ``draw``, ``stats`` and
    ``reduce_cost`` follow ``make_streaming_moment_cost``, with
    ``reduce_cost`` compiled into the kernel too. ``gamma`` must equal
    ABCDE's ``proposal_width * 2.38 / sqrt(2d)``.

    Returns ``gen(gen_, thetas, (ts, ta, tb), lps, ds, active, eps_i) ->
    (thetas, lps, ds, gate)`` with ``.gamma`` and ``.mesh``; ``gate`` is
    the prior gate as float 0/1 (the reference's ``nsims`` tally).
    ``mesh``: the generation runs once per shard on a population sharded
    over the mesh's walker axis (the module docstring); pass the same
    mesh to ``ABCDE(..., mesh=...)``."""
    if mesh is not None:
        L.check_mesh(mesh, "make_fused_abcde_generation")
    if cost_on not in ("raw", "pushed"):
        raise ValueError(f"cost_on must be 'raw' or 'pushed', "
                         f"got {cost_on!r}")
    stats, nstats = validate(stats, nmoments, noise, block, bits, chunk)
    return FusedABCDEGeneration(
        prior, draw, reduce_cost, gamma=gamma, stats=stats, nstats=nstats,
        ndraws=ndraws, noise=noise, cost_on=cost_on, block=block,
        chunk=chunk, walker_tiles=walker_tiles, bits=bits, mesh=mesh)
