"""The generic streaming simulator cost — the PyTorch counterpart of
``make_streaming_moment_cost`` in ``kissabc_tpu/ops/pallas_kernels.py``
(TPU kernel ``pallas_cost``, pallas_call at :2742).

For any simulator of the form

    x_ij = draw(theta_i, eps_ij),   eps ~ N(0,1) or U[0,1)
    cost_i = reduce_cost(theta_i, (E[x], E[x^2], ..., E[x^k]))

(or E[g_j(x)] for user ``stats``), the kernel ``kt_streaming_moment_cost``
(``csrc/generic.cuh``) streams the moments of ``ndraws`` draws per walker
with the user's ``draw`` and ``stats`` compiled into it by
``ops/codegen.py``; ``reduce_cost`` runs in PyTorch on the ``[n]``
moments, as in the JAX package. Beside it,
``streaming_moment_cost_plain`` repeats the kernel's arithmetic and
summation order with the user's own callables on tensors:

- a CPU tensor runs the plain version (the CPU tests);
- a CUDA tensor launches the kernel or raises — there is no fallback;
- ``launches`` counts the kernel's launches.

The kernel's launch geometry (walkers a block, threads, lanes a walker)
comes from ``lane_groups.cost_geometry``: one thread per walker where
many walkers share an SM, groups of lanes sharing a walker's draws where
few do; every geometry gives the same bits.

``bits="hw"`` is Philox4x32-10, ``bits="stub"`` the JAX package's stub
stream at the TPU kernel's coordinates (see ``csrc/generic.cuh``). The
JAX function's ``interpret=`` has no counterpart here: the plain version
takes its place, chosen by the tensors' device, so it is not accepted.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.rng import uint32_words
from . import _build, codegen, lane_groups
from .kernels import (_box_muller, _check_bits, _seed_tensor, _stream,
                      philox4x32_10, plan_tiles, stub_bits, to_unit)

# launches of the CUDA kernel since the last reset (plain ints)
launches = {"streaming_moment_cost": 0}

# Philox streams (third counter word) of the generic kernels, as in
# csrc/generic.cuh
STREAM_GEN_COST, STREAM_GEN_SWEEP_WALKER, STREAM_GEN_SWEEP_SIM = 3, 4, 5
# operations per draw of the noise, counting a transcendental as one:
# a quarter of a Philox4x32-10 call (100 integer ops), the mantissa trick
# 3, and for normals half of r = sqrt(-2 log1p(-u)) (4) and of the
# polynomial sincos (26) plus r*c
NOISE_OPS = {"normal": 25 + 3 + 2 + 13 + 1, "uniform": 25 + 3}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def validate(stats, nmoments, noise, block, bits, chunk):
    """The JAX package's checks and messages (pallas_kernels.py
    :2604-2620); returns (stats tuple or None, nstats)."""
    if stats is not None:
        stats = tuple(stats)
        if not 1 <= len(stats) <= 16:
            raise ValueError(f"stats must have 1..16 entries, "
                             f"got {len(stats)}")
        nstats = len(stats)
    else:
        if nmoments < 1 or nmoments > 8:
            raise ValueError(f"nmoments must be in [1, 8], got {nmoments}")
        nstats = nmoments
    if noise not in ("normal", "uniform"):
        raise ValueError(f"noise must be 'normal' or 'uniform', "
                         f"got {noise!r}")
    if block % 128:
        raise ValueError(f"block must be a multiple of 128, got {block}")
    _check_bits(bits, block, chunk)
    return stats, nstats


def leaves_of(thetas, what):
    """(leaves, structure) of a population: a tuple of ``[n]`` tensors
    (structure K) or one ``[n]`` tensor (structure None)."""
    if torch.is_tensor(thetas):
        leaves, structure = [thetas], None
    else:
        leaves, structure = list(thetas), len(thetas)
    if any(x.dim() != 1 for x in leaves):
        raise ValueError(
            f"{what} expects per-walker scalar parameters ([n] leaves); "
            f"got shapes {[tuple(x.shape) for x in leaves]}")
    if len({x.shape[0] for x in leaves}) > 1:   # the kernels read n of each
        raise ValueError(
            f"{what}: the theta leaves have different lengths "
            f"{[x.shape[0] for x in leaves]}")
    return [x.to(torch.float32).contiguous() for x in leaves], structure


def tree_of(leaves, structure):
    return leaves[0] if structure is None else tuple(leaves)


def summaries(x, stats, nstats):
    """The per-draw summaries: the stats, or the raw power chain x, x*x,
    (x*x)*x, ... of the kernels."""
    if stats is not None:
        return [g(x).to(torch.float32) for g in stats]
    out, xp = [], x
    for p in range(nstats):
        out.append(xp)
        if p + 1 < nstats:
            xp = xp * x
    return out


def _noise_pair(b1, b2, noise):
    if noise == "normal":
        return _box_muller(b1, b2)
    return to_unit(b1), to_unit(b2)


def streaming_moment_cost_plain(draw, stats, nstats, theta, seed, *, n,
                                ndraws, chunk, noise, bits, sb_rows, stream):
    """Plain version of ``simulate`` in ``csrc/generic.cuh``: the
    ``nstats`` moments of ``ndraws`` draws for every walker, vectorized
    over walkers, in the kernel's order (draw pairs l and l + 1 of one
    Philox call, half a and half b summed apart, then added to the
    totals a first). ``theta`` is the tree ``draw`` takes; ``seed`` a
    one-element int64 tensor."""
    dev = seed.device
    w = torch.arange(n, device=dev)
    pid, row, lane = w // sb_rows, (w % sb_rows) // 128, w % 128
    nchunks = -(-ndraws // (2 * chunk))
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    s = [zero] * nstats

    def add(acc, e):
        x = draw(theta, e).to(torch.float32)
        return [a + g for a, g in zip(acc, summaries(x, stats, nstats))]

    for j in range(nchunks):
        start_a, start_b = 2 * j * chunk, (2 * j + 1) * chunk
        ctr = 2 * (row * nchunks + j)
        a, b = [zero] * nstats, [zero] * nstats
        for l in range(0, min(chunk, ndraws - start_a), 2):
            if bits == "stub":
                words = [stub_bits(pid, seed, ctr + c, l + h, lane)
                         for h in (0, 1) for c in (0, 1)]
            else:
                words = philox4x32_10(j, w, stream, l >> 1, seed)
            for h in (0, 1):
                ll = l + h
                if ll >= chunk or start_a + ll >= ndraws:
                    break
                ea, eb = _noise_pair(words[2 * h], words[2 * h + 1], noise)
                a = add(a, ea)
                if start_b + ll < ndraws:
                    b = add(b, eb)
        s = [sp + ap for sp, ap in zip(s, a)]
        s = [sp + bp for sp, bp in zip(s, b)]
    inv_n = float(np.float32(1.0 / ndraws))
    return tuple(sp * inv_n for sp in s)


def _device_of(leaves):
    dev = leaves[0].device
    if any(x.device != dev for x in leaves):
        raise ValueError("theta leaves lie on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class StreamingMomentCost:
    """``batched(thetas, gen) -> costs[n]``, made by
    ``make_streaming_moment_cost``. ``moments`` and ``moments_plain``
    give the kernel's and the plain version's moments on the same
    inputs, for the checks on the card."""

    def __init__(self, draw, reduce_cost, *, stats, nstats, ndraws, noise,
                 block, chunk, walker_tiles, bits):
        self.draw, self.reduce_cost = draw, reduce_cost
        self.stats, self.nstats, self.ndraws = stats, nstats, ndraws
        self.noise, self.block, self.chunk = noise, block, chunk
        self.walker_tiles, self.bits = walker_tiles, bits
        self._units = {}
        # trace now: an unsupported op raises when the cost is built
        self.unit(codegen.probe_structure(draw))

    def unit(self, structure) -> codegen.Generated:
        """The generated translation unit for a theta structure."""
        if structure not in self._units:
            self._units[structure] = codegen.generate(
                self.draw, structure=structure, nstats=self.nstats,
                stats=self.stats, nmoments=self.nstats, noise=self.noise)
        return self._units[structure]

    def _sb_rows(self, n):
        return plan_tiles(n, self.block, self.walker_tiles)[1] * self.block

    def moments_plain(self, thetas, seed):
        leaves, structure = leaves_of(thetas, "make_streaming_moment_cost")
        n = leaves[0].shape[0]
        return streaming_moment_cost_plain(
            self.draw, self.stats, self.nstats, tree_of(leaves, structure),
            _seed_tensor(seed, leaves[0].device), n=n, ndraws=self.ndraws,
            chunk=self.chunk, noise=self.noise, bits=self.bits,
            sb_rows=self._sb_rows(n), stream=STREAM_GEN_COST)

    def moments(self, thetas, seed):
        """The moments: the plain version for CPU tensors, the kernel for
        CUDA tensors (``[nstats, n]`` rows)."""
        leaves, structure = leaves_of(thetas, "make_streaming_moment_cost")
        dev = _device_of(leaves)
        if dev.type == "cpu":
            return self.moments_plain(thetas, seed)
        n = leaves[0].shape[0]
        out = torch.empty((self.nstats, n), dtype=torch.float32, device=dev)
        self.launch(n, leaves, _seed_tensor(seed, dev), out, n,
                    structure=structure)
        return tuple(out)

    def geometry(self, n, structure):
        """``lane_groups.cost_geometry`` of ``n`` walkers for this model
        on the current card."""
        unit = self.unit(structure)
        return lane_groups.cost_geometry(
            n, self.nstats, lane_groups.sm_count(torch.cuda.current_device()),
            lane_groups.is_light(unit))

    def launch(self, n, leaves, seed, out, ld, *, structure, geometry=None):
        """Launch over the first ``n`` walkers of checked CUDA buffers:
        moment p of walker w goes to ``out.view(-1)[p*ld + w]``;
        ``geometry`` a ``lane_groups.Geometry`` (default
        ``self.geometry(n, structure)``)."""
        unit = self.unit(structure)
        lib = _build.load_generated(unit.source)
        g = self.geometry(n, structure) if geometry is None else \
            lane_groups.cost_check(n, geometry.walkers, geometry.threads,
                                   geometry.lanes, self.nstats,
                                   lane_groups.unit_lanes(unit.source))
        err = lib.kt_streaming_moment_cost(
            _build.pointers(leaves), seed.data_ptr(), out.data_ptr(), ld, n,
            self.ndraws, float(np.float32(1.0 / self.ndraws)),
            int(self.bits == "stub"), self._sb_rows(n), self.chunk,
            g.walkers, g.threads, g.lanes, _stream())
        _build.check(lib, err, "streaming_moment_cost")
        launches["streaming_moment_cost"] += 1

    def __call__(self, thetas, gen):
        return self.seeded(thetas, uint32_words(gen, 1))

    def seeded(self, thetas, seed):
        """The cost with a given seed (int64 tensor ``[1]`` on the
        thetas' device) instead of one drawn from a generator."""
        leaves, structure = leaves_of(thetas, "make_streaming_moment_cost")
        moments = self.moments(tree_of(leaves, structure), seed)
        return self.reduce_cost(tree_of(leaves, structure),
                                moments).to(torch.float32)

    def work(self, n, structure):
        """(bytes, operations) of one launch: the K leaves read and the
        nstats moments written once; per draw the noise, the user's draw
        and summaries and their sums."""
        unit = self.unit(structure)
        per_draw = (NOISE_OPS[self.noise] + unit.draw_ops + unit.stat_ops
                    + self.nstats)
        return (4 * n * (unit.nparams + self.nstats) + 8,
                n * (self.ndraws * per_draw + self.nstats))


def make_streaming_moment_cost(draw, reduce_cost, *, nmoments: int = 2,
                               stats=None, ndraws: int = 1000,
                               noise: str = "normal", block: int = 1024,
                               chunk: int = 512, walker_tiles: int = 8,
                               bits: str = "hw"):
    """Generic streaming simulator: bring your own model.

    draw : ``(theta, eps) -> x``, elementwise PyTorch; ``theta`` is the
        population's tree (a tuple of leaves for a ``Factored`` prior),
        each leaf broadcastable against ``eps``. Compiled into the kernel
        (``ops/codegen.py`` lists the supported ops; another op raises
        ``NotImplementedError`` here, when the cost is built).
    reduce_cost : ``(thetas, moments) -> costs``, plain PyTorch on
        ``[n]`` tensors: ``moments`` is a tuple of ``nmoments`` raw
        moments E[x^p] (or of E[g_j(x)] with ``stats``).
    stats : optional elementwise ``g_j(x)`` (1 to 16), streamed instead
        of the raw moments, e.g. ecdf probes
        ``lambda x: (x < t).to(torch.float32)``.
    noise : ``"normal"`` (Box-Muller, both halves) or ``"uniform"``.
    block, chunk, walker_tiles : the TPU kernel's tiling; they place the
        stub stream (``bits="stub"``) and the chunk partial sums.

    Returns ``batched(thetas, gen) -> costs[n]`` for
    ``smc(..., cost_vectorized=True)``: one uint32 seed per call is drawn
    from ``gen`` on its device. There is no ``interpret=``: CPU tensors
    run the plain version, CUDA tensors the kernel.
    """
    stats, nstats = validate(stats, nmoments, noise, block, bits, chunk)
    return StreamingMomentCost(
        draw, reduce_cost, stats=stats, nstats=nstats, ndraws=ndraws,
        noise=noise, block=block, chunk=chunk, walker_tiles=walker_tiles,
        bits=bits)
