"""The sequential-simulator cost — the PyTorch counterpart of
``make_streaming_scan_cost`` in ``kissabc_tpu/ops/pallas_kernels.py``
(TPU kernel ``pallas_cost``, pallas_call at :3010).

For a Markovian simulator

    x_0     = init(theta)
    x_{t+1} = step(theta, x_t, eps_t, t),   eps ~ N(0,1) or U[0,1)
    cost_i  = reduce_cost(theta_i, (E_t[o_1], ..., E_t[o_k]))

with the per-step observations ``o = observe(theta, x_{t+1}, t, obs)``
summed over t and divided by ``nsteps``, the kernel
``kt_streaming_scan_cost`` (``csrc/scan.cuh``) runs each walker's path
in one thread, with ``init``, ``step`` and ``observe`` compiled into it
by ``ops/codegen.py``; ``reduce_cost`` runs in PyTorch on the ``[n]``
means, as in the JAX package. Beside it, ``streaming_scan_cost_plain``
repeats the kernel's arithmetic step by step with the user's own
callables on ``[n]`` tensors:

- a CPU tensor runs the plain version (the CPU tests);
- a CUDA tensor launches the kernel or raises — there is no fallback;
- ``launches`` counts the kernel's launches, ``walker_steps`` the
  walkers times steps simulated either way.

The model contract: ``theta`` is the population's tree (a tuple of
leaves for a ``Factored`` prior); the state ``x`` is one scalar or a
tuple of scalars; ``t`` is an int32 step index (``t % 2``, ``t + 1``,
comparisons with integers, ``t.float()``); ``obs`` is ``None`` or the
structure of ``series`` (one array, or a tuple or list of arrays of
shape ``(nsteps,)``) with one float per leaf, read at ``t``. The ops
are those of ``ops/codegen.py``; another raises ``NotImplementedError``
when the cost is built.

``bits="hw"`` is Philox4x32-10 (one call gives the noise of two pairs of
steps), ``bits="stub"`` the JAX package's stub stream at the TPU
kernel's coordinates: program ``w // (wt*block)``, slab ``ws`` of
``sub_rows`` rows within it, (row in slab, lane) of the walker, counter
``2*(ws*npairs + j)`` and ``+1`` for pair ``j``. There is no
``interpret=``: the plain version takes its place, chosen by the
tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.logging import register_counters, span
from ..utils.rng import uint32_words
from . import _build, codegen
from .kernels import (_check_bits, _seed_tensor, _stream, philox4x32_10,
                      plan_tiles, stub_bits)
from .streaming import NOISE_OPS, _device_of, _noise_pair, leaves_of, tree_of

# launches of the CUDA kernel since the last reset (plain ints), registered
# with the counters that each span records (utils/logging.py)
launches = register_counters("launches.", {"streaming_scan_cost": 0})
# walkers x steps simulated by ``means`` (the kernel or the plain
# version), registered as ``scan.walker_steps``
walker_steps = register_counters("scan.", {"walker_steps": 0})

# Philox stream (third counter word) of the scan kernel, as in csrc/scan.cuh
STREAM_SCAN = 6
# threads a block of the scan kernel (one walker a thread): 512 was the
# fastest of 64 to 512 at 131072 x 1000 steps on the H100 in two calls
# (PERF.md section 6)
SCAN_THREADS = 512


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


class Series:
    """The ``series`` argument (one array, or a tuple or list of arrays):
    its float32 leaves (numpy, host) and its structure rebuilt around one
    value per leaf."""

    def __init__(self, series, nsteps):
        self.container = (type(series) if isinstance(series, (tuple, list))
                          else None)
        leaves = list(series) if self.container else [series]
        self.leaves = [np.asarray(s, np.float32) for s in leaves]
        for s in self.leaves:
            if s.shape != (nsteps,):
                raise ValueError(
                    f"series leaves must have shape ({nsteps},), got "
                    f"{s.shape}")
        self.nleaves = len(self.leaves)
        self._dev = {}

    def __call__(self, values):
        """The series' structure around ``values`` (one per leaf)."""
        return self.container(values) if self.container else values[0]

    def on(self, device) -> torch.Tensor:
        """The leaves as one ``[nleaves, nsteps]`` float32 tensor on
        ``device``, copied there once."""
        if device not in self._dev:
            self._dev[device] = torch.from_numpy(
                np.stack(self.leaves)).to(device)
        return self._dev[device]


def slab_rows(n, block, walker_tiles, sub_rows):
    """(walker rows per program ``wt*block``, slab height): the TPU
    kernel's clamp of ``sub_rows`` to the largest multiple of 8 that
    divides the program's rows (pallas_kernels.py:2909-2924)."""
    _, wt = plan_tiles(n, block, walker_tiles)
    sb_rows = wt * block
    rows = sb_rows // 128
    if rows % 8:
        raise ValueError(
            f"walker_tiles*block = {sb_rows} gives {rows} view-rows "
            "per program, which is not a multiple of 8 (f32 sublane "
            "tile) — pick walker_tiles*block % 1024 == 0")
    sr = min(sub_rows, rows)
    while rows % sr or sr % 8:  # terminates: sr=8 always divides
        sr -= 8
    return sb_rows, sr


def _f32(v, like):
    """A model's output as float32, broadcast to the walkers of ``like``
    (``jnp.asarray(v, float32)`` and the slab broadcast of the TPU
    kernel)."""
    v = torch.as_tensor(v, device=like.device).to(torch.float32)
    return v.expand_as(like) if v.dim() == 0 else v


def _state_leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def streaming_scan_cost_plain(cost, theta, seed, *, n, sb_rows, sr):
    """Plain version of ``kt_streaming_scan_cost`` for the model of
    ``cost`` (a ``StreamingScanCost``): the ``nstats`` means over t of
    the observations, vectorized over walkers, step by step in the
    kernel's order. ``theta`` is the tree the model takes; ``seed`` a
    one-element int64 tensor."""
    dev = seed.device
    nsteps, g = cost.nsteps, cost.graphs
    w = torch.arange(n, device=dev)
    pid, rp, lane = w // sb_rows, (w % sb_rows) // 128, w % 128
    ws, sub = rp // sr, rp % sr
    npairs = -(-nsteps // 2)
    ref = torch.zeros(n, dtype=torch.float32, device=dev)
    x = [_f32(v, ref) for v in _state_leaves(cost.init(theta))]
    series = cost.series.on(dev) if cost.series is not None else None
    sums = [ref] * len(g.observe)

    def one_step(x, sums, e, t):
        tt = torch.tensor(t, dtype=torch.int32, device=dev)
        state = tuple(x) if g.state_is_tuple else x[0]
        x = [_f32(v, ref) for v in _state_leaves(
            cost.step(theta, state, e, tt))]
        obs = None if series is None else cost.series(list(series[:, t]))
        state = tuple(x) if g.state_is_tuple else x[0]
        vals = cost.observe(theta, state, tt, obs)
        return x, [s + _f32(v, ref) for s, v in zip(sums, vals)]

    for j in range(npairs):
        if cost.bits == "stub":
            ctr = 2 * (ws * npairs + j)
            b1 = stub_bits(pid, seed, ctr, sub, lane)
            b2 = stub_bits(pid, seed, ctr + 1, sub, lane)
        else:
            if j % 2 == 0:
                q = philox4x32_10(j >> 1, w, STREAM_SCAN, 0, seed)
            b1, b2 = q[2 * (j % 2)], q[2 * (j % 2) + 1]
        ea, eb = _noise_pair(b1, b2, cost.noise)
        x, sums = one_step(x, sums, ea, 2 * j)
        if 2 * j + 1 < nsteps:
            x, sums = one_step(x, sums, eb, 2 * j + 1)
    inv_n = float(np.float32(1.0 / nsteps))
    return tuple(s * inv_n for s in sums)


class StreamingScanCost:
    """``batched(thetas, gen) -> costs[n]``, made by
    ``make_streaming_scan_cost``. ``means`` and ``means_plain`` give the
    kernel's and the plain version's per-walker means on the same
    inputs, for the checks on the card."""

    # a call on the card is the seed's draw, #5's launch on the current
    # stream and ``reduce_cost``'s tensor arithmetic: smc records it in a
    # CUDA graph (core/smc.py ``_IterGraphs``)
    graph_safe = True

    def __init__(self, step, init, reduce_cost, *, nsteps, observe, series,
                 noise, block, sub_rows, walker_tiles, bits):
        self.step, self.init, self.observe = step, init, observe
        self.reduce_cost, self.nsteps = reduce_cost, nsteps
        self.series, self.noise, self.block = series, noise, block
        self.sub_rows, self.walker_tiles, self.bits = (sub_rows,
                                                       walker_tiles, bits)
        self._units = {}
        # trace now: an unsupported op or a broken contract raises here
        self.graphs = codegen.probe_scan(step, init, observe, series)
        self._units[self.graphs.structure] = self._generate(self.graphs)

    def _generate(self, graphs):
        return codegen.generate_scan(
            graphs, nseries=0 if self.series is None else self.series.nleaves,
            noise=self.noise)

    def unit(self, structure) -> codegen.GeneratedScan:
        """The generated translation unit for a theta structure."""
        if structure not in self._units:
            self._units[structure] = self._generate(codegen.trace_scan(
                self.step, self.init, self.observe, structure,
                series_tree=self.series))
        return self._units[structure]

    def _leaves(self, thetas):
        leaves, structure = leaves_of(thetas, "make_streaming_scan_cost")
        self.unit(structure)   # the model must trace on this structure
        return leaves, structure

    def means_plain(self, thetas, seed):
        leaves, structure = self._leaves(thetas)
        n = leaves[0].shape[0]
        sb_rows, sr = slab_rows(n, self.block, self.walker_tiles,
                                self.sub_rows)
        return streaming_scan_cost_plain(
            self, tree_of(leaves, structure),
            _seed_tensor(seed, leaves[0].device), n=n, sb_rows=sb_rows,
            sr=sr)

    def means(self, thetas, seed):
        """The means: the plain version for CPU tensors, the kernel for
        CUDA tensors (``[nstats, n]`` rows)."""
        leaves, structure = self._leaves(thetas)
        dev = _device_of(leaves)
        n = leaves[0].shape[0]
        walker_steps["walker_steps"] += n * self.nsteps
        if dev.type == "cpu":
            return self.means_plain(thetas, seed)
        out = torch.empty((self.unit(structure).nstats, n),
                          dtype=torch.float32, device=dev)
        self.launch(n, leaves, _seed_tensor(seed, dev), out, n,
                    structure=structure)
        launches["streaming_scan_cost"] += 1
        return tuple(out)

    def launch(self, n, leaves, seed, out, ld, *, structure, threads=None):
        """Launch over the first ``n`` walkers of checked CUDA buffers:
        mean p of walker w goes to ``out.view(-1)[p*ld + w]``; blocks of
        ``threads`` (default ``SCAN_THREADS``). Counts no launch."""
        unit = self.unit(structure)
        sb_rows, sr = slab_rows(n, self.block, self.walker_tiles,
                                self.sub_rows)
        # without a series the kernel reads none: any pointer will do
        series = (self.series.on(leaves[0].device).data_ptr()
                  if self.series is not None else out.data_ptr())
        lib = _build.load_generated(unit.source)
        err = lib.kt_streaming_scan_cost(
            _build.pointers(leaves), seed.data_ptr(), series,
            out.data_ptr(), ld, n, self.nsteps,
            float(np.float32(1.0 / self.nsteps)), int(self.bits == "stub"),
            sb_rows, sr, threads or SCAN_THREADS, _stream())
        _build.check(lib, err, "streaming_scan_cost")

    def __call__(self, thetas, gen):
        """The batched cost, in a ``scan.cost`` span: the seed's draw, the
        launch (or the plain version) and ``reduce_cost``."""
        with span("scan.cost"):
            return self.seeded(thetas, uint32_words(gen, 1))

    def seeded(self, thetas, seed):
        """The cost with a given seed (int64 tensor ``[1]`` on the
        thetas' device) instead of one drawn from a generator."""
        leaves, structure = self._leaves(thetas)
        tree = tree_of(leaves, structure)
        means = self.means(tree, seed)
        return self.reduce_cost(tree, means).to(torch.float32)

    def work(self, n, structure):
        """(bytes, operations) of one launch: the K leaves read, the
        series read and the nstats means written once; per walker the
        init, per step the noise, the user's step and observe and one
        add per observation."""
        u = self.unit(structure)
        per_step = NOISE_OPS[self.noise] + u.step_ops + u.observe_ops \
            + u.nstats
        return (4 * n * (u.nparams + u.nstats) + 4 * u.nseries * self.nsteps
                + 8, n * (u.init_ops + self.nsteps * per_step + u.nstats))


def make_streaming_scan_cost(step, init, reduce_cost, *, nsteps: int,
                             observe=None, nmoments: int = 2, series=None,
                             noise: str = "normal", block: int = 1024,
                             sub_rows: int = 64, walker_tiles: int = 8,
                             bits: str = "hw"):
    """Streaming kernel for sequential (Markovian) simulators: AR, OU,
    SIR, drifted Wiener processes.

    step : ``(theta, x, eps, t) -> x_next``, elementwise PyTorch; ``x``
        the state (a scalar or a tuple of scalars), ``eps`` one noise
        value, ``t`` the int32 step index 0..nsteps-1.
    init : ``(theta) -> x_0``; it may return constants.
    observe : ``(theta, x, t, obs) -> tuple`` of 1 to 16 values, run
        after each step on the new state; each is summed over t and
        divided by ``nsteps``. ``obs`` is the step's slice of ``series``
        or ``None``. Default: the raw moments ``(x, x**2, ...,
        x**nmoments)`` of a scalar state.
    series : optional array, or tuple or list of arrays, of shape
        ``(nsteps,)``: per-step constants (e.g. an observed time series).
    reduce_cost : ``(thetas, means) -> costs[n]``, plain PyTorch on
        ``[n]`` tensors that reads no value into Python: on one card smc
        records the cost's call in a CUDA graph (``graph_safe``).
    noise : ``"normal"`` or ``"uniform"``.
    block, sub_rows, walker_tiles : the TPU kernel's tiling; they place
        the stub stream (``bits="stub"``).

    Returns ``batched(thetas, gen) -> costs[n]`` for
    ``smc(..., cost_vectorized=True)``: one uint32 seed per call is drawn
    from ``gen`` on its device. CPU tensors run the plain version, CUDA
    tensors the kernel.
    """
    if nsteps < 1:
        raise ValueError(f"nsteps must be >= 1, got {nsteps}")
    if noise not in ("normal", "uniform"):
        raise ValueError(f"noise must be 'normal' or 'uniform', "
                         f"got {noise!r}")
    if block % 128:
        raise ValueError(f"block must be a multiple of 128, got {block}")
    if sub_rows % 8:
        raise ValueError(f"sub_rows must be a multiple of 8 (f32 sublane "
                         f"tile), got {sub_rows}")
    if observe is None:
        if nmoments < 1 or nmoments > 8:
            raise ValueError(f"nmoments must be in [1, 8], got {nmoments}")
        observe = codegen.default_observe(nmoments)
    series = None if series is None else Series(series, nsteps)
    _check_bits(bits, block, 1)
    return StreamingScanCost(
        step, init, reduce_cost, nsteps=nsteps, observe=observe,
        series=series, noise=noise, block=block, sub_rows=sub_rows,
        walker_tiles=walker_tiles, bits=bits)
