"""Device meshes and the walker collectives — the PyTorch counterpart of
``kissabc_tpu/parallel/mesh.py``.

The JAX package is a single controller: one program over a ``Mesh`` of
devices, population arrays split over its ``walker`` axis in contiguous
blocks of n/ndev walkers, collectives explicit (``ppermute``, ``psum``)
or inserted by GSPMD (an all-gather for a gather of partners or
ancestors). The port keeps those semantics with explicit shards::

    mesh = make_mesh(walker=4)                          # 4 cards
    mesh = make_mesh(walker=8, devices=["cpu"] * 8)     # 8 CPU shards
    res = kt.smc(prior, cost, nparticles=1 << 20, mesh=mesh)

A population on a mesh is a ``Sharded``: the trees of this process's
shards, each of n/ndev walkers on its own device. Every collective the
samplers need is written once here:

- ``psum``/``pmin``/``pmax``: a per-shard scalar reduced over the mesh
  (accept counts, the alive count, the bisect quantile's counts);
- ``exclusive_prefix``: the exclusive prefix of per-shard sums (the
  systematic resampler's cumulative weights);
- ``permute``: shard ``(i + k) mod ndev`` to shard ``i``, the building
  block of ``roll_walkers``;
- ``join``: the whole population on one device (an all-gather), for a
  gather of partners or ancestors across shards, as GSPMD lowers one.

Transport: within one process a transfer is a copy between the shards'
devices, ordered on the CUDA streams; across processes
(``parallel/distributed.py``) it goes through ``torch.distributed``:
point-to-point for ``permute``, ``all_reduce`` for sums, ``all_gather``
for gathers (gloo on the CPU, nccl on CUDA). A failed transfer raises;
nothing joins the population on the host to get round a collective.
``transfers`` counts the shard-sized transfers; a hook added with
``add_transport_hook`` sees each one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.tree import tree_leaves, tree_map

# shard-sized transfers since the last reset: one a destination shard and
# leaf for ``permute``, one a source shard and leaf for ``join``
transfers = {"permute": 0, "join": 0}
# values read on the host since the last reset: the partner shifts of a
# sharded ensemble half-update, once each (``partner_rolls``)
host_reads = {"shifts": 0}
_hooks = []


def reset_transfer_counts() -> None:
    for name in transfers:
        transfers[name] = 0
    host_reads["shifts"] = 0


def add_transport_hook(fn):
    """``fn(kind, src, dst, nbytes)`` is called for every shard-sized
    transfer (``src``/``dst`` global shard indices, ``dst`` None for a
    join); returns ``fn`` so a test can remove it again."""
    _hooks.append(fn)
    return fn


def remove_transport_hook(fn) -> None:
    _hooks.remove(fn)


def _count(kind, src, dst, x):
    transfers[kind] += 1
    for fn in _hooks:
        fn(kind, src, dst, x.numel() * x.element_size())


class Mesh:
    """``devices``: a numpy object array of ``torch.device`` shaped by the
    axis sizes; ``axis_names``; ``shape`` (a dict) and ``size``, as
    ``jax.sharding.Mesh``. ``ranks`` holds the process that owns each
    device (all 0 in one process; ``parallel/distributed.py`` builds a
    mesh over several); ``distributed``: the collectives go through the
    ``torch.distributed`` process group (a mesh of ``global_mesh``)."""

    def __init__(self, devices, axis_names, ranks=None, rank=0,
                 distributed=False):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.ranks = (np.zeros(devices.shape, np.int64) if ranks is None
                      else ranks)
        self.rank = rank
        self.process_count = int(self.ranks.max()) + 1
        self.distributed = distributed or self.process_count > 1

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"

    def axis_size(self, axis="walker") -> int:
        return self.shape.get(axis, 1)

    def _line(self, axis):
        """The (devices, ranks) along ``axis``; every other axis must have
        size 1."""
        if axis not in self.axis_names:
            raise ValueError(f"the mesh has no {axis!r} axis: "
                             f"{self.axis_names}")
        others = {a: k for a, k in self.shape.items() if a != axis}
        if any(k > 1 for k in others.values()):
            raise ValueError(
                f"a population sharded over {axis!r} needs the mesh's other "
                f"axes of size 1, got {self.shape}")
        i = self.axis_names.index(axis)
        devs = np.moveaxis(self.devices, i, 0).reshape(-1)
        ranks = np.moveaxis(self.ranks, i, 0).reshape(-1)
        return list(devs), [int(r) for r in ranks]

    def local(self, axis="walker") -> list:
        """The global indices of this process's shards along ``axis``."""
        return [g for g, r in enumerate(self._line(axis)[1])
                if r == self.rank]

    def device_of(self, g, axis="walker") -> torch.device:
        return self._line(axis)[0][g]

    def owner(self, g, axis="walker") -> int:
        return self._line(axis)[1][g]

    @property
    def home(self) -> torch.device:
        """This process's first device: the run's generator and its
        scalars (eps, counts, the stop flag) live there."""
        return next(d for d, r in zip(self.devices.flat, self.ranks.flat)
                    if r == self.rank)

    def take(self, axis, i) -> "Mesh":
        """The mesh of index ``i`` along ``axis``, that axis dropped: row
        ``i`` of a ``(chain, walker)`` mesh is the walker mesh of chain
        ``i``."""
        k = self.axis_names.index(axis)
        names = self.axis_names[:k] + self.axis_names[k + 1:]
        devs = np.take(self.devices, [i], axis=k)
        ranks = np.take(self.ranks, [i], axis=k)
        if not names:   # a one-axis mesh: its device as a mesh of one
            return Mesh(devs, ("walker",), ranks, self.rank,
                        self.distributed)
        return Mesh(np.squeeze(devs, k), names, np.squeeze(ranks, k),
                    self.rank, self.distributed)


def make_mesh(*, devices=None, **axes) -> Mesh:
    """``make_mesh(walker=4)`` over the first prod(sizes) CUDA devices, or
    over ``devices`` (a list of devices or names, which may name one
    device more than once: ``devices=["cpu"] * 8`` gives 8 CPU shards,
    ``["cuda:0"] * 4`` four shards on one card)."""
    names = tuple(axes)
    sizes = tuple(int(v) for v in axes.values())
    n = int(np.prod(sizes))
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise ValueError(f"mesh needs {n} devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = [torch.device(d) for d in devices]
    if n > len(devs):
        raise ValueError(f"mesh needs {n} devices, have {len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(sizes), names)


def walker_shards(mesh, axis="walker") -> int:
    """The number of shards of a population on ``mesh`` (1 without)."""
    return 1 if mesh is None else mesh.axis_size(axis)


class Sharded:
    """A population on a mesh's ``axis``: ``shards[j]`` is the tree (the
    population's structure: a tensor or a tuple of tensors) of this
    process's j-th shard, global index ``index[j]``, each of ``n //
    ndev`` walkers on its device."""

    def __init__(self, mesh, shards, n, axis="walker"):
        self.mesh, self.shards, self.n, self.axis = mesh, list(shards), n, \
            axis
        self.ndev = mesh.axis_size(axis)
        self.index = mesh.local(axis)
        if len(self.shards) != len(self.index):
            raise ValueError(f"{len(self.shards)} shards for the "
                             f"{len(self.index)} local shards of {mesh}")

    @property
    def s(self) -> int:
        return self.n // self.ndev

    def map(self, f, *others):
        """``f`` shard by shard (``others``: Sharded of the same mesh)."""
        return Sharded(self.mesh, [f(*parts) for parts in zip(
            self.shards, *(o.shards for o in others))], self.n, self.axis)

    def __repr__(self):
        return f"Sharded(n={self.n}, shards {self.index} of {self.ndev})"


def place(mesh, tree, axis="walker") -> Sharded:
    """The shards of a whole population ``tree`` (every leaf ``[n, ...]``,
    the same in every process): this process's blocks, each moved to its
    shard's device."""
    ndev = mesh.axis_size(axis)
    n = tree_leaves(tree)[0].shape[0]
    if n % ndev:
        raise ValueError(f"n={n} walkers must divide the mesh {axis} axis "
                         f"({ndev} devices)")
    s = n // ndev
    return Sharded(mesh, [
        tree_map(lambda x, g=g: x[g * s:(g + 1) * s].to(
            mesh.device_of(g, axis)), tree)
        for g in mesh.local(axis)], n, axis)


def join(sh: Sharded, device=None):
    """The whole population of ``sh`` on ``device`` (default the mesh's
    home), in every process: an all-gather."""
    mesh = sh.mesh
    dev = torch.device(device) if device is not None else mesh.home
    per_leaf = list(zip(*(tree_leaves(t) for t in sh.shards)))
    out = []
    for leaf_shards in per_leaf:
        for g, x in zip(sh.index, leaf_shards):
            _count("join", g, None, x)
        local = torch.cat([x.to(dev) for x in leaf_shards])
        if mesh.distributed:
            local = _all_gather(mesh, local)
        out.append(local)
    it = iter(out)
    return tree_map(lambda _: next(it), sh.shards[0])


def permute(sh: Sharded, k: int) -> Sharded:
    """Shard ``(i + k) mod ndev`` moved to shard ``i``, for every shard:
    one shard-sized transfer per leaf and destination shard."""
    mesh, ndev = sh.mesh, sh.ndev
    k %= ndev
    src = {g: j for j, g in enumerate(sh.index)}
    per_leaf = [tree_leaves(t) for t in sh.shards]
    nleaves = len(per_leaf[0])
    out = [[None] * nleaves for _ in sh.index]
    remote = []   # (dst position, leaf, source shard) received over the wire
    for j, g in enumerate(sh.index):
        gs = (g + k) % ndev
        dev = mesh.device_of(g, sh.axis)
        for leaf in range(nleaves):
            if gs in src:
                x = per_leaf[src[gs]][leaf]
                _count("permute", gs, g, x)
                out[j][leaf] = x.to(dev)
            else:
                remote.append((j, leaf, gs))
    if remote or mesh.distributed:
        _p2p_permute(sh, k, per_leaf, out, remote)
    trees = []
    for j, t in enumerate(sh.shards):
        it = iter(out[j])
        trees.append(tree_map(lambda _: next(it), t))
    return Sharded(mesh, trees, sh.n, sh.axis)


def roll_walkers(tree, shift, mesh, axis: str = "walker"):
    """``torch.roll(x, shift, 0)`` of the joined population, leaf by leaf,
    on a walker-sharded ``tree`` (a ``Sharded``) without joining it: with
    ``r = (-shift) mod n; q, t = divmod(r, s)``, shard i takes shard
    ``(i + q) mod ndev`` (one permute), then its successor's copy (a
    second permute), and keeps ``[t, t + s)`` of the two: exactly two
    shard-sized transfers per leaf and shard, whatever ndev is. The
    result is bit-identical to ``torch.roll``. ``shift`` is an int (or a
    tensor read once on the host: the transfers' sources depend on it).

    Falls back to ``torch.roll`` where the JAX package does: no mesh, a
    trivial axis, or a walker count that ``ndev`` does not divide; a
    plain tree with a mesh is placed on it first."""
    ndev = walker_shards(mesh, axis)
    if not isinstance(tree, Sharded):
        n = tree_leaves(tree)[0].shape[0]
        if ndev <= 1 or n % ndev or any(
                x.shape[0] != n for x in tree_leaves(tree)):
            return tree_map(lambda x: torch.roll(x, int(shift), 0), tree)
        tree = place(mesh, tree, axis)
    n, s = tree.n, tree.s
    r = (-int(shift)) % n
    q, t = divmod(r, s)
    ys = permute(tree, q)
    zs = permute(ys, 1)
    return ys.map(lambda y, z: tree_map(
        lambda a, b: torch.cat([a, b])[t:t + s], y, z), zs)


def partner_rolls(comp, shifts, mesh, axis: str = "walker"):
    """The six rolled copies of the complementary half ``comp`` (a
    ``Sharded`` of a tuple of leaves) that an ensemble half-update reads
    its partners from, ``comp[(i + r_j) % h]`` for the shifts ``r_j``:
    the counterpart of ``_partner_rolls`` (pallas_kernels.py:1137-1150).
    Returns a ``Sharded`` whose shard holds the partner leaves
    leaf-major (leaf k's six copies at ``6k .. 6k + 5``), each
    bit-identical to ``torch.roll(leaf, -r_j)``'s block: ``roll_walkers``
    of each shift, 2 shard-sized transfers per leaf, shift and shard, and
    no join. The shifts pick the transfers' sources: a tensor of them is
    read on the host once (``host_reads["shifts"]``)."""
    if torch.is_tensor(shifts):
        host_reads["shifts"] += 1
        shifts = shifts.tolist()
    rolled = [roll_walkers(comp, -int(r), mesh, axis) for r in shifts]
    nleaves = len(tree_leaves(comp.shards[0]))
    return Sharded(mesh, [
        [tree_leaves(rolled[j].shards[s])[k] for k in range(nleaves)
         for j in range(len(shifts))]
        for s in range(len(comp.shards))], comp.n, axis)


def constrainer(mesh, *axis_names):
    """``constrain(tree)``: without a mesh the identity; with one, the
    tree's leaves placed as shards on the mesh's first named axis (a
    ``Sharded`` passes through)."""
    if mesh is None:
        return lambda tree: tree
    axis = axis_names[0] if axis_names else "walker"

    def constrain(tree):
        return tree if isinstance(tree, Sharded) else place(mesh, tree, axis)

    return constrain


# ---------------------------------------------------------------------------
# reductions of per-shard scalars
# ---------------------------------------------------------------------------

def _reduce(mesh, parts, how):
    home = mesh.home
    vals = torch.stack([p.to(home) for p in parts])
    out = {"sum": vals.sum, "min": vals.min, "max": vals.max}[how]()
    if mesh.distributed:
        import torch.distributed as dist
        op = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
              "max": dist.ReduceOp.MAX}[how]
        dist.all_reduce(out, op=op)
    return out


def psum(mesh, parts):
    """The sum over the mesh of one scalar tensor per local shard, on the
    home device."""
    return _reduce(mesh, parts, "sum")


def pmin(mesh, parts):
    return _reduce(mesh, parts, "min")


def pmax(mesh, parts):
    return _reduce(mesh, parts, "max")


def exclusive_prefix(mesh, parts, axis="walker"):
    """For each local shard, the sum of the per-shard scalars ``parts`` of
    every shard before it along ``axis`` (float64, on the shard's
    device): the offset of its block in a global cumulative sum."""
    ndev = mesh.axis_size(axis)
    home = mesh.home
    idx = mesh.local(axis)
    vals = torch.zeros(ndev, dtype=torch.float64, device=home)
    vals[idx] = torch.stack([p.to(home).to(torch.float64) for p in parts])
    if mesh.distributed:
        import torch.distributed as dist
        dist.all_reduce(vals)   # each shard's sum written by its owner
    before = torch.cumsum(vals, 0) - vals
    return [before[g].to(mesh.device_of(g, axis)) for g in idx]


# ---------------------------------------------------------------------------
# transport across processes (torch.distributed)
# ---------------------------------------------------------------------------

def _all_gather(mesh, local):
    """Every process's ``local`` (the concatenation of its shards, all of
    one size), joined in process order."""
    import torch.distributed as dist
    parts = [torch.empty_like(local) for _ in range(mesh.process_count)]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts)


def _p2p_permute(sh, k, per_leaf, out, remote):
    """The transfers of ``permute`` between processes: every local shard
    whose destination ``(g - k) mod ndev`` lives in another process is
    sent there, every ``remote`` entry received, in one batch
    (``batch_isend_irecv``: a group of NCCL calls, or gloo's pairs).
    Both sides post in (destination shard, leaf) order, tagged by it."""
    import torch.distributed as dist
    mesh, ndev = sh.mesh, sh.ndev
    nleaves = len(per_leaf[0])
    sends, recvs = [], []
    for j, g in enumerate(sh.index):
        dst = (g - k) % ndev
        peer = mesh.owner(dst, sh.axis)
        if peer != mesh.rank:
            for leaf in range(nleaves):
                sends.append((dst, leaf, peer, per_leaf[j][leaf]
                              .contiguous()))
    for j, leaf, gs in remote:
        buf = torch.empty_like(per_leaf[0][leaf])
        recvs.append((sh.index[j], leaf, mesh.owner(gs, sh.axis), buf, j))
    ops = []
    for dst, leaf, peer, x in sorted(sends, key=lambda e: e[:2]):
        _count("permute", (dst + k) % ndev, dst, x)
        ops.append(dist.P2POp(dist.isend, x, peer, tag=dst * nleaves + leaf))
    for g, leaf, peer, buf, _ in sorted(recvs, key=lambda e: e[:2]):
        ops.append(dist.P2POp(dist.irecv, buf, peer,
                              tag=g * nleaves + leaf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for g, leaf, _, buf, j in recvs:
        out[j][leaf] = buf.to(mesh.device_of(g, sh.axis))


# ---------------------------------------------------------------------------
# a batched cost run once per shard
# ---------------------------------------------------------------------------

SEED_STRIDE = 1 << 20   # shard g's seed: seed + (g + 1) * SEED_STRIDE


def fold_seed(seed, g):
    """Shard ``g``'s seed from a seed word (int64 tensor holding a
    uint32): ``seed + (g + 1) * 2**20 mod 2**32``, the JAX fused sweep's
    rule (pallas_kernels.py:2467-2472), distinct for every shard."""
    return (seed + (g + 1) * SEED_STRIDE) % (1 << 32)


class ShardedCost:
    """``cost(thetas, gen)`` on a population ``Sharded`` over ``mesh``:
    one seed word drawn from ``gen`` (as the unsharded cost draws it),
    then ``cost_batched.seeded(shard, fold_seed(seed, g))`` once per
    shard on the shard's device. Made by ``shard_batched_cost``."""

    def __init__(self, cost_batched, mesh, axis="walker"):
        if not callable(getattr(cost_batched, "seeded", None)):
            raise TypeError(
                "shard_batched_cost takes a kernel cost with a seeded("
                "thetas, seed) form: make_flagship_cost_batched(), "
                "make_streaming_moment_cost(...) or "
                "make_streaming_scan_cost(...); a cost written in PyTorch "
                "runs on a mesh as it is (on the joined population)")
        self.cost, self.mesh, self.axis = cost_batched, mesh, axis

    def __call__(self, thetas, gen):
        from ..utils.rng import uint32_words
        if not isinstance(thetas, Sharded):
            thetas = place(self.mesh, thetas, self.axis)
        seed = uint32_words(gen, 1)
        return Sharded(self.mesh, [
            self.cost.seeded(t, fold_seed(seed, g).to(
                self.mesh.device_of(g, self.axis)))
            for g, t in zip(thetas.index, thetas.shards)], thetas.n,
            self.axis)


def shard_batched_cost(cost_batched, mesh, axis: str = "walker"):
    """Make a batched kernel cost mesh-ready, as the JAX package's
    ``shard_batched_cost`` (pallas_kernels.py:2500-2529): it runs once per
    shard on the shard's device, with the shard folded into its seed, so
    every shard draws its own stream (the kernels #1, #4 and #5 launch
    once per shard)::

        cost = shard_batched_cost(make_flagship_cost_batched(), mesh)
        smc(prior, cost, cost_vectorized=True, mesh=mesh, ...)
    """
    return ShardedCost(cost_batched, mesh, axis)


__all__ = ["Mesh", "make_mesh", "roll_walkers", "partner_rolls",
           "constrainer", "Sharded", "host_reads",
           "place", "join", "permute", "psum", "pmin", "pmax",
           "exclusive_prefix", "transfers", "reset_transfer_counts",
           "add_transport_hook", "remove_transport_hook", "walker_shards",
           "shard_batched_cost", "ShardedCost", "fold_seed"]
