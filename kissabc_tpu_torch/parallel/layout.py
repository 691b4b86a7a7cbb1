"""Where a sampler's population lives: on one device (``OneDevice``) or
in shards over a mesh's walker axis (``OnMesh``). The samplers of
``core/`` are written once against this interface, and each sharded
path keeps the rule of ``core/smc.py``:

- every draw over the whole population is made on the generator's
  device, as the unsharded run makes it, and then cut into shards
  (``place``);
- a cost written in PyTorch runs on the joined population, and its
  costs are cut into shards; a kernel cost from ``shard_batched_cost``
  runs once per shard (``cost``);
- a gather of partners or ancestors reads the joined population
  (``join``);
- counts, sums and extremes are reduced over the mesh (``count``,
  ``fsum``, ``max``, ``min``).

A float sum is taken in float64 and rounded to float32 once, on one
device and on a mesh (the shards' float64 sums added over the mesh), so
the two layouts give the same float32 sum unless the two float64 sums
round to different float32 values, which needs them to lie within about
1e-16 of a rounding boundary.
"""

from __future__ import annotations

import torch

from ..ops.tree import tree_leaves
from ..utils.device import resolve_device
from . import mesh as M

_f32 = torch.float32


class OneDevice:
    """The population as plain tensors on one device."""

    mesh = None
    sharded = False

    def __init__(self, device):
        self.device = torch.device(device)

    def place(self, tree):
        return tree

    def join(self, x):
        return x

    def map(self, f, *parts):
        return f(*parts)

    def unzip(self, x, k):
        return tuple(x)

    def size(self, tree):
        """The walkers of a population."""
        return tree_leaves(tree)[0].shape[0]

    def count(self, mask):
        return mask.sum()

    def fsum(self, x):
        return x.to(torch.float64).sum().to(_f32)

    def max(self, x):
        return x.max()

    def min(self, x):
        return x.min()

    def cost(self, cost, thetas, gen, push=None):
        return cost(thetas if push is None else push(thetas), gen)


class OnMesh:
    """The population as ``Sharded`` blocks over ``mesh``'s walker axis;
    scalars on the mesh's home device."""

    sharded = True

    def __init__(self, mesh, axis="walker"):
        self.mesh, self.axis = mesh, axis
        self.device = mesh.home
        self.ndev = mesh.axis_size(axis)

    def place(self, tree):
        return tree if isinstance(tree, M.Sharded) else M.place(
            self.mesh, tree, self.axis)

    def join(self, x):
        return M.join(x)

    def map(self, f, *parts):
        return parts[0].map(f, *parts[1:])

    def unzip(self, x, k):
        return tuple(x.map(lambda o, i=i: o[i]) for i in range(k))

    def size(self, x):
        return x.n

    def count(self, mask):
        return M.psum(self.mesh, [m.sum() for m in mask.shards])

    def fsum(self, x):
        return M.psum(self.mesh, [v.to(torch.float64).sum()
                                  for v in x.shards]).to(_f32)

    def max(self, x):
        return M.pmax(self.mesh, [v.max() for v in x.shards])

    def min(self, x):
        return M.pmin(self.mesh, [v.min() for v in x.shards])

    def cost(self, cost, thetas, gen, push=None):
        """``cost(push(thetas), gen)`` of a sharded population: once per
        shard for a cost from ``shard_batched_cost``, else on the joined
        population (one all-gather) on the generator's device, its costs
        cut into shards."""
        if isinstance(cost, M.ShardedCost):
            return cost(thetas if push is None else thetas.map(push), gen)
        joined = self.join(thetas)
        return self.place(cost(joined if push is None else push(joined),
                               gen))


def layout(mesh, device, caller, cost=None, walkers=(),
           what="n={n} walkers"):
    """A sampler's layout: without a mesh ``OneDevice`` on
    ``resolve_device(device)`` (CUDA unless the caller names the CPU),
    else ``OnMesh(mesh)``, after checking that ``mesh`` is a ``Mesh`` on
    the device type asked for, that a kernel ``cost`` comes through
    ``shard_batched_cost`` for it (``check_cost``) and that its walker
    axis divides each count of ``walkers``."""
    if mesh is not None:
        check_mesh(mesh, caller)
    check_cost(cost, mesh, caller)
    if mesh is None:
        return OneDevice(resolve_device(device))
    if device is not None and torch.device(device).type != mesh.home.type:
        raise ValueError(f"{caller}: device={device!r} but the mesh's "
                         f"devices are {mesh.home.type}")
    for n in walkers:
        check_divides(n, mesh, what)
    return OnMesh(mesh)


def layout_of(x):
    """The layout of a vector: ``OnMesh`` for a ``Sharded`` one."""
    return OnMesh(x.mesh, x.axis) if isinstance(x, M.Sharded) \
        else OneDevice(x.device)


def check_mesh(mesh, caller):
    if not isinstance(mesh, M.Mesh):
        raise TypeError(
            f"{caller}(mesh=...) takes a Mesh with a 'walker' axis "
            f"(kissabc_tpu_torch.parallel.mesh.make_mesh), got "
            f"{type(mesh).__name__}")


def check_cost(cost, mesh, caller):
    """A kernel cost runs once per shard: on a mesh it comes through
    ``shard_batched_cost`` for the same mesh."""
    if isinstance(cost, M.ShardedCost):
        if cost.mesh is not mesh:
            raise ValueError(
                f"{caller}: a cost from shard_batched_cost runs on the SAME "
                "mesh as the population: pass it as mesh=")
    elif mesh is not None and callable(getattr(cost, "seeded", None)):
        raise ValueError(
            f"{caller}(mesh=...): a kernel cost runs once per shard on a "
            "mesh: pass shard_batched_cost(cost, mesh)")


def check_divides(n, mesh, what="n={n} walkers"):
    """The JAX wording for a population the walker axis does not
    divide."""
    ndev = M.walker_shards(mesh)
    if ndev > 1 and n % ndev:
        raise ValueError(f"{what.format(n=n)} must divide the mesh walker "
                         f"axis ({ndev} devices)")
