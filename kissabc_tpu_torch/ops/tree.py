"""Particle-tuple algebra — the PyTorch counterpart of
``kissabc_tpu/ops/tree.py``.

The JAX package carries a population as a pytree with a leading walker
axis on every leaf. The port uses plain Python structure instead: a
population is a tuple of ``[n]`` or ``[n, k]`` tensors (one per
``Factored`` marginal), or a single tensor for a plain prior. Every
helper here maps over that structure.
"""

from __future__ import annotations

import torch


def tree_map(f, *trees):
    """Apply ``f`` leaf by leaf; a leaf is anything that is not a tuple
    or list."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(f, *parts) for parts in zip(*trees))
    return f(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [leaf for part in tree for leaf in tree_leaves(part)]
    return [tree]


def tfloat(a):
    """Float shadow of a particle (the reference's ``op(float, ...)``
    init): non-float leaves become float32, float leaves stay."""
    return tree_map(lambda x: x if x.is_floating_point()
                    else x.to(torch.float32), a)


def tselect(mask, a, b):
    """Per-walker select: ``mask`` is ``[n]``; leaves are ``[n, ...]``."""
    def sel(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
        return torch.where(m, x, y)
    return tree_map(sel, a, b)


def tgather(tree, idx):
    """Index every leaf's walker axis by ``idx``.

    1-D leaves sharing a length and dtype are packed into one ``[n, K]``
    row gather, as the JAX package does; value-identical to a per-leaf
    ``x[idx]``. Other leaves are gathered one by one."""
    leaves = tree_leaves(tree)
    groups = {}
    for i, x in enumerate(leaves):
        if x.dim() == 1:
            groups.setdefault((x.dtype, x.shape[0]), []).append(i)
    out = [None] * len(leaves)
    for ids in groups.values():
        if len(ids) < 2:
            continue
        packed = torch.stack([leaves[i] for i in ids], dim=1)[idx]
        for k, i in enumerate(ids):
            out[i] = packed[:, k]
    for i, x in enumerate(leaves):
        if out[i] is None:
            out[i] = x[idx]
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def tmap(f, *trees):
    """Elementwise map through the particle tree (the reference's ``op``,
    types.jl:15-25)."""
    return tree_map(f, *trees)


def tadd(a, b):
    return tree_map(torch.add, a, b)


def tsub(a, b):
    return tree_map(torch.subtract, a, b)


def tscale(a, s):
    """Multiply every leaf by a scalar (broadcasts over leading axes)."""
    return tree_map(lambda x: x * s, a)


def taxpy(a, x, y):
    """``a*x + y`` over the tree with scalar ``a``."""
    return tree_map(lambda xi, yi: a * xi + yi, x, y)


def tzeros_like(a):
    return tree_map(torch.zeros_like, a)


def leading_dim(tree) -> int:
    return tree_leaves(tree)[0].shape[0]


def sample_distinct(gen, n, exclude):
    """One index uniform over ``{0..n-1}`` minus ``exclude`` (k mutually
    distinct int scalars): draw ``u`` in ``[0, n-k)`` and bump it past
    each excluded value in ascending order — the branch-free
    construction of the JAX package, with no host read."""
    ex = torch.sort(torch.stack([torch.as_tensor(e) for e in exclude]))[0]
    u = torch.randint(0, n - len(exclude), (), generator=gen,
                      device=gen.device)
    for j in range(len(exclude)):
        u = u + (u >= ex[j]).to(u.dtype)
    return u
