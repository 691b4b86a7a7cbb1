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
