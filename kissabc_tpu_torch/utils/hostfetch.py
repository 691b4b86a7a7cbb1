"""Device -> host materialization (counterpart of
``kissabc_tpu/utils/hostfetch.py``).

The port also runs over several processes (gloo or nccl meshes,
``parallel/distributed.py``). There the samplers join a sharded
population through ``parallel/layout.py`` ``join``, an all-gather that
leaves the whole population in every process, before they fetch it; so
``fetch`` itself only copies one process's tensor to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.tree import tree_map


def fetch(x) -> np.ndarray:
    """``x.detach().cpu().numpy()`` for a tensor, ``np.asarray`` else."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def fetch_tree(tree):
    """``fetch`` of every leaf of a tuple/list tree, its structure kept."""
    return tree_map(fetch, tree)
