"""Device -> host materialization (counterpart of
``kissabc_tpu/utils/hostfetch.py``; the port runs in one process, so
there is nothing to all-gather)."""

from __future__ import annotations

import numpy as np
import torch


def fetch(x) -> np.ndarray:
    """``x.detach().cpu().numpy()`` for a tensor, ``np.asarray`` else."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
