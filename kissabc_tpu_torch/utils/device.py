"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. There
is no silent fallback: asking for CUDA on a machine without a card
raises, so a run never reports CPU numbers as device numbers.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; ``"cpu"`` (or a CPU device) is taken only
    when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kissabc_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    return dev
