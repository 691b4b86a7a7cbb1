"""The readings a comparison with the reference accumulates: for each
named number the widest gap seen, and one count of exact mismatches
(``exact``) with a note of where they came from."""

from __future__ import annotations

import numpy as np
import torch


class Readings:
    def __init__(self, names=()):
        self.gaps = {name: 0.0 for name in names}
        self.exact = 0
        self.notes = []

    def gap(self, name, values):
        """Widen ``name`` to the largest of ``values`` (a tensor, possibly
        empty, or a number); NaN counts as infinitely wide."""
        if torch.is_tensor(values):
            if values.numel() == 0:
                return
            values = values.double()
            v = (float("inf") if bool(torch.isnan(values).any())
                 else float(values.max()))
        else:
            v = float(values)
            v = float("inf") if v != v else v
        self.gaps[name] = max(self.gaps.get(name, 0.0), v)

    def mismatch(self, what, count):
        count = int(count)
        if count:
            self.exact += count
            if len(self.notes) < 20:
                self.notes.append(f"{what}: {count}")

    def numbers(self, exact=True):
        out = dict(self.gaps)
        if exact:
            out["exact"] = self.exact
        return out


def rel_gap(got, want, floor=1.0):
    """|got - want| over max(|want|, floor), elementwise, in float64."""
    got, want = got.double(), want.double()
    return (got - want).abs() / torch.clamp(want.abs(), min=floor)


def sample(mask, rng, k):
    """Up to ``k`` distinct walkers drawn by ``rng`` among those where
    ``mask`` holds (sorted indices on the mask's device), or None."""
    pool = torch.nonzero(mask).flatten()
    if pool.numel() == 0:
        return None
    pos = torch.as_tensor(np.unique(rng.integers(0, pool.numel(), k)))
    return pool[pos.to(pool.device)]
