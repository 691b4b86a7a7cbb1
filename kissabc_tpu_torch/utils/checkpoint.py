"""Checkpoint / resume — the PyTorch counterpart of
``kissabc_tpu/utils/checkpoint.py``.

``save``/``load`` round-trip a tree of tensors (tuples, lists, dicts and
NamedTuples such as the smc loop state) through one ``.npz`` file. A
``torch.Generator`` leaf is saved as its ``get_state()`` bytes (on CUDA
the Philox seed and offset) and loaded back into the generator of the
template, so a resumed run continues the same random stream. Leaves are
named by their path (``.thetas`` then ``[0]``, as the JAX package names
them) and load onto the device of the template's leaf.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

_SEP = "\x1f"  # key-path separator inside the npz archive


def _flatten_with_paths(tree, path=()):
    """[(path, leaf)] in a fixed order; a leaf is anything that is not
    a tuple, list or dict."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    elif isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    else:
        return [(_SEP.join(path), tree)]
    out = []
    for name, v in items:
        out.extend(_flatten_with_paths(v, path + (name,)))
    return out


def _unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in the order of
    ``_flatten_with_paths``."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    return next(leaves)


def _to_numpy(leaf):
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, tree, meta: dict | None = None) -> None:
    """Persist a tree of tensors (atomic rename; a single file)."""
    payload = {key: _to_numpy(leaf)
               for key, leaf in _flatten_with_paths(tree)}
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load(path: str, like):
    """Load a checkpoint into the structure of ``like`` (a template tree
    of the same layout). Tensors land on the device of ``like``'s leaf
    (the CPU for a leaf that is not a tensor); a generator leaf of
    ``like`` gets the saved state and is returned. Returns (tree,
    meta)."""
    with np.load(path) as zf:
        meta = json.loads(bytes(zf["__meta__"]).decode() or "{}")
        arrays = {k: zf[k] for k in zf.files if k != "__meta__"}
    leaves = []
    for key, leaf in _flatten_with_paths(like):
        if key not in arrays:
            raise KeyError(
                f"checkpoint missing leaf {key!r} — the file layout does "
                "not match the current state structure (most likely the "
                "checkpoint was written by an older kissabc_tpu version "
                "whose loop state had different fields); delete the "
                "checkpoint and restart, or load it manually with "
                "numpy.load to migrate")
        if isinstance(leaf, torch.Generator):
            leaf.set_state(torch.from_numpy(arrays[key].copy()))
            leaves.append(leaf)
        else:
            dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
            leaves.append(torch.from_numpy(arrays[key].copy()).to(dev))
    return _unflatten(like, iter(leaves)), meta
