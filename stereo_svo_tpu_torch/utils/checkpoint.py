"""Checkpoint/resume: the whole SLAM state is one tree of tensors — port
of ``stereo_svo_tpu/utils/checkpoint.py``.

The file is the reference's v2 npz format, so a checkpoint written by
either package loads in the other: every leaf is stored under its key path
in the state (``.mu``, ``.klt_tmpl.patches``; a NamedTuple field is
``.name``, a dict entry ``['key']``, a sequence item ``[i]``), plus
``__checkpoint_format__ = 2``. Leaves missing from an older file keep the
template's value. The v1 ``leaf_{i}`` index format is read only when its
leaf count equals the template's: a mismatch raises instead of filling the
wrong fields.

Every leaf keeps the dtype it was saved with (int32 counters, bool masks,
float32 data), and a resumed run continues bit for bit.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve

_FORMAT_KEY = "__checkpoint_format__"


def _path_key(path: Tuple[str, ...]) -> str:
    return "".join(path) or "."


def flatten(tree, path: Tuple[str, ...] = ()) -> List[Tuple[str,
                                                            torch.Tensor]]:
    """(key, leaf) pairs in field order; the key is the leaf's path."""
    if hasattr(tree, "_fields"):                       # NamedTuple
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [(_path_key(path), tree)]
    return [kv for key, sub in items for kv in flatten(sub, path + (key,))]


def _unflatten(like, leaves):
    """Rebuild ``like``'s structure from an iterator over new leaves."""
    if hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def key_paths(state) -> List[str]:
    """The npz key of every leaf of ``state``, in field order."""
    return [k for k, _ in flatten(state)]


def save(path: str, state) -> None:
    leaves = flatten(state)
    arrays = {k: torch.as_tensor(x).detach().cpu().numpy()
              for k, x in leaves}
    assert len(arrays) == len(leaves), "duplicate key paths in the state"
    arrays[_FORMAT_KEY] = np.asarray(2)
    np.savez(path, **arrays)


def load(path: str, like, device=None):
    """Restore a state with the structure of ``like`` from ``path``.

    Fields of ``like`` not present in the file (newer code, older
    checkpoint) keep their ``like`` values. ``device``: where the restored
    leaves live; by default each goes where ``like``'s leaf is.
    """
    if device is not None:
        device = resolve(device)
    flat = flatten(like)

    def conv(a, x):
        target = device if device is not None else torch.as_tensor(x).device
        return torch.from_numpy(np.array(a)).to(target)

    with np.load(path) as data:
        if _FORMAT_KEY in data:
            new_leaves = [conv(data[k], x) if k in data
                          else (x if device is None else x.to(device))
                          for k, x in flat]
        else:                          # v1: index-keyed, exact match only
            n_file = sum(1 for k in data.files if k.startswith("leaf_"))
            if n_file != len(flat):
                raise ValueError(
                    f"v1 checkpoint {path!r} holds {n_file} leaves, the "
                    f"state has {len(flat)}: index-keyed files load only "
                    "into the state layout they were written from")
            new_leaves = [conv(data[f"leaf_{i}"], x)
                          for i, (_, x) in enumerate(flat)]
    return _unflatten(like, iter(new_leaves))
