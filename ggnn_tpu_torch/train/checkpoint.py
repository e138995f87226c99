"""Checkpoints in the JAX package's flat ``.npz`` format.

Counterpart of ``ggnn_tpu/train/checkpoint.py``: one ``.npz`` holding every
leaf under its ``/``-joined key path (dict keys, list indices) plus
``__meta__`` (json: step, epoch, extra).  A model saved by either package
loads into the other.  Restore maps leaves onto a template tree of the same
structure, checking shapes and casting to the template's dtype and device.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree: Any, step: int = 0, epoch: int = 0,
                    extra: dict | None = None) -> None:
    arrays = {key: _to_numpy(leaf) for key, leaf in _flatten(tree)}
    meta = dict(step=int(step), epoch=int(epoch), extra=extra or {})
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic: never leave a torn checkpoint


def load_checkpoint(path: str, template: Any):
    """Returns (tree shaped like ``template``, meta dict)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())

        def restore(tree, prefix=()):
            if isinstance(tree, dict):
                return {k: restore(v, prefix + (str(k),))
                        for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(restore(v, prefix + (str(i),))
                                  for i, v in enumerate(tree))
            key = "/".join(prefix)
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(tree.shape):
                raise ValueError(f"shape mismatch for {key!r}: {arr.shape} "
                                 f"vs {tuple(tree.shape)}")
            if torch.is_tensor(tree):
                return torch.as_tensor(arr, device=tree.device).to(tree.dtype)
            return arr.astype(np.asarray(tree).dtype)

        return restore(template), meta
