"""Pytree checkpoints: an npz payload and a json sidecar of the tree
(the port of ``repro.checkpoint.store``, in its file format).

A tree is nested dicts, lists and tuples whose leaves are tensors,
numpy arrays or numbers.  ``save_pytree(path, tree)`` writes
``path.npz`` (one array per leaf, named by its ``/``-joined path, dict
keys sorted) and ``path.json`` (the tree's structure and each leaf's
dtype).  npz has no bf16: bf16 leaves are stored as their uint16 bits
and the sidecar's dtype restores them.  Dict keys are written sorted,
as the JAX package's ``jax.tree.map`` leaves them, so a tree saved by
either package loads in the other and the sidecars of one tree are
byte-identical.  ``load_pytree`` returns CPU tensors (bf16 from its
bits, without ``ml_dtypes``).

``CheckpointManager`` keeps the best checkpoint by a metric (lower is
better) and the last ``keep_last`` steps, the paper's recipe for the
router trainer's early stopping.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

_SEP = "/"


def _array(leaf) -> np.ndarray:
    """A leaf as numpy, bf16 tensors as their uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    arr = np.asarray(leaf)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def _dtype(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _flatten_with_paths(tree):
    flat = {}

    def rec(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], prefix + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, prefix + [str(i)])
        else:
            flat[_SEP.join(prefix)] = _array(node)

    rec(tree, [])
    return flat


def _tree_structure(tree):
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _tree_structure(tree[k]) for k in sorted(tree)}}
    if isinstance(tree, tuple):
        return {"__kind__": "tuple",
                "items": [_tree_structure(v) for v in tree]}
    if isinstance(tree, list):
        return {"__kind__": "list",
                "items": [_tree_structure(v) for v in tree]}
    return {"__kind__": "leaf", "dtype": _dtype(tree)}


def _rebuild(struct, flat, prefix):
    kind = struct["__kind__"]
    if kind == "dict":
        return {k: _rebuild(v, flat, prefix + [k])
                for k, v in struct["items"].items()}
    if kind in ("tuple", "list"):
        seq = [_rebuild(v, flat, prefix + [str(i)])
               for i, v in enumerate(struct["items"])]
        return tuple(seq) if kind == "tuple" else seq
    arr = flat[_SEP.join(prefix)]       # a fresh array from the npz
    if struct.get("dtype") == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_pytree(path: str, tree) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", **_flatten_with_paths(tree))
    with open(path + ".json", "w") as f:
        json.dump(_tree_structure(tree), f)


def load_pytree(path: str):
    with open(path + ".json") as f:
        struct = json.load(f)
    with np.load(path + ".npz") as z:
        flat = {k: z[k] for k in z.files}
    return _rebuild(struct, flat, [])


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 2):
        self.dir = directory
        self.keep_last = keep_last
        self.best_metric = float("inf")
        os.makedirs(directory, exist_ok=True)
        self._steps: list[int] = []

    def save(self, step: int, tree, metric: float | None = None) -> None:
        path = os.path.join(self.dir, f"step_{step:08d}")
        save_pytree(path, tree)
        self._steps.append(step)
        if metric is not None and metric < self.best_metric:
            self.best_metric = metric
            for ext in (".npz", ".json"):
                shutil.copyfile(path + ext,
                                os.path.join(self.dir, "best" + ext))
        while len(self._steps) > self.keep_last:
            old = self._steps.pop(0)
            for ext in (".npz", ".json"):
                p = os.path.join(self.dir, f"step_{old:08d}" + ext)
                if os.path.exists(p):
                    os.remove(p)

    def load_best(self):
        return load_pytree(os.path.join(self.dir, "best"))

    def load_step(self, step: int):
        return load_pytree(os.path.join(self.dir, f"step_{step:08d}"))
