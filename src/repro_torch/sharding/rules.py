"""Logical-axis -> mesh-axis sharding rules (``repro.sharding.rules``).

Every parameter and activation of the zoo carries a tuple of *logical*
axis names (``("embed", "mlp")``).  ``LogicalRules`` maps each logical
name to a mesh axis name, a tuple of them, or ``None``.  The mapping is
divisibility-aware: a rule applies only where the dimension divides by
the product of its mesh axes, else a shorter prefix of the axis tuple
is tried, else the dimension is replicated; each mesh axis shards at
most one dimension of an array.  That is what lets one rule set serve
4 to 64 heads, vocabularies of 504 to 262,144 and 8 to 60 experts on
the fixed 16 x 16 (x 2 pods) mesh.

``logical_to_spec`` reads only the mesh's axis sizes by name: from the
port's ``launch.mesh.Mesh`` (``.shape``, a mapping), from a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names`` and
``shape``), or from any object with a ``.shape`` mapping.  A spec is a
``PartitionSpec``: a tuple with one entry per array dimension, each
``None``, a mesh axis name, or a tuple of mesh axis names.

``placements`` turns a spec into DTensor placements, one per mesh
dimension: ``Shard(tensor_dim)`` or ``Replicate()``; a mesh axis of
size 1 gives ``Replicate()``, the same layout (DTensor's backward of
some reductions fails on a ``Shard`` over a size-1 mesh dim).  Where two mesh
axes shard one tensor dimension, DTensor splits in the mesh's
dimension order and JAX in the order the spec lists them.  For
``("pod", "data")`` on the (pod, data, model) mesh the two agree; for an
override such as ``"mlp": ("model", "data")`` they do not: each
device's shard has the same shape and bytes as under JAX, but which
device holds which block differs.  Shapes and byte counts are what the
port holds equal to the reference, nothing more.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class LogicalRules:
    """Mapping from logical axis name -> mesh axis (str | tuple | None)."""

    rules: Mapping[str, object]

    def mesh_axes_for(self, logical: str):
        return self.rules.get(logical, None)


# Logical vocabulary used across the zoo:
#   batch    - global batch dim                  -> data (+ pod)
#   seq      - sequence dim of activations       -> unsharded (default)
#   cache    - KV-cache sequence dim             -> sharded at decode
#   embed    - d_model rows of weight matrices   -> fsdp axis ("data")
#   mlp      - d_ff / hidden of MLPs             -> model
#   heads    - query heads                       -> model
#   kv_heads - kv heads (GQA, often small)       -> model (if divisible)
#   head_dim - per-head dim                      -> unsharded
#   vocab    - vocabulary                        -> model
#   expert   - MoE expert dim                    -> model (fallback data)
#   state    - SSM/recurrent state dim           -> model
#   conv     - conv kernel taps                  -> unsharded
#   norm     - norm scales                       -> unsharded

DEFAULT_RULES = LogicalRules(
    rules={
        "batch": "data",
        "seq": None,
        "cache": "model",
        "embed": "data",  # FSDP: shard d_model rows of weights over data
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "vocab": "model",
        "expert": "model",
        "capacity": "data",  # MoE dispatch-buffer capacity dim
        "state": None,
        "inner": "model",  # SSM expanded inner dim
        "conv": None,
        "norm": None,
        "act_embed": None,  # activations keep d_model replicated
    }
)

MULTIPOD_RULES = LogicalRules(
    rules={
        **DEFAULT_RULES.rules,
        "batch": ("pod", "data"),
        "embed": ("pod", "data"),
    }
)


class PartitionSpec(tuple):
    """One entry per array dimension: ``None``, a mesh axis name, or a
    tuple of mesh axis names (``PartitionSpec("data", None)``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict:
    """Mesh axis name -> size, for a ``DeviceMesh`` or anything with a
    ``.shape`` mapping (the port's ``Mesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(sizes: dict, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return sizes[axes]
    return math.prod(sizes[a] for a in axes)


def logical_to_spec(
    mesh,
    logical_axes: Sequence[str | None],
    dim_sizes: Sequence[int] | None,
    rules: LogicalRules,
) -> PartitionSpec:
    """Build a PartitionSpec for one array.

    A mesh axis is assigned to a dim only if the dim size divides evenly;
    each mesh axis may be used at most once per array.
    """
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    out = []
    for i, name in enumerate(logical_axes):
        axes = rules.mesh_axes_for(name) if name is not None else None
        if axes is None:
            out.append(None)
            continue
        axes_tuple = (axes,) if isinstance(axes, str) else tuple(axes)
        # drop axes already claimed by an earlier dim of this array and
        # keep the usable remainder (e.g. ("model","data") with "model"
        # taken by the expert dim still shards over "data")
        axes_tuple = tuple(a for a in axes_tuple if a not in used)
        if not axes_tuple:
            out.append(None)
            continue
        size = _axis_size(sizes, axes_tuple)
        if dim_sizes is not None and dim_sizes[i] % size != 0:
            # Try progressively shorter prefixes of the axis tuple.
            placed = False
            for k in range(len(axes_tuple) - 1, 0, -1):
                sub = axes_tuple[:k]
                if dim_sizes[i] % _axis_size(sizes, sub) == 0:
                    out.append(sub if len(sub) > 1 else sub[0])
                    used.update(sub)
                    placed = True
                    break
            if not placed:
                out.append(None)
            continue
        used.update(axes_tuple)
        out.append(axes_tuple[0] if len(axes_tuple) == 1 else axes_tuple)
    return PartitionSpec(*out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_logical_to_spec(mesh, logical_tree, shape_tree, rules: LogicalRules):
    """Map a tree (dicts and lists) of logical-axes tuples and a tree of
    the same structure whose leaves are tensors or shapes to
    PartitionSpecs."""
    if _is_axes(logical_tree):
        shape = (tuple(shape_tree.shape) if hasattr(shape_tree, "shape")
                 else tuple(shape_tree))
        if len(logical_tree) != len(shape):
            raise ValueError(f"logical axes {logical_tree} do not fit "
                             f"shape {shape}")
        return logical_to_spec(mesh, logical_tree, shape, rules)
    if isinstance(logical_tree, dict):
        return {k: tree_logical_to_spec(mesh, v, shape_tree[k], rules)
                for k, v in logical_tree.items()}
    if isinstance(logical_tree, list):
        return [tree_logical_to_spec(mesh, v, s, rules)
                for v, s in zip(logical_tree, shape_tree, strict=True)]
    raise TypeError(f"not a logical-axes tree: {logical_tree!r}")


def tree_logical_to_sharding(device_mesh, logical_tree, shape_tree,
                             rules: LogicalRules):
    """``tree_logical_to_spec`` on ``device_mesh``, each spec turned into
    its DTensor ``placements``."""
    return _map_specs(lambda s: placements(device_mesh, s),
                      tree_logical_to_spec(device_mesh, logical_tree,
                                           shape_tree, rules))


def _map_specs(fn, tree):
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return [_map_specs(fn, v) for v in tree]


def placements(device_mesh, spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` on ``device_mesh``: for each mesh
    dimension, ``Shard(d)`` where the spec's entry for tensor dim ``d``
    names that mesh axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in ((entry,) if isinstance(entry, str) else entry):
            where[axis] = d
    names = device_mesh.mesh_dim_names
    unknown = set(where) - set(names)
    if unknown:
        raise ValueError(f"spec {tuple(spec)} names mesh axes "
                         f"{sorted(unknown)} that mesh {names} lacks")
    sizes = axis_sizes(device_mesh)
    return tuple(Shard(where[n]) if n in where and sizes[n] > 1
                 else Replicate() for n in names)
