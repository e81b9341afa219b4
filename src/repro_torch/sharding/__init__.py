"""Logical sharding rules and activation pins on a
``torch.distributed.device_mesh.DeviceMesh`` (``repro.sharding``)."""

from repro_torch.sharding.context import activation_sharding, shard_act
from repro_torch.sharding.rules import (
    DEFAULT_RULES,
    MULTIPOD_RULES,
    LogicalRules,
    PartitionSpec,
    logical_to_spec,
    placements,
    tree_logical_to_sharding,
    tree_logical_to_spec,
)

__all__ = [
    "activation_sharding",
    "shard_act",
    "LogicalRules",
    "DEFAULT_RULES",
    "MULTIPOD_RULES",
    "PartitionSpec",
    "logical_to_spec",
    "placements",
    "tree_logical_to_sharding",
    "tree_logical_to_spec",
]
