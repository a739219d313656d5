"""Distribution of the port: logical-axis sharding rules resolved on a
torch ``DeviceMesh`` as DTensor placements, and activation constraints."""

from repro_torch.distributed.sharding import (
    DECODE_RULES,
    LONG_CONTEXT_RULES,
    TRAIN_RULES,
    ShardingRules,
    partition_spec_for,
    placements_for,
    rules_for_shape,
    tree_placements,
)

__all__ = [
    "ShardingRules",
    "TRAIN_RULES",
    "DECODE_RULES",
    "LONG_CONTEXT_RULES",
    "partition_spec_for",
    "placements_for",
    "tree_placements",
    "rules_for_shape",
]
