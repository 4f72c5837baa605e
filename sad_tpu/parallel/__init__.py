from .mesh import (
    batch_sharding,
    create_mesh,
    replicated_sharding,
    shard_batch_tree,
    spatial_sharding,
)

__all__ = [
    "create_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch_tree",
    "spatial_sharding",
]
