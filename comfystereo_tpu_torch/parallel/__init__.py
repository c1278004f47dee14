from .sharding import (  # noqa: F401
    Mesh,
    NamedSharding,
    ShardedTensor,
    frame_row_sharding,
    frame_sharding,
    make_mesh,
    shard_batch,
    shard_tensor,
)
