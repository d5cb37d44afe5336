from .mesh import (
    CORPUS_AXIS,
    DATA_AXIS,
    Mesh,
    Sharded,
    make_mesh,
    shard_rows,
)
from .multihost import (
    host_group,
    host_shard,
    initialize_multihost,
    is_first_host,
    local_device,
    world,
)

__all__ = ["CORPUS_AXIS", "DATA_AXIS", "Mesh", "Sharded", "host_group",
           "host_shard",
           "initialize_multihost", "is_first_host", "local_device",
           "make_mesh", "shard_rows", "world"]
