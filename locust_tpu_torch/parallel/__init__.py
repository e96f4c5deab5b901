"""The mesh tier on ``torch.distributed``: the flat and hierarchical
shuffle engines, one rank per process (port of ``locust_tpu/parallel``)."""

from locust_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    SLICE_AXIS,
    Mesh,
    initialize_multihost,
    make_mesh,
    make_mesh_2d,
    shard_rows,
)
from locust_tpu_torch.parallel.shuffle import (  # noqa: F401
    DistributedMapReduce,
    DistributedResult,
    RoundStats,
    ShardedCheckpoint,
    partition_to_bins,
)
from locust_tpu_torch.parallel.hierarchical import HierarchicalMapReduce  # noqa: F401
