"""Parallelism (``cmf_tpu/parallel`` in torch): the (data, model) mesh over
``torch.distributed`` with the explicit collectives that stand in for
GSPMD's (``mesh.py``), and the host-side fan-out of a grid of runs
(``grid.py``)."""

from .grid import grid_jobs, host_shard
from .mesh import (
    ColumnSpec,
    DataSharding,
    Mesh,
    all_reduce_gradients,
    batch_split,
    data_sharding,
    get_mesh,
    initialize_multihost,
    jacobian_column_partition,
    jacobian_column_spec,
    launched,
    psum_stats,
    replicate,
    set_jacobian_column_spec,
    shard_batch,
)

__all__ = [
    "get_mesh",
    "data_sharding",
    "replicate",
    "shard_batch",
    "initialize_multihost",
    "jacobian_column_partition",
    "jacobian_column_spec",
    "set_jacobian_column_spec",
    "grid_jobs",
    "host_shard",
    "psum_stats",
    "all_reduce_gradients",
    "batch_split",
    "launched",
    "ColumnSpec",
    "DataSharding",
    "Mesh",
]
