"""Host-side fan-out of a grid of runs (the port's copy of
``cmf_tpu/parallel/grid.py``). The device mesh waits for the parallel slice."""

from .grid import grid_jobs, host_shard

__all__ = ["grid_jobs", "host_shard"]
