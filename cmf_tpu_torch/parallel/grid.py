"""Grid-search / multi-seed fan-out scheduler: the port's copy of
``cmf_tpu/parallel/grid.py``.

The reference runs the expanded grid × seeds sequentially in one process
and users parallelise by launching processes manually. Here the (config,
seed) job list is deterministic, so distinct hosts or processes can each take
a strided shard (``--grid-shard i/n``) and run embarrassingly parallel;
``cmf_tpu_torch.analysis`` is the reduce step over the resulting run dirs.
"""

import time


def grid_jobs(grid, num_seeds, fixed_seed=None):
    """Expand configs × seeds into a deterministic job list.

    A fresh time-derived seed per run unless the config pins one (or
    fixed_seed forces determinism for tests).
    """
    jobs = []
    for c in grid:
        for s in range(num_seeds):
            job = dict(c)
            if "seed" not in job or num_seeds > 1:
                if fixed_seed is not None:
                    job["seed"] = fixed_seed + s
                else:
                    job["seed"] = int(time.time() * 1e6) % 2**32
            jobs.append(job)
    return jobs


def host_shard(jobs, shard_index, num_shards):
    """Strided slice of the job list for this host."""
    assert 0 <= shard_index < num_shards
    return jobs[shard_index::num_shards]
