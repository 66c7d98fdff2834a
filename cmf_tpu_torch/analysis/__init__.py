"""Run aggregation over run dirs: the port's copy of ``cmf_tpu/analysis``."""

from .collect import (
    aggregate,
    collect_effective_z,
    collect_fid,
    collect_ood,
    collect_test_loss,
    effective_z_plot,
    fid_vs_dim_plot,
    scan_runs,
    write_csv,
)

__all__ = [
    "scan_runs", "aggregate", "write_csv", "collect_fid",
    "collect_test_loss", "collect_ood", "fid_vs_dim_plot",
    "collect_effective_z", "effective_z_plot",
]
