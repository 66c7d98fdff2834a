"""Run aggregation: scan run dirs, join config.json with metrics.json, and
aggregate mean ± stderr over seeds. The port's copy of
``cmf_tpu/analysis/collect.py``; it reads the run dirs either package writes.

Contract: reference analysis/*.py (SURVEY.md §2.17) — all scripts share the
same scan-join-aggregate skeleton keyed by (metric_regularization_param,
latent_dimension), with NaN exclusion and warnings
(collect_results_fid.py:50-122, tabular_evaluate.py:94-110). This module is
the shared library; ``python -m cmf_tpu_torch.analysis`` is its command line.

In the grid fan-out (``parallel/grid.py``, ``--grid-shard``) this is the
reduce step: every host or process writes run dirs into a shared filesystem
and any host aggregates.
"""

import json
import os
from collections import defaultdict

import numpy as np


def scan_runs(runs_root, require_metrics=True):
    """Yield (run_dir, config, metrics|None) for every run directory."""
    if not os.path.isdir(runs_root):
        return
    for group in sorted(os.listdir(runs_root)):
        group_dir = os.path.join(runs_root, group)
        if not os.path.isdir(group_dir):
            continue
        candidates = [group_dir] + [
            os.path.join(group_dir, d) for d in sorted(os.listdir(group_dir))
        ]
        for run_dir in candidates:
            cfg_path = os.path.join(run_dir, "config.json")
            if not os.path.isfile(cfg_path):
                continue
            with open(cfg_path) as f:
                config = json.load(f)
            metrics_path = os.path.join(run_dir, "metrics.json")
            metrics = None
            if os.path.isfile(metrics_path):
                with open(metrics_path) as f:
                    metrics = json.load(f)
            elif require_metrics:
                continue
            yield run_dir, config, metrics


def aggregate(runs, key_fields, metric_name):
    """Group runs by config key tuple; mean ± stderr with NaN exclusion
    (tabular_evaluate.py:94-110 semantics)."""
    groups = defaultdict(list)
    for run_dir, config, metrics in runs:
        if metrics is None or metric_name not in metrics:
            continue
        key = tuple(config.get(k) for k in key_fields)
        value = metrics[metric_name]
        if value is None:
            continue
        groups[key].append((run_dir, float(value)))

    rows = []
    for key, entries in sorted(groups.items(), key=lambda kv: str(kv[0])):
        values = np.array([v for _, v in entries])
        finite = values[np.isfinite(values)]
        if len(finite) < len(values):
            print(
                f"WARNING: {len(values) - len(finite)} NaN run(s) excluded for key {key}"
            )
        if len(finite) == 0:
            continue
        mean = float(np.mean(finite))
        stderr = float(np.std(finite, ddof=1) / np.sqrt(len(finite))) if len(finite) > 1 else 0.0
        rows.append(
            {
                **dict(zip(key_fields, key)),
                "mean": mean,
                "stderr": stderr,
                "n": int(len(finite)),
            }
        )
    return rows


def write_csv(rows, path, key_fields, label="mean"):
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(key_fields) + [label, "stderr", "n"])
        for r in rows:
            w.writerow([r[k] for k in key_fields] + [r["mean"], r["stderr"], r["n"]])
    return path


def collect_fid(runs_root, out_csv=None, key_fields=("dataset", "metric_regularization_param", "latent_dimension")):
    """FID table keyed by (dataset, λ, d) — collect_results_fid.py:50-122."""
    rows = aggregate(scan_runs(runs_root), key_fields, "fid")
    if out_csv:
        write_csv(rows, out_csv, key_fields, label="fid")
    return rows


def collect_test_loss(runs_root, out_csv=None, key_fields=("dataset", "metric_regularization_param", "latent_dimension")):
    """Test log-lik/loss table — tabular_evaluate.py:25-115 analogue."""
    rows = aggregate(scan_runs(runs_root), key_fields, "loss")
    if out_csv:
        write_csv(rows, out_csv, key_fields, label="loss")
    return rows


def collect_ood(runs_root, out_csv=None):
    """OOD classification tables per dataset/split/feature —
    collect_results_ood.py:16-60."""
    rows = []
    for run_dir, config, _ in scan_runs(runs_root, require_metrics=False):
        found = {}
        for split in ("train", "test"):
            for label in ("in", "out"):
                p = os.path.join(run_dir, f"ood_metrics_{split}_{label}.npy")
                if os.path.isfile(p):
                    found[(split, label)] = np.load(p)
        for split in ("train", "test"):
            if (split, "in") in found and (split, "out") in found:
                arr_in, arr_out = found[(split, "in")], found[(split, "out")]
                for j, feature in enumerate(("likelihood", "reconstruction-error")):
                    rows.append(
                        {
                            "dataset": config.get("dataset"),
                            "split": split,
                            "feature": feature,
                            "auc_proxy_mean_diff": float(
                                np.nanmean(arr_out[:, j]) - np.nanmean(arr_in[:, j])
                            ),
                            "run": run_dir,
                        }
                    )
    if out_csv:
        import csv

        with open(out_csv, "w", newline="") as f:
            if rows:
                w = csv.DictWriter(f, fieldnames=list(rows[0]))
                w.writeheader()
                w.writerows(rows)
    return rows


def fid_vs_dim_plot(runs_root, out_pdf):
    """FID vs latent-dimension plot — collect_results_fid_dimplot.py."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = collect_fid(runs_root, key_fields=("dataset", "latent_dimension", "metric_regularization_param"))
    by_ds = defaultdict(list)
    for r in rows:
        by_ds[(r["dataset"], r["metric_regularization_param"])].append(r)
    fig, ax = plt.subplots(figsize=(7, 5))
    for (ds, lam), rs in sorted(by_ds.items(), key=lambda kv: str(kv[0])):
        rs = sorted(rs, key=lambda r: r["latent_dimension"] or 0)
        ax.errorbar(
            [r["latent_dimension"] for r in rs],
            [r["mean"] for r in rs],
            yerr=[r["stderr"] for r in rs],
            marker="o",
            label=f"{ds} λ={lam}",
        )
    ax.set_xlabel("latent dimension d")
    ax.set_ylabel("FID")
    ax.legend()
    fig.savefig(out_pdf)
    plt.close(fig)
    return out_pdf


def _method_label(lam):
    """λ → legend label (collect_effective_z_fid_plot.py:110-117)."""
    if lam in (0, 0.0, "0"):
        return "RNF"
    if str(lam) in ("0.1", "0.01"):
        return "CMF"
    return f"lam={lam}"


def collect_effective_z(runs_root, which, datasets=None, dims=None, lambdas=None):
    """Scan runs for ``test_metric/{fid,recon}.json`` effective-z curves
    (reference analysis/collect_effective_z_{fid,mse}_plot.py:44-96).

    ``which`` is "fid" or "recon". Returns {lambda: {effective_d: value}},
    filtered by the optional dataset / latent-dimension / lambda whitelists.
    Multiple runs with the same λ: the last one wins, matching the
    reference's in-place overwrite (collect_effective_z_fid_plot.py:96).
    """
    assert which in ("fid", "recon")
    curves = {}
    for run_dir, config, _metrics in scan_runs(runs_root, require_metrics=False):
        path = os.path.join(run_dir, "test_metric", f"{which}.json")
        if not os.path.exists(path):
            continue
        if datasets and config.get("dataset") not in datasets:
            continue
        if dims and config.get("latent_dimension") not in dims:
            continue
        lam = config.get("metric_regularization_param")
        if lambdas and lam not in lambdas:
            continue
        with open(path) as f:
            curve = json.load(f)
        curves[lam] = {int(k): float(v) for k, v in curve.items()}
    return curves


def effective_z_plot(runs_root, which, out_pdf, datasets=None, dims=None, lambdas=None):
    """Effective-d curve plot, one line per λ
    (collect_effective_z_{fid,mse}_plot.py:99-130)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    curves = collect_effective_z(runs_root, which, datasets, dims, lambdas)
    fig, ax = plt.subplots(figsize=(4, 4))
    for lam, curve in sorted(curves.items(), key=lambda kv: str(kv[0])):
        ks = sorted(curve)
        ax.plot(ks, [curve[k] for k in ks], "-o", ms=10, label=_method_label(lam))
    ax.set_xlabel("effective d", fontsize=10)
    ax.set_ylabel("FID score" if which == "fid" else r"$||x - \hat{x}||_2^2$", fontsize=10)
    handles, labels = ax.get_legend_handles_labels()
    ax.legend(handles[::-1], labels[::-1], loc=1, frameon=False, fontsize=10)
    fig.tight_layout()
    fig.savefig(out_pdf, bbox_inches="tight")
    plt.close(fig)
    return curves
