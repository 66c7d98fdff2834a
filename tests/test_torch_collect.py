"""Run aggregation and the grid's shards: the port's ``analysis`` and
``parallel.grid`` against the JAX package's, on run dirs written by the
port's CLI.

A tiny non-square run on synthetic power goes through ``--test
--test-fid --resume``; its run dir is cloned into two λ arms of three seeds
each, one with a NaN FID and one without ``metrics.json``, with OOD arrays
and effective-z curves written into some. Both packages' ``collect_fid``,
``collect_test_loss``, ``collect_ood`` and ``collect_effective_z`` must give
equal rows, and ``write_csv`` identical bytes. The CLI's ``--grid-shard
i/n`` slices must partition the expanded (config × seed) jobs, and
``python -m cmf_tpu_torch.analysis tabular --retest`` must test the run that
lacks its metrics and write cmf_tpu's table.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from cmf_tpu import analysis as jax_analysis
from cmf_tpu.parallel import grid as jax_grid
from cmf_tpu_torch import analysis
from cmf_tpu_torch.main import main
from cmf_tpu_torch.parallel import grid

ROOT = Path(__file__).resolve().parent.parent

CUT = ["--config", "num_density_layers=2", "--config", "coupler_hidden_channels=[8]",
       "--config", "prior_num_density_layers=1", "--config", "prior_hidden_channels=[8]",
       "--config", "max_epochs=1", "--config", "max_dataset_size=200", "--config", "train_batch_size=100",
       "--config", "likelihood_warmup=False", "--config", "num_fid_samples=100", "--config", "early_stopping=False",
       "--config", "seed=0"]
LAMBDAS = (0, 1)
SEEDS = 3


def _quiet(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    # The CLI's writer tees stdout and stderr: put them back afterwards.
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)


@pytest.fixture(scope="module")
def runs_root(tmp_path_factory):
    """Two λ arms × 3 seeds cloned from one tested run dir of the port."""
    with pytest.MonkeyPatch.context() as mp:
        _quiet(mp)
        trained = tmp_path_factory.mktemp("trained")
        (setup,) = main(["--model", "non-square", "--dataset", "power", "--synthetic-data", "--device", "cpu",
                         "--logdir-root", str(trained)] + CUT)
        run_dir = Path(setup["writer"].logdir)
        main(["--test", "--test-fid", "--resume", str(run_dir), "--device", "cpu"])
    metrics = json.loads((run_dir / "metrics.json").read_text())
    assert math.isfinite(metrics["fid"]) and metrics["loss"] == 0.0

    root = tmp_path_factory.mktemp("runs")
    rng = np.random.default_rng(0)
    for lam in LAMBDAS:
        for seed in range(SEEDS):
            dst = root / "power" / f"lam{lam}_seed{seed}"
            shutil.copytree(run_dir, dst)
            config = json.loads((dst / "config.json").read_text())
            (dst / "config.json").write_text(json.dumps({**config, "metric_regularization_param": lam,
                                                         "seed": seed}))
            values = {**metrics, "fid": metrics["fid"] + float(rng.normal()), "loss": float(rng.normal())}
            if (lam, seed) == (1, 2):
                values["fid"] = float("nan")
            (dst / "metrics.json").write_text(json.dumps(values))
            if (lam, seed) == (0, 2):
                (dst / "metrics.json").unlink()
            if seed < 2:
                for split in ("train", "test"):
                    for label in ("in", "out"):
                        np.save(dst / f"ood_metrics_{split}_{label}.npy", rng.normal(size=(20, 2)))
            if seed == 0:
                (dst / "test_metric").mkdir()
                for which in ("fid", "recon"):
                    curve = {str(k): float(rng.uniform()) for k in range(1, 3)}
                    (dst / "test_metric" / f"{which}.json").write_text(json.dumps(curve))
    return root


def test_collect_fid_and_test_loss_match_cmf_tpu(runs_root, tmp_path):
    """NaN runs left out with the same warning, the run without metrics
    skipped, groups in ``str(key)`` order; the CSVs byte-equal."""
    for collect, jax_collect in ((analysis.collect_fid, jax_analysis.collect_fid),
                                 (analysis.collect_test_loss, jax_analysis.collect_test_loss)):
        got = collect(str(runs_root), out_csv=str(tmp_path / "port.csv"))
        want = jax_collect(str(runs_root), out_csv=str(tmp_path / "jax.csv"))
        assert got == want
        assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    rows = analysis.collect_fid(str(runs_root))
    assert [(r["metric_regularization_param"], r["n"]) for r in rows] == [(0, 2), (1, 2)]
    assert all(math.isfinite(r["mean"]) and r["stderr"] > 0 for r in rows)


def test_collect_ood_matches_cmf_tpu(runs_root, tmp_path):
    got = analysis.collect_ood(str(runs_root), out_csv=str(tmp_path / "port.csv"))
    want = jax_analysis.collect_ood(str(runs_root), out_csv=str(tmp_path / "jax.csv"))
    assert got == want and len(got) == len(LAMBDAS) * 2 * 2 * 2
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


@pytest.mark.parametrize("which", ["fid", "recon"])
def test_collect_effective_z_matches_cmf_tpu(runs_root, which):
    for kw in ({}, {"datasets": ["power"], "dims": [2], "lambdas": [1]}, {"datasets": ["mnist"]}):
        got = analysis.collect_effective_z(str(runs_root), which, **kw)
        assert got == jax_analysis.collect_effective_z(str(runs_root), which, **kw)
    assert sorted(analysis.collect_effective_z(str(runs_root), which)) == list(LAMBDAS)


def test_aggregate_and_write_csv_match_cmf_tpu(runs_root, tmp_path):
    key_fields = ("dataset", "metric_regularization_param")
    runs = list(analysis.scan_runs(str(runs_root), require_metrics=False))
    assert runs == list(jax_analysis.scan_runs(str(runs_root), require_metrics=False))
    assert sum(m is None for _, _, m in runs) == 1
    got = analysis.aggregate(runs, key_fields, "fid")
    assert got == jax_analysis.aggregate(runs, key_fields, "fid")
    analysis.write_csv(got, str(tmp_path / "port.csv"), key_fields, label="fid")
    jax_analysis.write_csv(got, str(tmp_path / "jax.csv"), key_fields, label="fid")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


@pytest.mark.parametrize("num_seeds, num_shards", [(1, 1), (3, 2), (5, 3)])
def test_grid_jobs_and_host_shard_match_cmf_tpu(num_seeds, num_shards):
    configs = [{"lr": 1e-3}, {"lr": 1e-4, "seed": 7}]
    jobs = grid.grid_jobs(configs, num_seeds, fixed_seed=11)
    assert jobs == jax_grid.grid_jobs(configs, num_seeds, fixed_seed=11)
    shards = [grid.host_shard(jobs, i, num_shards) for i in range(num_shards)]
    assert shards == [jax_grid.host_shard(jobs, i, num_shards) for i in range(num_shards)]
    assert sorted(map(str, sum(shards, []))) == sorted(map(str, jobs))


def test_cli_grid_shards_partition_the_expanded_jobs(monkeypatch, capsys):
    """``cond-affine`` on power is a two-config grid; with ``--num-seeds 3``
    six jobs. The shards ``i/2`` and ``i/4`` are disjoint and together the
    jobs of the unsharded call (the time-derived seeds made deterministic
    here)."""
    import cmf_tpu_torch.training as training

    def record(config, resume_dir=None, device=None):
        return config

    def run(extra):
        ticks = iter(range(1000))
        monkeypatch.setattr(grid, "time", types.SimpleNamespace(time=lambda: next(ticks) * 1e-6))
        return main(["--model", "cond-affine", "--dataset", "power", "--synthetic-data", "--num-seeds", "3",
                     "--device", "cpu", "--nosave"] + extra)

    monkeypatch.setattr(training, "train", record)
    everything = run([])
    assert len(everything) == 6 and len({c["seed"] for c in everything}) == 6
    for n in (2, 4):
        shards = [run(["--grid-shard", f"{i}/{n}"]) for i in range(n)]
        printed = capsys.readouterr().out
        for i, shard in enumerate(shards):
            assert shard == everything[i::n]
            assert f"Grid shard {i}/{n}: running {len(shard)} of the expanded jobs" in printed
        flat = [json.dumps(c, sort_keys=True) for c in sum(shards, [])]
        assert len(set(flat)) == len(flat) == 6
        assert sorted(flat) == sorted(json.dumps(c, sort_keys=True) for c in everything)


def test_analysis_cli_retests_and_writes_cmf_tpus_table(runs_root, tmp_path):
    """``python -m cmf_tpu_torch.analysis tabular --retest --device cpu``
    tests the run dir without ``metrics.json`` through the port's
    ``test_and_visualize``, then writes the (dataset, λ) FID table; the JAX
    package's aggregation of the same run dirs gives the same bytes. The
    ``fid`` and ``ood`` tables come from the same command line."""
    root = tmp_path / "runs"
    shutil.copytree(runs_root, root)
    out = tmp_path / "tabular_table.csv"
    env = {k: v for k, v in os.environ.items() if not k.startswith("CMF_TPU")}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-m", "cmf_tpu_torch.analysis", "tabular", "--runs", str(root),
                           "--out", str(out), "--retest", "--device", "cpu"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"re-testing {root / 'power' / 'lam0_seed2'}" in proc.stdout
    assert (root / "power" / "lam0_seed2" / "metrics.json").exists()
    key_fields = ("dataset", "metric_regularization_param")
    rows = jax_analysis.aggregate(jax_analysis.scan_runs(str(root)), key_fields, "fid")
    assert [r["n"] for r in rows] == [3, 2]
    jax_analysis.write_csv(rows, str(tmp_path / "jax.csv"), key_fields, label="fid")
    assert out.read_bytes() == (tmp_path / "jax.csv").read_bytes()

    from cmf_tpu_torch.analysis.__main__ import main as analysis_main

    for table, collect in (("fid", jax_analysis.collect_fid), ("ood", jax_analysis.collect_ood)):
        got = analysis_main([table, "--runs", str(root), "--out", str(tmp_path / f"{table}.csv")])
        assert got == collect(str(root))
