"""The port's CLI against the JAX package's ``main.py`` for the introspection
flags, byte for byte on stdout: ``--print-schema`` on a two-config grid (with
its ``Schema i`` headers) and on one config, and ``--print-model``. Then the
analyses of a finished run on the CPU: a tiny mnist run at d = 2 trained
with ``--profile-dir`` (a Chrome trace of epoch 2), then ``--test-center``,
``--two-dim-manifold`` and ``--test-metric`` on its run dir, each writing
what the JAX package's writes (``tests/test_torch_image_metric.py`` holds
the metric visualiser's files and numbers to cmf_tpu's); ``--test-metric``
raises in the raw-pixel effective-z FID after its figures, as cmf_tpu's
does.

TensorBoard is blocked (importing it pulls in TensorFlow where that is
installed)."""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

import main as jax_main
from cmf_tpu_torch.main import main


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    # The CLI's writer tees stdout and stderr: put them back after each test.
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)


def _stdout(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    return out.getvalue()


PRINT_CASES = {
    # A two-value GridParams (cmf_tpu/config/defaults/tabular.py:47).
    "schema-grid": ["--model", "cond-affine", "--dataset", "miniboone", "--print-schema"],
    "schema-one": ["--model", "non-square", "--dataset", "miniboone", "--print-schema"],
    "model": ["--model", "non-square", "--dataset", "miniboone", "--synthetic-data", "--print-model"],
}


@pytest.mark.parametrize("case", sorted(PRINT_CASES))
def test_introspection_prints_what_main_py_prints(case):
    argv = PRINT_CASES[case]
    got = _stdout(main, argv + ["--device", "cpu"])
    assert got == _stdout(jax_main.main, argv)
    if case == "schema-grid":
        assert got.count("========== Schema ") == 2 and "\n\n========== Schema 1 ==========\n\n" in got


def test_analyses_need_a_run_dir():
    for flag in ("--test-metric", "--test-center", "--two-dim-manifold"):
        with pytest.raises(SystemExit):
            main(["--model", "non-square", "--dataset", "mnist", flag, "--device", "cpu"])


# ResNet couplers with no residual block, as in test_torch_image_default_run.
TINY = [
    "--config", "g_hidden_channels=[]", "--config", "prior_hidden_channels=[8]",
    "--config", "prior_num_density_layers=2", "--config", "latent_dimension=2",
]
METRIC_FILES = [
    "metric_analysis.pdf",
    "plotted_samples_prominent_d/samples_cumulative.pdf",
    "plotted_samples_prominent_d/samples_hierarchical.pdf",
    "plotted_samples_prominent_d/samples_sequential.pdf",
    "prominent_z.pdf",
]


def _all_files(run_dir):
    return {os.path.relpath(os.path.join(d, f), run_dir) for d, _, fs in os.walk(run_dir) for f in fs}


def _new_files(run_dir, before):
    return sorted(_all_files(run_dir) - before)


def test_cli_analyses_of_a_d2_mnist_run(tmp_path):
    profile_dir = tmp_path / "profile"
    (setup,) = main([
        "--model", "non-square", "--dataset", "mnist", "--synthetic-data", "--device", "cpu",
        "--logdir-root", str(tmp_path / "runs"), "--profile-dir", str(profile_dir),
        "--config", "max_epochs=2", "--config", "max_dataset_size=100",
        "--config", "train_batch_size=50", "--config", "likelihood_warmup=False",
        "--config", "early_stopping=False", "--config", "use_fid=False", "--config", "seed=0",
    ] + TINY)
    run_dir = setup["writer"].logdir
    trainer = setup["trainer"]
    assert trainer.profile_path == str(profile_dir / "trace_epoch2.json")
    with open(trainer.profile_path) as f:
        trace = json.load(f)
    assert len(trace["traceEvents"]) > 100
    assert json.load(open(os.path.join(run_dir, "config.json")))["profile_dir"] == str(profile_dir)

    before = _all_files(run_dir)
    (centering,) = main(["--test-center", "--resume", run_dir, "--device", "cpu"])
    inputs, recon, recon_c = centering
    assert inputs.shape == recon.shape == recon_c.shape == (8, 1, 28, 28)
    # Centred inputs that leave [0, 256) decode to NaN through the logit
    # preprocessing, in both packages.
    assert np.isfinite(recon).all()
    assert _new_files(run_dir, before) == ["centering.pdf"]

    before = _all_files(run_dir)
    (grid,) = main(["--two-dim-manifold", "--resume", run_dir, "--device", "cpu"])
    assert grid.shape == (64, 1, 28, 28) and np.isfinite(grid).all()
    assert _new_files(run_dir, before) == ["two_dim_manifold.pdf"]

    before = _all_files(run_dir)
    with pytest.raises(ValueError, match="unstable even at jitter 1e-2"):
        main(["--test-metric", "--resume", run_dir, "--device", "cpu"])
    assert _new_files(run_dir, before) == METRIC_FILES
