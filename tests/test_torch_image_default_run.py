"""The mnist image model's default run through the port's CLI on the CPU,
at a tiny width: a run dir with FID validation on image features stamped
``proxy``, the visualiser's PDFs and both checkpoints; then ``--resume``,
``--test`` (50,000 samples, ``metrics.json``) and ``--test-ood`` (the OOD
battery's dumps, summaries and stump accuracies, the latter against the JAX
package's rule) on that dir.

TensorBoard is blocked (importing it pulls in TensorFlow where that is
installed)."""

import json
import math
import os
import sys

import numpy as np
import pytest

from cmf_tpu.training import experiment as jax_experiment
from cmf_tpu_torch.main import main


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    # The CLI's writer tees stdout and stderr: put them back after each test.
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)


# ResNet couplers with no residual block (conv_in, relu, conv_out): on the
# CPU the 50,000 samples of --test run through the coupler kernel's plain
# version, whose cost grows with the blocks.
TINY = [
    "--config", "g_hidden_channels=[]", "--config", "prior_hidden_channels=[8]",
    "--config", "prior_num_density_layers=2", "--config", "latent_dimension=4",
    "--config", "fid_dims=256",
]


def _scalar_steps(run_dir, tag):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == f"mnist/{tag}"}


def test_cli_image_default_run_then_resume_test_and_ood(tmp_path):
    """mnist with every published default but the widths and these cuts:
    1000 images (one OOD batch a split), batches of 500, the warm-up from
    epoch 1 to 2, two epochs, a test every epoch, FID on 500 samples."""
    (setup,) = main([
        "--model", "non-square", "--dataset", "mnist", "--synthetic-data", "--device", "cpu",
        "--logdir-root", str(tmp_path), "--config", "max_epochs=2", "--config", "max_dataset_size=1000",
        "--config", "train_batch_size=500", "--config", "likelihood_warmup_start=1",
        "--config", "likelihood_warmup_end=2", "--config", "num_fid_samples=500",
        "--config", "test_batch_size=500", "--config", "epochs_per_test=1", "--config", "seed=0",
    ] + TINY)
    run_dir = setup["writer"].logdir
    config = json.load(open(os.path.join(run_dir, "config.json")))
    assert config["use_fid"] and config["early_stopping"] and not config["nosave"]
    assert config["log_jacobian_method"] == "hutch_with_cg"
    valid, test_fid = _scalar_steps(run_dir, "valid/loss"), _scalar_steps(run_dir, "test/fid")
    assert sorted(valid) == [2] and sorted(test_fid) == [1, 2]
    assert all(math.isfinite(v) for v in list(valid.values()) + list(test_fid.values()))
    assert open(os.path.join(run_dir, "test_feature_extractor.txt")).read() == "proxy"
    for name in ("samples_epoch1.pdf", "samples_epoch2.pdf"):
        assert os.path.getsize(os.path.join(run_dir, name)) > 0, name
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == ["best_valid.pt", "latest.pt"]

    config["max_epochs"] = 3
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(config, f)
    (resumed,) = main(["--resume", run_dir, "--device", "cpu"])
    assert resumed["trainer"].restored_from == "latest"
    assert [h[0] for h in resumed["trainer"].history] == [3, 3]
    assert sorted(_scalar_steps(run_dir, "valid/loss")) == [2, 3]
    assert os.path.exists(os.path.join(run_dir, "samples_epoch3.pdf"))

    (tested,) = main(["--test", "--resume", run_dir, "--device", "cpu"])
    assert tested["trainer"].restored_from == "best_valid"
    metrics = json.load(open(os.path.join(run_dir, "metrics.json")))
    assert metrics == tested["results"]
    assert metrics["feature_extractor"] == "proxy" and math.isfinite(metrics["fid"])

    (ood,) = main(["--test-ood", "--resume", run_dir, "--device", "cpu"])
    for split in ("train", "test"):
        for label in ("in", "out"):
            arr = np.load(os.path.join(run_dir, f"ood_metrics_{split}_{label}.npy"))
            assert arr.shape == (1000, 2) and np.isfinite(arr).all()
            np.testing.assert_array_equal(arr, ood["ood"][(label, split)])
    for dataset in ("mnist", "fashion-mnist"):
        for use_train in (True, False):
            summary = json.load(open(os.path.join(run_dir, f"ood_metrics_{dataset}_train={use_train}.json")))
            assert summary["n"] == 1000
    rates = ood["classification"]
    assert rates == jax_experiment.ood_classification(run_dir)
    assert all(0.5 <= v <= 1.0 for v in rates.values())
