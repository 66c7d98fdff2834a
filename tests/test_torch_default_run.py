"""The flagship's default run in the port (validation by FID, early
stopping, the test pass, checkpoints, ``--resume`` and ``--test``) against
the JAX package: the same validation decisions on a scripted curve, the same
test epochs and scalars, the same first-epoch batch order, the last finite
state kept at a NaN epoch, and the CLI end to end on the CPU at small widths.

TensorBoard is blocked (importing it pulls in TensorFlow where that is
installed); ``tests/test_torch_writer.py`` checks the writer's use of it.
"""

import json
import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

from cmf_tpu.data.loaders import ArrayLoader as JaxArrayLoader
from cmf_tpu.data.loaders import get_loaders as jax_get_loaders
from cmf_tpu.eval.fid import get_fid_function as jax_get_fid_function
from cmf_tpu.models import get_density as jax_get_density
from cmf_tpu.training import experiment as jax_experiment
from cmf_tpu.training.trainer import EarlyStop as JaxEarlyStop
from cmf_tpu.training.trainer import Trainer as JaxTrainer
from cmf_tpu_torch.config import get_schema
from cmf_tpu_torch.data import ArrayLoader
from cmf_tpu_torch.main import main
from cmf_tpu_torch.models import get_density
from cmf_tpu_torch.training import EarlyStop, Trainer, Writer, experiment, get_objective, make_optimizer

from _torch_parity import DIM, batch, small_config, small_schema, t


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    # The CLI's writer tees stdout and stderr: put them back after each test.
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)


class _Recorder:
    """A writer that records what it is asked to write, for both packages."""

    def __init__(self):
        self.events = []

    def write_scalar(self, tag, value, global_step=None):
        self.events.append(("scalar", tag, float(value), global_step))

    def write_textfile(self, tag, text):
        self.events.append(("text", tag, text))

    def write_checkpoint(self, tag, data):
        self.events.append(("checkpoint", tag, data["epoch"]))

    def load_checkpoint(self, tag):
        raise FileNotFoundError(tag)


def _port_trainer(**kw):
    density = get_density(small_schema(), x_shape=(DIM,), device="cpu", generator=torch.Generator().manual_seed(3))
    objective = get_objective(small_config(likelihood_warmup=False))
    trainer = Trainer(density, objective, [make_optimizer({"lr": 1e-3}, density.parameters())], None,
                      max_epochs=1, generator=torch.Generator().manual_seed(0), **kw)
    return trainer


def _jax_trainer(**attrs):
    """A JAX ``Trainer`` with only the attributes its evaluation methods
    read; checkpoints are recorded by tag and epoch."""
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.__dict__.update(
        density=None, params={}, model_state={}, rng=jax.random.PRNGKey(0), batch_sharding=None,
        _eval_cache={}, best_valid_loss=float("inf"), num_bad_valid_epochs=0, epoch=0, visualizer=None,
        test_metrics_fn=None, valid_loss_fn=None, fid_function=None, should_checkpoint_best_valid=True,
    )
    jt.__dict__.update(attrs)
    jt._save_checkpoint = lambda tag: jt.writer.events.append(("checkpoint", tag, jt.epoch))
    return jt


def _scripted(values, jitters=None):
    """A FID function that returns ``values`` in turn, for either package's
    call signature, with the stamps of a raw-feature FID."""

    def fid(*args):
        i = fid.calls
        fid.calls += 1
        fid.last_jitter = (jitters or {}).get(i, 0.0)
        return values[i]

    fid.calls = 0
    fid.feature_extractor = "raw-features"
    return fid


CURVE = [5.0, 4.0, 4.5, float("nan"), 3.0, 3.0, 3.5, float("inf"), 3.2, 3.1, 2.0, 2.5, 2.6, 2.7, 2.8]


def _events_json(events):
    return json.dumps(events)  # NaN and inf compare by their JSON spelling


def _validation_run(package, start, epochs, **kw):
    """Validate after each of ``epochs`` epochs until ``EarlyStop``: (the
    writer's events, (epoch, best, bad) after each epoch, the stop epoch)."""
    if package == "port":
        trainer = _port_trainer(early_stopping=True, **kw)
        trainer.writer = _Recorder()
        stop = EarlyStop
    else:
        trainer = _jax_trainer(writer=_Recorder(), early_stopping=True, **kw)
        stop = JaxEarlyStop
    trainer.early_stopping_start_epoch = start
    log, stopped = [], None
    for epoch in range(1, epochs + 1):
        trainer.epoch = epoch
        try:
            trainer._validate(epoch)
        except stop:
            stopped = epoch
            break
        finally:
            log.append((epoch, trainer.best_valid_loss, trainer.num_bad_valid_epochs))
    return _events_json(trainer.writer.events), _events_json(log), stopped


@pytest.mark.parametrize("valid_frequency,best_valid", [(1, True), (2, True), (1, False)],
                         ids=["every-epoch", "every-second-epoch", "no-best-valid-checkpoint"])
def test_validation_decisions_match_cmf_tpu(valid_frequency, best_valid):
    """FID as the validation loss from ``early_stopping_start_epoch`` on:
    the same best epochs, bad counts, stop epoch and checkpoint tags."""
    start, runs = 3, []
    for package in ("cmf_tpu", "port"):
        runs.append(_validation_run(
            package, start, 3 + 2 * len(CURVE), max_bad_valid_epochs=3, valid_frequency=valid_frequency,
            fid_function=_scripted(CURVE), should_checkpoint_best_valid=best_valid,
        ))
    assert runs[0] == runs[1]
    events = json.loads(runs[1][0])
    assert runs[1][2] is not None  # the curve stops early
    assert ("checkpoint", "nan_during_validation") in {tuple(e[:2]) for e in events}
    assert any(e[1] == "best_valid" for e in events) == best_valid
    assert min(e[3] for e in events if e[0] == "scalar") == start + (start % valid_frequency)


def test_validation_without_fid_matches_cmf_tpu():
    """``use_fid=False`` on a FID dataset: the zero validation loss over the
    valid loader, so one best epoch and then a stop after
    ``max_bad_valid_epochs`` + 1 bad ones."""
    x = np.random.default_rng(1).normal(size=(25, DIM)).astype(np.float32)
    port = _validation_run("port", 2, 20, max_bad_valid_epochs=4, valid_frequency=1, valid_loader=ArrayLoader(x, 10, "cpu"),
                           valid_loss_fn=experiment._zero_losses)
    theirs = _validation_run("cmf_tpu", 2, 20, max_bad_valid_epochs=4, valid_frequency=1, valid_loader=JaxArrayLoader(x, 10),
                             valid_loss_fn=lambda d, v, x, r: jax.numpy.zeros(x.shape[0]))
    assert port == theirs
    assert port[2] == 7 and json.loads(port[0])[1] == ["checkpoint", "best_valid", 2]


def test_test_epochs_and_scalars_match_cmf_tpu():
    """Tests after epochs 1, 6, 11 (epochs_per_test 5): the zero loss over
    the test loader, the FID with its stamps (a jitter where the FID needed
    one) and a ``nan_during_test`` checkpoint where it is not finite."""
    x = np.random.default_rng(0).normal(size=(30, DIM)).astype(np.float32)
    values, jitters = [7.0, float("nan"), 6.5], {2: 1e-4}
    port = _port_trainer(epochs_per_test=5, test_loader=ArrayLoader(x, 20, "cpu"),
                         test_metrics_fn=experiment._zero_test_metrics, fid_function=_scripted(values, jitters))
    port.writer = _Recorder()
    theirs = _jax_trainer(
        writer=_Recorder(), epochs_per_test=5, test_loader=JaxArrayLoader(x, 20),
        test_metrics_fn=lambda d, v, x, r: {"loss": jax.numpy.zeros(x.shape[0])},
        fid_function=_scripted(values, jitters),
    )
    for trainer in (port, theirs):
        for epoch in range(1, 13):
            trainer.epoch = epoch
            trainer._test_and_log(epoch)
    assert _events_json(port.writer.events) == _events_json(theirs.writer.events)
    events = port.writer.events
    assert sorted({e[3] for e in events if e[0] == "scalar"}) == [1, 6, 11]
    assert ("checkpoint", "nan_during_test", 6) in events
    assert ("scalar", "test/fid_sqrtm_jitter", 1e-4, 11) in events
    assert ("scalar", "test/loss", 0.0, 1) in events
    assert ("text", "test_feature_extractor", "raw-features") in events


@pytest.mark.parametrize("use_fid,use_test_fid", [(False, False), (True, False), (True, True)],
                         ids=["no-fid", "fid-on-train", "fid-on-test"])
def test_first_epoch_batch_order_matches_cmf_tpu(use_fid, use_test_fid):
    """The FID's reference pass over the train loader moves its shuffle
    counter on, so with it the first epoch takes permutation (seed, 1)."""
    config = small_config(
        model="non-square", dataset="miniboone", max_dataset_size=200, train_batch_size=40, use_fid=use_fid, use_test_fid=use_test_fid,
        num_fid_samples=40, test_batch_size=40, seed=3, nosave=True, synthetic_data=True,
    )
    train, _, test = jax_get_loaders("miniboone", config, seed=3, synthetic=True)
    if use_fid:
        jax_get_fid_function(config, test if use_test_fid else train)
    want = np.asarray(train.epoch_batches())
    setup = experiment.setup_experiment(config, write_to_disk=False, device="cpu")
    got = np.stack([b.numpy() for b in setup["train_loader"]])
    np.testing.assert_array_equal(got, want)
    moved = use_fid and not use_test_fid
    expected = train.x[np.random.default_rng((3, int(moved))).permutation(200)].reshape(got.shape)
    np.testing.assert_array_equal(got, expected)


def test_nan_epoch_checkpoints_the_last_finite_state(tmp_path):
    """A NaN third batch: step 3 changes nothing, step 4 trains on, and the
    epoch raises after a ``nan_during_training`` checkpoint that holds the
    state of steps 1, 2 and 4 alone, bit for bit."""
    batches = [t(batch(16, seed=70 + i)) for i in range(4)]
    batches[2] = torch.full_like(batches[2], float("nan"))
    trainer = _port_trainer(writer=Writer(str(tmp_path), make_subdir=False, tee=False))
    trainer.train_loader = batches
    with pytest.raises(FloatingPointError):
        trainer.train()
    twin = _port_trainer()
    flags = twin.objective.for_epoch(1)
    for x in batches[:2] + batches[3:]:
        twin.eager_step(x, flags)
    ckpt = torch.load(tmp_path / "checkpoints" / "nan_during_training.pt", weights_only=True)
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["nan_during_training.pt"]
    assert (ckpt["epoch"], ckpt["iteration"]) == (1, 4)
    for name, p in twin.density.named_parameters():
        assert torch.equal(ckpt["params"][name], p.detach()), name
        for key, value in twin.optimizers[0].state[p].items():
            assert torch.equal(ckpt["opt_states"][f"0/{name}/{key}"], value), (name, key)
    assert torch.equal(ckpt["opt_states"]["0/count"], twin.optimizers[0].count)


SMALL = ["--config", "num_density_layers=2", "--config", "coupler_hidden_channels=[16]",
         "--config", "prior_num_density_layers=2", "--config", "prior_hidden_channels=[8]",
         "--config", "latent_dimension=5"]


def _scalars(run_dir):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def _steps(scalars, tag):
    return [s["step"] for s in scalars if s["tag"] == f"miniboone/{tag}"]


def test_cli_default_run_then_resume_then_test(tmp_path):
    """No --nosave, early stopping and FID on: a run dir with its metadata,
    scalars and checkpoints; --resume trains on from ``latest``; --test
    --resume writes metrics.json with cmf_tpu's keys from ``best_valid``."""
    (setup,) = main([
        "--model", "non-square", "--dataset", "miniboone", "--synthetic-data", "--device", "cpu",
        "--logdir-root", str(tmp_path), "--config", "max_epochs=7", "--config", "max_dataset_size=120",
        "--config", "train_batch_size=40", "--config", "likelihood_warmup_start=2",
        "--config", "likelihood_warmup_end=4", "--config", "num_fid_samples=100",
        "--config", "test_batch_size=500", "--config", "epochs_per_test=3", "--config", "seed=1",
    ] + SMALL)
    run_dir = setup["writer"].logdir
    assert os.path.dirname(run_dir) == str(tmp_path / "miniboone")
    config = json.load(open(os.path.join(run_dir, "config.json")))
    assert config["early_stopping"] and config["use_fid"] and not config["nosave"]
    assert config["should_checkpoint_latest"] and config["should_checkpoint_best_valid"]
    for name in ("model.json", "git-head.txt", "git-diff.txt", "stdout", "stderr", "test_feature_extractor.txt"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    jax_density = jax_get_density(get_schema(config), x_shape=(43,))
    jax_params = jax_density.init(jax.random.PRNGKey(0))["params"]
    model = json.load(open(os.path.join(run_dir, "model.json")))
    assert model["num_params"] == jax_experiment.num_params(jax_params)
    assert model["schema"] == get_schema(config)

    scalars = _scalars(run_dir)
    assert _steps(scalars, "valid/loss") == [4, 5, 6, 7]  # from the warm-up's end
    assert _steps(scalars, "test/fid") == _steps(scalars, "test/loss") == [1, 4, 7]
    assert _steps(scalars, "train/loss") == _steps(scalars, "train/lr") == [10, 20]
    assert all(math.isfinite(s["value"]) for s in scalars)
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == ["best_valid.pt", "latest.pt"]
    assert setup["trainer"].timings["fid"][0] == 7

    config["max_epochs"] = 9
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(config, f)
    (resumed,) = main(["--resume", run_dir, "--device", "cpu"])
    trainer = resumed["trainer"]
    assert trainer.restored_from == "latest"
    assert [h[0] for h in trainer.history] == [8, 8, 8, 9, 9, 9]
    assert _steps(_scalars(run_dir), "valid/loss") == [4, 5, 6, 7, 8, 9]

    (tested,) = main(["--test", "--resume", run_dir, "--device", "cpu"])
    assert tested["trainer"].restored_from == "best_valid"
    metrics = json.load(open(os.path.join(run_dir, "metrics.json")))
    assert metrics == tested["results"]
    assert metrics["feature_extractor"] == "raw-features" and math.isfinite(metrics["fid"])

    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    want = jax_experiment.test_and_visualize(config, str(jax_dir))
    assert set(metrics) == set(want)


@pytest.mark.parametrize("argv", [["--test", "--device", "cpu"], ["--dataset", "miniboone", "--device", "cpu"]],
                         ids=["test-without-resume", "no-model-without-resume"])
def test_cli_refuses_an_incomplete_command(argv, capsys):
    with pytest.raises(SystemExit):
        main(argv)
    assert "--resume" in capsys.readouterr().err
