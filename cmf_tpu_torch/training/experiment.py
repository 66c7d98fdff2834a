"""Experiment setup and the train and test entry points
(``cmf_tpu/training/experiment.py`` in torch).

Setup follows experiment.py:148-302: loaders, schema, density, objective,
optimizer, writer, the validation and test closures, the FID function and
the trainer. Adam is ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``,
the same update as optax ``scale_by_adam`` followed by
``scale_by_learning_rate`` (experiment.py:89-131).

A config that asks for something this slice does not carry raises
``NotImplementedError`` here, before any work: it is never quietly skipped.
"""

import json
import os
import subprocess

import torch

from ..config import get_schema
from ..data import get_loaders
from ..data.image import DATASET_SHAPES as IMAGE_SHAPES
from ..data.tabular import DATASET_SHAPES as TABULAR_SHAPES
from ..device import pin_fp32, resolve_device
from ..eval.fid import get_fid_function
from ..models import get_density
from .objectives import get_objective
from .trainer import Trainer
from .writer import DummyWriter, Writer, check_checkpoint_backend

FID_DATASETS = list(IMAGE_SHAPES) + list(TABULAR_SHAPES)


def _later(what, hint=""):
    return NotImplementedError(f"{what} waits for a later slice of the port{hint}")


def has_visualizer(config):
    """Whether the JAX package's ``get_visualizer`` (viz/__init__.py:14-69)
    gives a visualiser that draws, not ``DummyDensityVisualizer``: every image
    dataset, and non-square tabular data of 2, 3 (d ≤ 3), 4 or 6 features."""
    dataset = config["dataset"]
    if dataset in IMAGE_SHAPES:
        return True
    dim = TABULAR_SHAPES[dataset][0] if dataset in TABULAR_SHAPES else None
    non_square = config.get("model") == "non-square" or config.get("non_square", False)
    if dim == 2:
        return True
    if dim == 3:
        return non_square and config.get("latent_dimension") in (1, 2, 3)
    return dim in (4, 6) and non_square


def check_supported(config, write_to_disk=True):
    """Raise for every config entry that asks for what the port lacks."""
    if not config.get("non_square", False):
        raise _later("training a square flow")
    if config.get("m_flow", False):
        raise _later("the M-flow baseline (m_flow=True)")
    if config.get("opt", "adam") != "adam":
        raise _later(f"optimizer `{config['opt']}'")
    if config.get("lr_schedule", "none") != "none":
        raise _later(f"lr schedule `{config['lr_schedule']}'")
    if config.get("max_grad_norm") is not None:
        raise _later("gradient clipping (max_grad_norm)")
    if config.get("weight_decay", 0.0):
        raise _later("weight decay")
    if config.get("compute_dtype", "float32") != "float32":
        raise _later(f"compute_dtype `{config['compute_dtype']}'")
    if config.get("use_fid", False) and config["dataset"] in IMAGE_SHAPES:
        raise _later("FID on image features (ROADMAP module 4)", "; set use_fid=False")
    if write_to_disk and not config.get("nosave", False):
        check_checkpoint_backend(config.get("checkpoint_backend", "pickle"))
        if has_visualizer(config):
            raise _later(
                f"the visualiser of `{config['dataset']}' (ROADMAP module 9)", "; pass --nosave"
            )


def make_optimizer(config, params):
    """Adam. On the card it is capturable: its step count lives on the
    device, so a step reads nothing on the host and a CUDA graph can hold
    it. On the CPU the plain form."""
    params = list(params)
    capturable = any(p.is_cuda for p in params)
    return torch.optim.Adam(params, lr=config["lr"], betas=(0.9, 0.999), eps=1e-8, capturable=capturable)


def num_params(density):
    return int(sum(p.numel() for p in density.parameters()))


def _zero_losses(density, x):
    """The validation loss of a FID dataset (experiment.py:213-215): zero a
    row, made on the host, so reading it reads nothing from the card."""
    return torch.zeros(x.shape[0])


def _zero_test_metrics(density, x):
    return {"loss": torch.zeros(x.shape[0])}


def _make_writer(config, resume_dir, write_to_disk):
    if write_to_disk and not config.get("nosave", False):
        if resume_dir is None:
            logdir = os.path.join(config.get("logdir_root", "runs"), config["dataset"])
            make_subdir = True
        else:
            logdir = resume_dir
            make_subdir = False
        return Writer(
            logdir=logdir,
            make_subdir=make_subdir,
            tag_group=config["dataset"],
            rundir_tail=config.get("rundir_tail", ""),
            checkpoint_backend=config.get("checkpoint_backend", "pickle"),
        )
    return DummyWriter(logdir=resume_dir)


def setup_experiment(config, resume_dir=None, testing=False, write_to_disk=True, device=None):
    """config → {"density", "trainer", "writer", "train_loader", "schema",
    "device", "config"}. ``device`` is ``None`` for the card (raises without
    one) or ``"cpu"``. The weights come from a CPU generator seeded with
    ``config["seed"]``; the train loop's draws (dequantization, Hutchinson
    probes, FID noise) from a generator on ``device`` with the same seed.
    With ``resume_dir`` the writer writes into that run dir, and the
    trainer restores its checkpoints."""
    check_supported(config, write_to_disk=write_to_disk)
    device = resolve_device(device)
    pin_fp32()
    seed = config["seed"]
    train_loader, valid_loader, test_loader = get_loaders(
        config["dataset"],
        config,
        device,
        seed=seed,
        synthetic=config.get("synthetic_data"),
        data_root=config.get("data_root"),
    )
    schema = get_schema(config)
    generator = torch.Generator().manual_seed(seed)
    density = get_density(schema, x_shape=train_loader.x_shape, device=device, generator=generator)
    writer = _make_writer(config, resume_dir, write_to_disk)

    # Loss closures (experiment.py:211-215). Every dataset the port loads is
    # a FID dataset.
    assert config["dataset"] in FID_DATASETS
    valid_loss_fn, test_metrics_fn = _zero_losses, _zero_test_metrics

    fid_function = None
    if config.get("use_fid", False):
        loader = test_loader if config.get("use_test_fid", False) else train_loader
        fid_function = get_fid_function(config, loader)

    trainer = Trainer(
        density=density,
        objective=get_objective(config),
        optimizer=make_optimizer(config, density.parameters()),
        train_loader=train_loader,
        max_epochs=config["max_epochs"],
        generator=torch.Generator(device=device).manual_seed(seed),
        valid_loader=valid_loader,
        test_loader=test_loader,
        writer=writer,
        early_stopping=config["early_stopping"],
        max_bad_valid_epochs=config["max_bad_valid_epochs"],
        valid_frequency=2 if config.get("m_flow", False) else 1,
        epochs_per_test=config["epochs_per_test"],
        valid_loss_fn=valid_loss_fn,
        test_metrics_fn=test_metrics_fn,
        fid_function=fid_function,
        should_checkpoint_latest=config.get("should_checkpoint_latest", True),
        should_checkpoint_best_valid=config.get("should_checkpoint_best_valid", True),
        only_testing=testing,
    )
    return {
        "density": density,
        "trainer": trainer,
        "writer": writer,
        "train_loader": train_loader,
        "schema": schema,
        "device": device,
        "config": config,
    }


def _write_run_metadata(writer, config, density):
    writer.write_json("config", {k: v for k, v in config.items()})
    writer.write_json("model", {"num_params": num_params(density), "schema": get_schema(config)})
    try:
        head = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=10
        ).stdout.strip()
        writer.write_textfile("git-head", head)
        diff = subprocess.run(["git", "diff"], capture_output=True, text=True, timeout=10).stdout
        writer.write_textfile("git-diff", diff)
    except Exception:
        pass


def train(config, resume_dir=None, device=None):
    setup = setup_experiment(config, resume_dir=resume_dir, device=device)
    if resume_dir is None:
        _write_run_metadata(setup["writer"], config, setup["density"])
    setup["trainer"].train()
    return setup


def test_and_visualize(config, resume_dir, overwrite=False, test_fid=False, device=None):
    """The test pass of a finished run (experiment.py:333-355): FID on
    50,000 samples, from the ``best_valid`` checkpoint, else ``latest``;
    skipped when ``metrics.json`` exists unless ``overwrite``; the results
    go to ``metrics.json``. Returns the setup, with the results under
    ``"results"`` (only those, when skipped)."""
    config = {**config, "num_fid_samples": 50_000}
    if test_fid:
        config["use_test_fid"] = True

    metrics_path = os.path.join(resume_dir, "metrics.json")
    if os.path.exists(metrics_path) and not overwrite:
        print(f"`{metrics_path}' exists; skipping (pass overwrite to rerun)")
        with open(metrics_path) as f:
            return {"results": json.load(f)}

    if config["dataset"] not in TABULAR_SHAPES and has_visualizer(config):
        raise _later(f"the visualiser of `{config['dataset']}' (ROADMAP module 9)")
    setup = setup_experiment(config, resume_dir=resume_dir, testing=True, write_to_disk=False, device=device)
    results = setup["trainer"].test()
    with open(metrics_path, "w") as f:
        json.dump(results, f, indent=4)
    setup["results"] = results
    return setup
