"""Experiment setup and the train entry point, the train-loop subset
(``cmf_tpu/training/experiment.py`` in torch).

Setup follows experiment.py:148-187: loaders, schema, density, objective,
optimizer, trainer. Adam is ``torch.optim.Adam(lr, betas=(0.9, 0.999),
eps=1e-8)``, the same update as optax ``scale_by_adam`` followed by
``scale_by_learning_rate`` (experiment.py:89-131).

A config that asks for something this slice does not carry raises
``NotImplementedError`` here, before any work: it is never quietly skipped.
"""

import torch

from ..config import get_schema
from ..data import get_loaders
from ..device import pin_fp32, resolve_device
from ..models import get_density
from .objectives import get_objective
from .trainer import Trainer


def _later(what, hint=""):
    return NotImplementedError(f"{what} waits for a later slice of the port{hint}")


def check_supported(config):
    """Raise for every config entry that asks for what the port lacks."""
    if not config.get("non_square", False):
        raise _later("training a square flow")
    if config.get("m_flow", False):
        raise _later("the M-flow baseline (m_flow=True)")
    if not config.get("nosave", False):
        raise _later("the writer and checkpoints", "; pass --nosave")
    if config.get("early_stopping", False):
        raise _later("validation and early stopping", "; set early_stopping=False")
    if config.get("use_fid", False):
        raise _later("FID (validation and test)", "; set use_fid=False")
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


def make_optimizer(config, params):
    """Adam. On the card it is capturable: its step count lives on the
    device, so a step reads nothing on the host and a CUDA graph can hold
    it. On the CPU the plain form."""
    params = list(params)
    capturable = any(p.is_cuda for p in params)
    return torch.optim.Adam(params, lr=config["lr"], betas=(0.9, 0.999), eps=1e-8, capturable=capturable)


def setup_experiment(config, device=None):
    """config → {"density", "trainer", "train_loader", "schema", "device"}.
    ``device`` is ``None`` for the card (raises without one) or ``"cpu"``.
    The weights come from a CPU generator seeded with ``config["seed"]``; the
    train loop's draws (dequantization, Hutchinson probes) from a generator
    on ``device`` with the same seed."""
    check_supported(config)
    device = resolve_device(device)
    pin_fp32()
    seed = config["seed"]
    train_loader, _, _ = get_loaders(
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
    trainer = Trainer(
        density=density,
        objective=get_objective(config),
        optimizer=make_optimizer(config, density.parameters()),
        train_loader=train_loader,
        max_epochs=config["max_epochs"],
        generator=torch.Generator(device=device).manual_seed(seed),
    )
    return {
        "density": density,
        "trainer": trainer,
        "train_loader": train_loader,
        "schema": schema,
        "device": device,
    }


def train(config, device=None):
    setup = setup_experiment(config, device=device)
    setup["trainer"].train()
    return setup
