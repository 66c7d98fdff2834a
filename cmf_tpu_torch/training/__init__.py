from .experiment import (
    check_supported,
    make_optimizer,
    num_params,
    setup_experiment,
    test_and_visualize,
    train,
)
from .objectives import NonSquareObjective, get_objective
from .trainer import EarlyStop, Trainer, elbo_loss
from .writer import DummyWriter, Writer

__all__ = [
    "check_supported",
    "make_optimizer",
    "num_params",
    "setup_experiment",
    "test_and_visualize",
    "train",
    "NonSquareObjective",
    "get_objective",
    "EarlyStop",
    "Trainer",
    "elbo_loss",
    "DummyWriter",
    "Writer",
]
