from .experiment import (
    OOD_MAPPING_TABLE,
    check_supported,
    generate_ood_metrics,
    make_optimizer,
    num_params,
    ood_classification,
    print_num_params,
    setup_experiment,
    test_and_visualize,
    train,
)
from .objectives import NonSquareObjective, get_objective
from .trainer import EarlyStop, Trainer, elbo_loss
from .writer import DummyWriter, Writer

__all__ = [
    "OOD_MAPPING_TABLE",
    "check_supported",
    "generate_ood_metrics",
    "make_optimizer",
    "num_params",
    "ood_classification",
    "print_num_params",
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
