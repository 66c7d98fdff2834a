from .experiment import check_supported, make_optimizer, setup_experiment, train
from .objectives import NonSquareObjective, get_objective
from .trainer import Trainer, elbo_loss

__all__ = [
    "check_supported",
    "make_optimizer",
    "setup_experiment",
    "train",
    "NonSquareObjective",
    "get_objective",
    "Trainer",
    "elbo_loss",
]
