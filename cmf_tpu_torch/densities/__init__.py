from .base import Density
from .elbo import ELBODensity
from .exact import BijectionDensity
from .gaussian import (
    DiagonalGaussianConditionalDensity,
    DiagonalGaussianDensity,
    diagonal_gaussian_entropy,
    diagonal_gaussian_log_prob,
    diagonal_gaussian_sample,
)
from .nonsquare import ManifoldFlowHeadDensity, NonSquareHeadDensity, NonSquareTailDensity
from .split import SplitDensity
from .wrapper import DequantizationDensity

__all__ = [
    "Density",
    "BijectionDensity",
    "DequantizationDensity",
    "DiagonalGaussianConditionalDensity",
    "DiagonalGaussianDensity",
    "ELBODensity",
    "diagonal_gaussian_entropy",
    "diagonal_gaussian_log_prob",
    "diagonal_gaussian_sample",
    "ManifoldFlowHeadDensity",
    "NonSquareHeadDensity",
    "NonSquareTailDensity",
    "SplitDensity",
]
