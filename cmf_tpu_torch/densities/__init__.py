from .base import Density
from .concrete import ConcreteConditionalDensity
from .elbo import ELBODensity
from .exact import BijectionDensity
from .mixture import BijectionMixtureDensity
from .gaussian import (
    DiagonalGaussianConditionalDensity,
    DiagonalGaussianDensity,
    diagonal_gaussian_entropy,
    diagonal_gaussian_log_prob,
    diagonal_gaussian_sample,
)
from .nonsquare import ManifoldFlowHeadDensity, NonSquareHeadDensity, NonSquareTailDensity
from .split import SplitDensity
from .wrapper import DequantizationDensity, PassthroughBeforeEvalDensity

__all__ = [
    "Density",
    "BijectionDensity",
    "BijectionMixtureDensity",
    "ConcreteConditionalDensity",
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
    "PassthroughBeforeEvalDensity",
    "SplitDensity",
]
