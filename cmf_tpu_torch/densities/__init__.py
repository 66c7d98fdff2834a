from .base import Density
from .exact import BijectionDensity
from .gaussian import DiagonalGaussianDensity, diagonal_gaussian_log_prob
from .nonsquare import ManifoldFlowHeadDensity, NonSquareHeadDensity, NonSquareTailDensity
from .split import SplitDensity
from .wrapper import DequantizationDensity

__all__ = [
    "Density",
    "BijectionDensity",
    "DequantizationDensity",
    "DiagonalGaussianDensity",
    "diagonal_gaussian_log_prob",
    "ManifoldFlowHeadDensity",
    "NonSquareHeadDensity",
    "NonSquareTailDensity",
    "SplitDensity",
]
