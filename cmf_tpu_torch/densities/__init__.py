from .base import Density
from .exact import BijectionDensity
from .gaussian import DiagonalGaussianDensity, diagonal_gaussian_log_prob
from .nonsquare import NonSquareHeadDensity, NonSquareTailDensity

__all__ = [
    "Density",
    "BijectionDensity",
    "DiagonalGaussianDensity",
    "diagonal_gaussian_log_prob",
    "NonSquareHeadDensity",
    "NonSquareTailDensity",
]
