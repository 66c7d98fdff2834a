from .affine import AffineBijection, ConditionalAffineBijection
from .base import Bijection
from .coupling import (
    AlternatingChannelwiseCouplingBijection,
    Checkerboard2dCouplingBijection,
    SplitChannelwiseCouplingBijection,
)
from .elementwise import LogitBijection, ScalarAdditionBijection, ScalarMultiplicationBijection
from .linear import (
    BruteForceInvertible1x1ConvBijection,
    LUInvertible1x1ConvBijection,
    LULinearBijection,
)
from .made import MADEBijection
from .reshaping import (
    FlipBijection,
    RandomChannelwisePermutationBijection,
    Squeeze2dBijection,
    ViewBijection,
)
from .spline import AutoregressiveRationalQuadraticSplineBijection, rational_quadratic_spline

__all__ = [
    "AffineBijection",
    "AutoregressiveRationalQuadraticSplineBijection",
    "ConditionalAffineBijection",
    "BruteForceInvertible1x1ConvBijection",
    "LUInvertible1x1ConvBijection",
    "LULinearBijection",
    "MADEBijection",
    "rational_quadratic_spline",
    "Bijection",
    "AlternatingChannelwiseCouplingBijection",
    "Checkerboard2dCouplingBijection",
    "SplitChannelwiseCouplingBijection",
    "LogitBijection",
    "ScalarAdditionBijection",
    "ScalarMultiplicationBijection",
    "FlipBijection",
    "RandomChannelwisePermutationBijection",
    "Squeeze2dBijection",
    "ViewBijection",
]
