from .affine import AffineBijection, ConditionalAffineBijection
from .base import Bijection, CompositeBijection, IdentityBijection, InverseBijection
from .batchnorm import BatchNormBijection
from .bnaf import BlockNeuralAutoregressiveBijection
from .coupling import (
    AlternatingChannelwiseCouplingBijection,
    Checkerboard2dCouplingBijection,
    MaskedChannelwiseCouplingBijection,
    SplitChannelwiseCouplingBijection,
)
from .elementwise import LogitBijection, ScalarAdditionBijection, ScalarMultiplicationBijection, TanhBijection
from .linear import (
    BruteForceInvertible1x1ConvBijection,
    LUInvertible1x1ConvBijection,
    LULinearBijection,
)
from .made import MADEBijection
from .planar import ConditionalPlanarBijection, PlanarBijection
from .reshaping import (
    FlipBijection,
    RandomChannelwisePermutationBijection,
    Squeeze2dBijection,
    ViewBijection,
)
from .sos import SumOfSquaresPolynomialBijection
from .spline import (
    AutoregressiveRationalQuadraticSplineBijection,
    CoupledRationalQuadraticSplineBijection,
    rational_quadratic_spline,
)

__all__ = [
    "AffineBijection",
    "AutoregressiveRationalQuadraticSplineBijection",
    "BatchNormBijection",
    "BlockNeuralAutoregressiveBijection",
    "CompositeBijection",
    "ConditionalAffineBijection",
    "ConditionalPlanarBijection",
    "CoupledRationalQuadraticSplineBijection",
    "BruteForceInvertible1x1ConvBijection",
    "IdentityBijection",
    "InverseBijection",
    "LUInvertible1x1ConvBijection",
    "LULinearBijection",
    "MADEBijection",
    "MaskedChannelwiseCouplingBijection",
    "PlanarBijection",
    "rational_quadratic_spline",
    "Bijection",
    "AlternatingChannelwiseCouplingBijection",
    "Checkerboard2dCouplingBijection",
    "SplitChannelwiseCouplingBijection",
    "LogitBijection",
    "ScalarAdditionBijection",
    "ScalarMultiplicationBijection",
    "SumOfSquaresPolynomialBijection",
    "TanhBijection",
    "FlipBijection",
    "RandomChannelwisePermutationBijection",
    "Squeeze2dBijection",
    "ViewBijection",
]
