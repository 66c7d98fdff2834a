from .affine import AffineBijection
from .base import Bijection
from .coupling import (
    AlternatingChannelwiseCouplingBijection,
    Checkerboard2dCouplingBijection,
    SplitChannelwiseCouplingBijection,
)
from .elementwise import LogitBijection, ScalarAdditionBijection, ScalarMultiplicationBijection
from .reshaping import (
    FlipBijection,
    RandomChannelwisePermutationBijection,
    Squeeze2dBijection,
    ViewBijection,
)

__all__ = [
    "AffineBijection",
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
