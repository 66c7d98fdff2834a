from .base import Bijection
from .coupling import AlternatingChannelwiseCouplingBijection
from .reshaping import FlipBijection, RandomChannelwisePermutationBijection, ViewBijection

__all__ = [
    "Bijection",
    "AlternatingChannelwiseCouplingBijection",
    "FlipBijection",
    "RandomChannelwisePermutationBijection",
    "ViewBijection",
]
