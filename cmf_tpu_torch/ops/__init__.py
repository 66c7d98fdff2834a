from .cg import batched_cg
from .chol import cholesky_logdet, jittered_cholesky, spd_solve
from .coupler_stack import fused_resnet_coupler
from .gram import gram_from_columns
from .gram_logdet import fused_gram_logdet, fused_gram_logdet_available

__all__ = [
    "batched_cg",
    "cholesky_logdet",
    "jittered_cholesky",
    "spd_solve",
    "fused_resnet_coupler",
    "gram_from_columns",
    "fused_gram_logdet",
    "fused_gram_logdet_available",
]
