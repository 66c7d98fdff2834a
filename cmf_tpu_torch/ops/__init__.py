from .chol import cholesky_logdet, jittered_cholesky
from .gram import gram_from_columns
from .gram_logdet import fused_gram_logdet, fused_gram_logdet_available

__all__ = [
    "cholesky_logdet",
    "jittered_cholesky",
    "gram_from_columns",
    "fused_gram_logdet",
    "fused_gram_logdet_available",
]
