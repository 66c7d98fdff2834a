"""Jittered batched Cholesky and log-det for JᵀJ Gram matrices
(``cmf_tpu/ops/chol.py`` in torch).

Same semantics as the JAX package: a non-PD input gives NaN, never an
exception (``torch.linalg.cholesky`` would raise, so it is not used), and the
retry adds one jitter level for the whole batch, starting at 1e-6, ×10 per
try, at most 6 tries, then runs one clean differentiable factorisation at the
level found (chol.py:59-117). Deciding whether to retry reads a flag on the
host, as the reference's ``try/except`` around ``torch.linalg.cholesky`` did.
"""

import torch

_EPS0 = 1e-6
_EPS_FACTOR = 10.0
_MAX_ATTEMPTS = 6
# Unrolled small-matrix bound, as in the JAX package; above it the library
# factorisation (with its failure flag turned into NaN) is used.
_UNROLL_MAX = 64


def _small_cholesky(g):
    """Batched Cholesky for small d by unrolled column updates
    (chol.py:31-50). Only the lower triangle of ``g`` is read; a non-PD
    input gives NaN in and below the offending pivot (sqrt of a negative)."""
    d = g.shape[-1]
    idx = torch.arange(d, device=g.device)
    cols = []
    for j in range(d):
        # s_i = g[i, j] − Σ_{k<j} L[i, k]·L[j, k]
        s = g[..., :, j]
        if cols:
            C = torch.stack(cols, dim=-1)  # (..., d, j): the columns so far
            s = s - (C @ C[..., j, :].unsqueeze(-1)).squeeze(-1)
        col = s / torch.sqrt(s[..., j : j + 1])
        cols.append(torch.where(idx >= j, col, torch.zeros_like(col)))
    return torch.stack(cols, dim=-1)


def _cholesky(g):
    if g.shape[-1] <= _UNROLL_MAX:
        return _small_cholesky(g)
    L, info = torch.linalg.cholesky_ex(g)
    return torch.where((info != 0)[..., None, None], torch.full_like(L, float("nan")), L)


def jittered_cholesky(gram):
    """Batched lower-Cholesky of SPD matrices with escalating-jitter retry.

    Returns (L, total_jitter): total_jitter is the eps added to the diagonal
    (0.0 when the first attempt succeeded).
    """
    L0 = _cholesky(gram)
    if bool(torch.isfinite(L0).all()):
        return L0, 0.0
    eye = torch.eye(gram.shape[-1], dtype=gram.dtype, device=gram.device)
    # Non-differentiable escalation loop; it only finds the jitter level.
    with torch.no_grad():
        g = gram.detach()
        eps, total = _EPS0, 0.0
        for _ in range(_MAX_ATTEMPTS):
            g = g + eps * eye
            total += eps
            eps *= _EPS_FACTOR
            if bool(torch.isfinite(_cholesky(g)).all()):
                break
    return _cholesky(gram + total * eye), total


def cholesky_logdet(gram):
    """log|G| = 2·Σ log diag(L) via the jittered Cholesky
    (non_square.py:293-294). Returns (logdet (...,), total_jitter)."""
    L, total_jitter = jittered_cholesky(gram)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    return 2.0 * torch.log(diag).sum(dim=-1), total_jitter
