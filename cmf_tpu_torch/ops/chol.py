"""Jittered batched Cholesky and log-det for JᵀJ Gram matrices
(``cmf_tpu/ops/chol.py`` in torch).

Same semantics as the JAX package: a non-PD input gives NaN, never an
exception (``torch.linalg.cholesky`` would raise, so it is not used), and the
retry adds one jitter level for the whole batch, starting at 1e-6, ×10 per
try, at most 6 tries, then runs one clean differentiable factorisation at the
level found (chol.py:59-117). The search reads nothing on the host, so a
CUDA graph can hold it: where the reference's ``lax.while_loop`` stops at the
first finite try, every try is factorised in one batch and the first whose
whole batch is finite is selected on the device.

``spd_solve`` (chol.py:148-171) solves G x = rhs through that factor: the
exact-Gram Hutchinson solver's (JᵀJ)⁻¹ε, with L for its log-det.
"""

import torch

from ..parallel.mesh import batch_all

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

    Returns (L, total_jitter): total_jitter is a 0-dim tensor on ``gram``'s
    device, the eps added to the diagonal (0 when the first attempt
    succeeded); the same float32 value as the reference's, since the tries
    are built by its repeated adds (``g = g + eps·I``, ``total + eps``,
    ``eps·10``). Level 0 (no jitter) and the six tries are factorised as one
    batch without a gradient; the first level whose whole batch is finite
    is taken, the last one where none is (under a mesh, whose whole global
batch is finite: one level for every rank). L is one clean differentiable
    factorisation of ``gram + total·I``: at total 0 that is the level-0
    factor itself, since ``gram + 0·I`` is ``gram``.
    """
    d = gram.shape[-1]
    eye = torch.eye(d, dtype=gram.dtype, device=gram.device)
    with torch.no_grad():
        g = gram.detach()
        eps = torch.full((), _EPS0, dtype=gram.dtype, device=gram.device)
        tries, totals = [g], [torch.zeros_like(eps)]
        for _ in range(_MAX_ATTEMPTS):
            g = g + eps * eye
            tries.append(g)
            totals.append(totals[-1] + eps)
            eps = eps * _EPS_FACTOR
        factors = _cholesky(torch.stack(tries))
        # Under a mesh a try is taken only where every rank's rows factor.
        finite = batch_all(torch.isfinite(factors).reshape(len(tries), -1).all(dim=1))
        finite[-1].fill_(True)  # every try failed: the reference stops at the last
        # argmax gives the first of equal maxima.
        level = torch.argmax(finite.to(torch.int32)).reshape(1)
        total = torch.stack(totals).index_select(0, level).reshape(())
    return _cholesky(gram + total * eye), total


def _small_solve_lower(L, b):
    """Forward substitution L y = b for small d, unrolled over the rows
    (chol.py:120-133); b is (..., d, S)."""
    rows = []
    for i in range(L.shape[-1]):
        s = b[..., i, :]
        if rows:
            # s − Σ_{k<i} L[i, k]·y[k]
            s = s - (L[..., i : i + 1, :i] @ torch.stack(rows, dim=-2)).squeeze(-2)
        rows.append(s / L[..., i, i, None])
    return torch.stack(rows, dim=-2)


def _small_solve_lower_t(L, b):
    """Back substitution Lᵀ x = b for small d (chol.py:136-145)."""
    d = L.shape[-1]
    rows = []  # x[d-1], x[d-2], ...
    for i in reversed(range(d)):
        s = b[..., i, :]
        if rows:
            # s − Σ_{k>i} L[k, i]·x[k]
            below = torch.stack(rows[::-1], dim=-2)  # x[i+1:]
            s = s - (L[..., i + 1 :, i].unsqueeze(-2) @ below).squeeze(-2)
        rows.append(s / L[..., i, i, None])
    return torch.stack(rows[::-1], dim=-2)


def spd_solve(gram, rhs):
    """Solve G x = rhs for a batch of SPD matrices through the jittered
    Cholesky (chol.py:148-171). ``gram`` is (..., d, d), ``rhs`` (..., d, S).
    Returns (x, L), L for the log-det ``2·Σ log diag L``. A Gram whose every
    jitter level fails gives NaN, never an exception. Up to d = 64 the two
    substitutions are unrolled, as the factorisation is, and read nothing on
    the host; above it, ``torch.linalg.solve_triangular``."""
    L, _ = jittered_cholesky(gram)
    if gram.shape[-1] <= _UNROLL_MAX:
        return _small_solve_lower_t(L, _small_solve_lower(L, rhs)), L
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True), L


def cholesky_logdet(gram):
    """log|G| = 2·Σ log diag(L) via the jittered Cholesky
    (non_square.py:293-294). Returns (logdet (...,), total_jitter)."""
    L, total_jitter = jittered_cholesky(gram)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    return 2.0 * torch.log(diag).sum(dim=-1), total_jitter
