"""Batched preconditioner-free conjugate gradients for SPD systems
(``cmf_tpu/ops/cg.py`` in torch), with gpytorch's ``linear_cg`` semantics:

* each right-hand side is normalised by its 2-norm over d; a zero rhs has a
  zero solution;
* a column converges when the batch-mean relative residual drops below
  ``tolerance`` (strict ``<``); converged (batch, column) entries freeze;
* x0 = 0, so r0 = p0 = the normalised rhs, whose relative residual is 1 by
  construction. The first iteration is peeled and gated structurally on
  ``tolerance <= 1`` (cg.py:104-115), never on a recomputed norm that fp32
  can round below 1. Its matvec may come in as ``first_matvec``
  (= ``matvec(rhs)``), so a solve that converges in one iteration — the
  image configs' ``cg_tolerance=1`` — runs no matvec here.

The loop's convergence test reads one flag on the host per iteration, where
the JAX package keeps the whole loop on the device (``lax.while_loop``).
Under a mesh the batch mean is the global batch's (a sum over the data
group), so every rank runs the same iterations: with batch-norm in the
matvec a rank that stopped early would leave the others waiting in a
collective.
"""

import torch

from ..parallel.mesh import batch_mean


def batched_cg(matvec, rhs, max_iter, tolerance=1.0, eps=1e-10, first_matvec=None):
    """Solve ``A x = rhs`` for rhs (..., d, S); ``matvec`` maps arrays shaped
    like ``rhs`` linearly. Returns x shaped like ``rhs``."""
    if max_iter <= 0:
        return torch.zeros_like(rhs)

    rhs_norm = torch.sqrt((rhs * rhs).sum(dim=-2, keepdim=True))
    rhs_is_zero = rhs_norm < eps
    rhs_norm = torch.where(rhs_is_zero, torch.ones_like(rhs_norm), rhs_norm)
    b = rhs / rhs_norm

    def resid_norm(r):
        return torch.sqrt((r * r).sum(dim=-2))  # (..., S)

    def not_converged(r):
        mean_over_batch = batch_mean(resid_norm(r).reshape(-1, r.shape[-1]), (0,))
        return bool((mean_over_batch >= tolerance).any())

    def step(x, r, p, Ap, active):
        rr = (r * r).sum(dim=-2, keepdim=True)
        pAp = (p * Ap).sum(dim=-2, keepdim=True)
        alpha = rr / (pAp + eps) * active
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        beta = (r_new * r_new).sum(dim=-2, keepdim=True) / (rr + eps)
        return x_new, r_new, r_new + beta * p

    def loop_active(r):
        return (resid_norm(r) >= tolerance)[..., None, :].to(rhs.dtype)

    x = torch.zeros_like(rhs)
    r, p = b, b
    if tolerance <= 1.0:
        Ab = (matvec(rhs) if first_matvec is None else first_matvec) / rhs_norm
        x, r, p = step(x, b, b, Ab, torch.ones_like(rhs_norm))

    i = 1
    while i < max_iter and not_converged(r):
        x, r, p = step(x, r, p, matvec(p), loop_active(r))
        i += 1
    return torch.where(rhs_is_zero, torch.zeros_like(x), x * rhs_norm)
