"""The device-side jitter search (``cmf_tpu_torch/ops/chol.py``) against the
JAX package's ``lax.while_loop`` one, and the head's device-side fallback
select (``densities/nonsquare.py::exact_log_det_from_columns``) against the
JAX head's ``lax.cond`` path (``cmf_tpu/densities/nonsquare.py:255-263``).

The batches that need jitter are built from zero rows (an exact zero pivot)
and from Grams with one negative eigenvalue placed well inside a jitter
level's interval, so every implementation's pivots fall on the same side of
zero. The Grams are scaled to eigenvalues of about 1e-3, so that rounding
(about 1e-7 of the largest entry) moves a pivot left small by the jitter
far less than the factor's tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.densities.nonsquare import NonSquareHeadDensity as JaxHead
from cmf_tpu.ops import jittered_cholesky as jax_jittered
from cmf_tpu_torch.densities import nonsquare
from cmf_tpu_torch.ops import jittered_cholesky

# Cumulative jitter after each try: 1e-6, 1.1e-5, 1.11e-4, ... 0.111111.
# "zero" puts a zero row in one element (level 1); a number is the
# negative eigenvalue of one element.
LEVELS = {0: None, 1: "zero", 3: 3.5e-5, 6: 3.5e-2, "none": 0.5}
# fp32 factors of the same (jittered) matrices, each side in its own order.
L_TOL = 1e-6
VALUE_TOL = 1e-4
GRAD_TOL = 1e-4


def _cumulative_jitter(tries):
    """The reference's total after ``tries`` tries, in its float32 adds."""
    eps, total = np.float32(1e-6), np.float32(0.0)
    for _ in range(tries):
        total, eps = np.float32(total + eps), np.float32(eps * np.float32(10.0))
    return total


def _gram_needing(kind, b=6, d=5, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, d, d + 2))
    g = np.einsum("bik,bjk->bij", a, a) * (1e-3 / d)
    if kind == "zero":
        g[1, 2, :] = 0.0
        g[1, :, 2] = 0.0
    elif kind is not None:
        q, _ = np.linalg.qr(rng.normal(size=(d, d)))
        lam = np.concatenate([rng.uniform(0.5e-3, 2e-3, size=d - 1), [-kind]])
        g[2] = (q * lam) @ q.T
    return g.astype(np.float32)


@pytest.mark.parametrize("tries", list(LEVELS), ids=[f"tries-{k}" for k in LEVELS])
def test_jitter_search_matches_jax(tries):
    """The same float32 total jitter, bit for bit, and the same factor; where
    every try fails, the last level and a factor non-finite in the same
    places."""
    g = _gram_needing(LEVELS[tries])
    L, total = jittered_cholesky(torch.as_tensor(g))
    L_j, total_j = jax_jittered(jnp.asarray(g))
    assert total.dtype == torch.float32 and total.shape == ()
    assert total.numpy().tobytes() == np.asarray(total_j, np.float32).tobytes()
    assert total.numpy() == _cumulative_jitter(6 if tries == "none" else tries)
    np.testing.assert_allclose(L.numpy(), np.asarray(L_j), rtol=0, atol=L_TOL, equal_nan=True)
    assert bool(torch.isfinite(L).all()) == (tries != "none")


def _port_log_det(cols, w):
    nonsquare.LOGDET_FALLBACKS.clear()
    J = torch.tensor(cols, requires_grad=True)
    gram, ld = nonsquare.exact_log_det_from_columns(J)
    (ld * torch.as_tensor(w)).sum().backward()
    return ld.detach().numpy(), J.grad.numpy(), nonsquare.logdet_fallbacks()


def _jax_log_det(cols, w):
    """The JAX head's own exact path on a linear decode whose Jacobian
    columns are ``cols``: the Pallas kernel (interpret mode) and its
    ``lax.cond`` fallback."""
    z = jnp.ones(cols.shape[1::-1], jnp.float32)

    def weighted(J):
        def decode_flat(u):
            return jnp.einsum("bd,dbD->bD", u, J)

        ld = JaxHead._exact_log_det(None, decode_flat, z)[0]
        return jnp.sum(ld * w), ld

    (_, ld), grad = jax.value_and_grad(weighted, has_aux=True)(jnp.asarray(cols))
    return np.asarray(ld), np.asarray(grad)


def _reference_grad(cols, w, total):
    """d Σ w·log|JᵀJ + total·I| / dJ in float64."""
    J = torch.tensor(cols, dtype=torch.float64, requires_grad=True)
    g = torch.einsum("ibD,jbD->bij", J, J) + total * torch.eye(J.shape[0], dtype=torch.float64)
    (torch.logdet(g) * torch.as_tensor(w, dtype=torch.float64)).sum().backward()
    return J.grad.numpy()


@pytest.mark.parametrize("pd", [True, False], ids=["pd", "zero-rows"])
def test_head_select_matches_lax_cond(pd):
    """Values and gradients against the JAX head. Where the fallback is
    taken, the JAX gradient is NaN on the elements whose unjittered factor
    was (0·NaN through its unselected branches, the deliberate difference
    in ROADMAP.md); the port's is finite everywhere and equals the float64
    gradient of the jittered log-det."""
    rng = np.random.default_rng(3)
    cols = rng.normal(size=(5, 12, 11)).astype(np.float32)
    w = rng.normal(size=12).astype(np.float32)
    bad = []
    if not pd:
        bad = [4, 7]
        cols[2, 4] = 0.0
        cols[0, 7] = 0.0
    ld, grad, fallbacks = _port_log_det(cols, w)
    ld_j, grad_j = _jax_log_det(cols, w)
    assert fallbacks == (0 if pd else 1)
    np.testing.assert_allclose(ld, ld_j, rtol=VALUE_TOL, atol=VALUE_TOL)
    assert np.isfinite(grad).all()
    scale = np.abs(grad).max()
    good = np.setdiff1d(np.arange(cols.shape[1]), bad)
    np.testing.assert_allclose(grad[:, good], grad_j[:, good], rtol=0, atol=GRAD_TOL * scale)
    if bad:
        assert np.isnan(grad_j[:, bad]).any(axis=(0, 2)).all()
    else:
        assert np.isfinite(grad_j).all()
    gram = np.einsum("ibD,jbD->bij", cols, cols)
    total = float(jittered_cholesky(torch.as_tensor(gram))[1])
    assert (total == 0.0) == pd
    np.testing.assert_allclose(grad, _reference_grad(cols, w, total), rtol=0, atol=GRAD_TOL * scale)
