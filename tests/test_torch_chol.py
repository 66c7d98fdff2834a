"""The port's jittered Cholesky (``cmf_tpu_torch/ops/chol.py``) and Gram
(``ops/gram.py``) against the JAX package's, including the singular-rescue
case of ``tests/test_ops.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.ops import cholesky_logdet as jax_logdet
from cmf_tpu.ops import gram_from_columns as jax_gram
from cmf_tpu.ops import jittered_cholesky as jax_jittered
from cmf_tpu_torch.ops import cholesky_logdet, gram_from_columns, jittered_cholesky

# fp32 factorisations of well-conditioned matrices on both sides.
TOL = 1e-4


def _spd(batch, d, seed, cond=10.0):
    a = np.random.default_rng(seed).normal(size=(batch, d, d)).astype(np.float32)
    return np.einsum("bij,bkj->bik", a, a) + np.eye(d, dtype=np.float32) / cond


@pytest.mark.parametrize("batch,d", [(3, 5), (2, 1), (4, 21), (2, 70)])
def test_spd_matches_jax(batch, d):
    """d ≤ 64 runs the unrolled factorisation, d = 70 the library one with
    its failure flag turned into NaN; both as the JAX package routes them."""
    a = _spd(batch, d, seed=d, cond=5.0)
    L, jitter = jittered_cholesky(torch.as_tensor(a))
    L_j, jitter_j = jax_jittered(jnp.asarray(a))
    assert jitter == float(jitter_j) == 0.0
    scale = np.abs(np.asarray(L_j)).max()
    np.testing.assert_allclose(L.numpy(), np.asarray(L_j), rtol=TOL, atol=TOL * scale)
    ld, _ = cholesky_logdet(torch.as_tensor(a))
    np.testing.assert_allclose(ld.numpy(), np.asarray(jax_logdet(jnp.asarray(a))[0]), rtol=TOL)


def test_rescues_singular_like_jax():
    """A singular Gram gets the same escalated jitter as in the JAX package
    (one level for the whole batch), then one clean factorisation."""
    d = 4
    a = np.random.default_rng(0).normal(size=(2, d, 2)).astype(np.float32)  # rank 2 < d
    gram = np.einsum("bir,bjr->bij", a, a)
    L, jitter = jittered_cholesky(torch.as_tensor(gram))
    L_j, jitter_j = jax_jittered(jnp.asarray(gram))
    assert jitter > 0
    np.testing.assert_allclose(jitter, float(jitter_j), rtol=1e-6)
    assert torch.isfinite(L).all()
    np.testing.assert_allclose(L.numpy(), np.asarray(L_j), rtol=1e-3, atol=1e-3)
    # The log-det itself takes the log of pivots of the jitter's size, which
    # the rounding of each package decides: only its finiteness is shared.
    ld, _ = cholesky_logdet(torch.as_tensor(gram))
    assert torch.isfinite(ld).all()


def test_non_pd_gives_nan_not_exception():
    from cmf_tpu_torch.ops.chol import _cholesky

    g = torch.tensor([[[1.0, 2.0], [2.0, 1.0]]])  # eigenvalues 3, -1
    assert not torch.isfinite(_cholesky(g)).all()
    big = torch.eye(70).expand(2, 70, 70).clone()
    big[1, 5, 5] = -1.0
    L = _cholesky(big)
    assert torch.isfinite(L[0]).all() and not torch.isfinite(L[1]).all()


def test_gradient_matches_jax():
    import jax

    a = _spd(3, 6, seed=11)
    x = torch.as_tensor(a).requires_grad_(True)
    cholesky_logdet(x)[0].sum().backward()
    want = jax.grad(lambda g: jnp.sum(jax_logdet(g)[0]))(jnp.asarray(a))
    # Only the lower triangle is read, as in the JAX factorisation.
    np.testing.assert_allclose(
        np.tril(x.grad.numpy()), np.tril(np.asarray(want)), rtol=1e-3, atol=1e-4
    )


def test_gram_from_columns_matches_jax():
    cols = np.random.default_rng(4).normal(size=(3, 4, 10)).astype(np.float32)
    np.testing.assert_allclose(
        gram_from_columns(torch.as_tensor(cols)).numpy(),
        np.asarray(jax_gram(jnp.asarray(cols))),
        rtol=1e-5,
        atol=1e-5,
    )
