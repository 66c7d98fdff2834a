"""The port's fused Gram + Cholesky + log-det (``cmf_tpu_torch/ops/
gram_logdet.py``) against the JAX package's Pallas kernel in interpret mode
and against its plain Gram + jittered Cholesky.

On the CPU the wrapper takes the kernels' plain versions, which these tests
hold to the JAX reference. The CUDA kernels themselves are held against the
same plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.ops import cholesky_logdet, gram_from_columns
from cmf_tpu.ops.pallas.gram_logdet import _fused_fwd_impl as jax_fused_fwd_impl
from cmf_tpu.ops.pallas.gram_logdet import fused_gram_logdet as jax_fused
from cmf_tpu_torch.ops import gram_logdet as gl

# fp32 on both sides, summed in another order.
VALUE_TOL = 1e-4
GRAD_TOL = 1e-3


def _cols(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _loss_torch(gram, ld, w_ld, c_off):
    off = 1.0 - torch.eye(gram.shape[-1])
    return (ld * w_ld).sum() + c_off * (gram * off).abs().sum()


def _loss_jax(gram, ld, w_ld, c_off):
    off = 1.0 - jnp.eye(gram.shape[-1])
    return jnp.sum(ld * w_ld) + c_off * jnp.sum(jnp.abs(gram * off))


@pytest.mark.parametrize("shape", [(5, 20, 11), (1, 5, 7), (3, 200, 6), (4, 1, 9)])
def test_plain_forward_matches_jax(shape):
    cols = _cols(shape, seed=sum(shape))
    gram, ld = gl.fused_gram_logdet(torch.as_tensor(cols))
    gram_k, ld_k = jax_fused(jnp.asarray(cols), True)
    gram_r = gram_from_columns(jnp.asarray(cols))
    ld_r, _ = cholesky_logdet(gram_r)
    for ref_g, ref_ld in ((gram_k, ld_k), (gram_r, ld_r)):
        np.testing.assert_allclose(gram.numpy(), np.asarray(ref_g), rtol=VALUE_TOL, atol=VALUE_TOL)
        np.testing.assert_allclose(ld.numpy(), np.asarray(ref_ld), rtol=VALUE_TOL, atol=VALUE_TOL)


@pytest.mark.parametrize("shape", [(5, 20, 11), (1, 5, 7), (3, 200, 6)])
def test_plain_backward_matches_jax(shape):
    """Gradient of a log-det term and an |off-diagonal| Gram term (nonzero
    Ḡ and ḡ_ld) through the port's autograd.Function against jax.grad through
    the Pallas kernel's custom VJP and through the XLA path."""
    cols = _cols(shape, seed=7 + sum(shape))
    w_ld = np.random.default_rng(1).normal(size=shape[1]).astype(np.float32)
    c_off = 0.3

    jt = torch.as_tensor(cols).requires_grad_(True)
    _loss_torch(*gl.fused_gram_logdet(jt), torch.as_tensor(w_ld), c_off).backward()

    def f_kernel(c):
        return _loss_jax(*jax_fused(c, True), w_ld, c_off)

    def f_ref(c):
        g = gram_from_columns(c)
        return _loss_jax(g, cholesky_logdet(g)[0], w_ld, c_off)

    for f in (f_kernel, f_ref):
        want = np.asarray(jax.grad(f)(jnp.asarray(cols)))
        np.testing.assert_allclose(jt.grad.numpy(), want, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_plain_bwd_formula_matches_jax_vjp():
    """``gram_logdet_bwd_plain`` (the dJ formula the backward kernel
    computes) against the Pallas VJP for arbitrary cotangents Ḡ, ḡ_ld."""
    d, b, big_d = 4, 30, 9
    rng = np.random.default_rng(3)
    cols = rng.normal(size=(d, b, big_d)).astype(np.float32)
    gbar = rng.normal(size=(b, d, d)).astype(np.float32)
    ldbar = rng.normal(size=(b,)).astype(np.float32)
    _, vjp = jax.vjp(lambda c: jax_fused(c, True), jnp.asarray(cols))
    (want,) = vjp((jnp.asarray(gbar), jnp.asarray(ldbar)))
    _, _, L = gl.gram_logdet_plain(torch.as_tensor(cols))
    got = gl.gram_logdet_bwd_plain(torch.as_tensor(cols), L, torch.as_tensor(gbar), torch.as_tensor(ldbar))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GRAD_TOL, atol=GRAD_TOL)


def _bwd_inputs(shape, seed):
    d, b, _ = shape
    rng = np.random.default_rng(seed)
    cols = rng.normal(size=shape).astype(np.float32)
    gbar = rng.normal(size=(b, d, d)).astype(np.float32)
    ldbar = rng.normal(size=(b,)).astype(np.float32)
    return cols, gbar, ldbar


def _upper_poisoned(L):
    """L with NaN above the diagonal: the backward kernel reads only the
    lower triangle."""
    iu = torch.triu_indices(L.shape[-1], L.shape[-1], 1)
    L = L.clone()
    L[:, iu[0], iu[1]] = float("nan")
    return L


@pytest.mark.parametrize("shape", [(4, 30, 9), (1, 5, 7), (5, 1, 11), (8, 33, 40)])
def test_bwd_solves_emulation_matches_plain_and_jax_vjp(shape):
    """The backward kernel's algorithm (forward then back substitution, no
    G⁻¹), emulated in torch ops, against the plain dJ formula and against the
    Pallas backward kernel's VJP in interpret mode."""
    cols, gbar, ldbar = _bwd_inputs(shape, seed=11 + sum(shape))
    _, vjp = jax.vjp(lambda c: jax_fused(c, True), jnp.asarray(cols))
    (want,) = vjp((jnp.asarray(gbar), jnp.asarray(ldbar)))
    jt, gt, lt = (torch.as_tensor(a) for a in (cols, gbar, ldbar))
    _, _, L = gl.gram_logdet_plain(jt)
    got = gl.gram_logdet_bwd_solves_emulated(jt, _upper_poisoned(L), gt, lt)
    plain = gl.gram_logdet_bwd_plain(jt, L, gt, lt)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GRAD_TOL, atol=GRAD_TOL)


def test_bwd_solves_emulation_mixed_nan_factor_batch():
    """Elements with a NaN factor and ḡ_ld = 0 (the fallback case) beside
    elements with a finite factor and ḡ_ld ≠ 0: the gradient is finite where
    ḡ_ld = 0 and equals the plain version everywhere."""
    shape = (6, 24, 13)
    cols, gbar, ldbar = _bwd_inputs(shape, seed=5)
    jt, gt, lt = (torch.as_tensor(a) for a in (cols, gbar, ldbar))
    _, _, L = gl.gram_logdet_plain(jt)
    bad = torch.arange(shape[1]) % 3 == 0
    L = L.clone()
    L[bad] = float("nan")
    lt[bad] = 0.0
    got = gl.gram_logdet_bwd_solves_emulated(jt, _upper_poisoned(L), gt, lt)
    plain = gl.gram_logdet_bwd_plain(jt, L, gt, lt)
    assert torch.isfinite(got[:, bad]).all()
    assert torch.isfinite(plain).all()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)
    # Where ḡ_ld = 0 the gradient is the Ḡ term alone.
    gbar_only = torch.einsum("bij,jbD->ibD", gt + gt.transpose(-1, -2), jt)
    np.testing.assert_allclose(got[:, bad].numpy(), gbar_only[:, bad].numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)


def _jax_kernel_fwd(cols):
    """The Pallas forward kernel in interpret mode: (gram, logdet, L), with
    L moved to (B, d, d)."""
    gram, logdet, (_, l_t) = jax_fused_fwd_impl(jnp.asarray(cols), True)
    b = cols.shape[1]
    return np.asarray(gram), np.asarray(logdet), np.moveaxis(np.asarray(l_t)[:, :, :b], -1, 0)


@pytest.mark.parametrize("shape", [(1, 6, 7), (5, 20, 11), (9, 12, 17), (8, 10, 13), (5, 1, 9), (2, 9, 3)])
def test_fwd_panels_emulation_matches_plain_and_jax_kernel(shape):
    """The forward kernel's algorithm (the Gram in one order, the identity-
    padded factor in 4-column panels), emulated in torch ops, against the
    plain version and the Pallas forward kernel in interpret mode: d not a
    multiple of 4 (1, 5, 9) and a multiple (8), B=1 and D < 4."""
    cols = _cols(shape, seed=13 + sum(shape))
    gram, ld, L = gl.gram_logdet_fwd_panels_emulated(torch.as_tensor(cols))
    d, b, _ = shape
    assert gram.shape == L.shape == (b, d, d) and ld.shape == (b,)
    assert gram.dtype == ld.dtype == L.dtype == torch.float32
    assert (torch.triu(L, 1) == 0).all()
    plain = [t.numpy() for t in gl.gram_logdet_plain(torch.as_tensor(cols))]
    for ref in (plain, _jax_kernel_fwd(cols)):
        for got, want in zip((gram, ld, L), ref):
            np.testing.assert_allclose(got.numpy(), want, rtol=VALUE_TOL, atol=VALUE_TOL)


def test_fwd_panels_emulation_non_pd_batch():
    """Every third element has a rank-deficient J (a zero row, at a row that
    moves with the element), the others full rank: the log-det is
    non-finite exactly where the Pallas kernel's is, and equal elsewhere."""
    d, b, big_d = 6, 24, 9
    cols = _cols((d, b, big_d), seed=17)
    bad = np.arange(b) % 3 == 0
    for e in np.flatnonzero(bad):
        cols[e % d, e] = 0.0
    _, ld, _ = gl.gram_logdet_fwd_panels_emulated(torch.as_tensor(cols))
    _, ld_k, _ = _jax_kernel_fwd(cols)
    _, ld_p, _ = gl.gram_logdet_plain(torch.as_tensor(cols))
    ld = ld.numpy()
    np.testing.assert_array_equal(~np.isfinite(ld), ~np.isfinite(ld_k))
    np.testing.assert_array_equal(~np.isfinite(ld), bad)
    np.testing.assert_array_equal(~np.isfinite(ld_p.numpy()), bad)
    np.testing.assert_allclose(ld[~bad], ld_k[~bad], rtol=VALUE_TOL, atol=VALUE_TOL)


def test_nan_on_rank_deficient():
    """A rank-deficient Jacobian gives a non-finite log-det (no exception),
    as the Pallas kernel does, so the caller's jitter fallback fires."""
    base = _cols((2, 3, 8), seed=0)
    cols = np.concatenate([base, base[:1], base[1:2]], axis=0)  # rank 2 < d=4
    _, ld = gl.fused_gram_logdet(torch.as_tensor(cols))
    _, ld_k = jax_fused(jnp.asarray(cols), True)
    assert not np.all(np.isfinite(np.asarray(ld_k)))
    assert not torch.isfinite(ld).all()


def test_cpu_tensor_takes_plain_version_without_launch():
    before = gl.launch_counts()
    cols = torch.as_tensor(_cols((3, 6, 5), seed=1)).requires_grad_(True)
    gram, ld = gl.fused_gram_logdet(cols)
    (ld.sum() + gram.sum()).backward()
    assert gl.launch_counts() == before
    assert torch.isfinite(cols.grad).all()


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_cuda_wrappers_refuse_cpu_tensors(which):
    """The kernel wrappers launch on a CUDA tensor or raise: never a quiet
    fallback."""
    cols = torch.zeros((3, 4, 5))
    with pytest.raises(ValueError, match="CUDA"):
        if which == "fwd":
            gl.gram_logdet_fwd_cuda(cols)
        else:
            gl.gram_logdet_bwd_cuda(cols, torch.zeros(4, 3, 3), torch.zeros(4, 3, 3), torch.zeros(4))


def test_size_gate_is_the_jax_gate():
    from cmf_tpu.ops.pallas import gram_logdet as jax_gl

    assert (gl.MAX_D_LATENT, gl.MAX_D_AMBIENT) == (jax_gl._MAX_D_LATENT, jax_gl._MAX_D_AMBIENT)
    assert gl.fused_gram_logdet_available(32, 128)
    assert not gl.fused_gram_logdet_available(33, 43)
    assert not gl.fused_gram_logdet_available(21, 129)


def test_fwd_phases_tool_stamps_every_step():
    """The phase probe of the forward kernel finds each of its anchors in the
    kernel's source (it stops where a step moved) and stamps each step once."""
    from cmf_tpu_torch.tools import gram_logdet_fwd_phases as phases

    src = phases.stamped_source()
    for p in range(6):
        assert src.count(f"ST({p})") == 1
    assert src.count("GT(6)") == src.count("GT(7)") == 1
    assert "cmf_fwd_phases_read" in src
