"""The slice as a whole: the non-square head's elbo and every parameter
gradient in the port against the JAX package, on one small schema built by
both factories with the JAX weights and state carried across by ``interop``.
The JAX side runs its Pallas Gram + log-det kernel in interpret mode
(``CMF_TPU_PALLAS_INTERPRET=1``), the port its plain versions on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu_torch.densities import nonsquare
from cmf_tpu_torch.interop import variables_from_jax

from _torch_parity import assert_trees_close, batch, build_pair, small_schema, t, to_numpy, torch_grads

ELBO_TOL = 1e-4
GRAD_TOL = 1e-3  # second-order terms through the log-det, fp32 both sides

VARIANTS = {
    "plain": {},
    "g_kk": {"add_diagonal_metric_reg": True, "metric_wt": 0.3},
    "g_ij": {"add_offdiagonal_metric_reg": True, "metric_wt": 0.3},
    "warmup": {"skip_likelihood": True, "likelihood_wt": 0.0},
}


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("CMF_TPU_PALLAS_INTERPRET", "1")


def _elbo_both(variant, seed):
    kw = {"likelihood_wt": 1.0, "add_reconstruction": True, **VARIANTS[variant]}
    jd, jv, td = build_pair(small_schema(), seed=seed)
    x = batch(8, seed=seed)

    def jax_loss(params):
        info, _ = jd.elbo({"params": params, "state": jv["state"]}, jnp.asarray(x), train=True, **kw)
        return -jnp.mean(info["elbo"]), info["elbo"]

    (_, elbo_j), grads_j = jax.value_and_grad(jax_loss, has_aux=True)(jv["params"])
    elbo_t = td.elbo(t(x), **kw)["elbo"]
    (-elbo_t.mean()).backward()
    return (elbo_t.detach().numpy(), torch_grads(td)), (np.asarray(elbo_j), grads_j)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_elbo_and_gradients_match_jax(variant, pallas_interpret):
    (elbo_t, grads_t), (elbo_j, grads_j) = _elbo_both(variant, seed=5)
    np.testing.assert_allclose(elbo_t, elbo_j, rtol=ELBO_TOL, atol=ELBO_TOL * np.abs(elbo_j).max())
    scale = max(np.abs(g).max() for g in grads_t.values())
    assert_trees_close(grads_t, grads_j, rtol=GRAD_TOL, atol=GRAD_TOL * scale)


def test_interop_carries_the_tail_permutation():
    """The tail's permutation is state: it must come from the JAX tree, not
    from the port's own draw."""
    jd, jv, td = build_pair(small_schema(), seed=6)
    node, jstate = td, jv["state"]
    while not isinstance(node, nonsquare.NonSquareTailDensity):
        node, jstate = node.prior, jstate["prior"]
    np.testing.assert_array_equal(node.permutation.numpy(), np.asarray(jstate["permutation"]))
    np.testing.assert_array_equal(
        node.inverse_permutation.numpy(), np.asarray(jstate["inverse_permutation"])
    )
    bad = to_numpy(jv)
    bad["params"]["prior"]["extra"] = np.zeros(3)
    with pytest.raises(KeyError):
        variables_from_jax(td, bad)


def test_non_finite_kernel_logdet_falls_back(monkeypatch):
    """A non-finite fused log-det is recomputed with the jittered Cholesky
    on the kernel's Gram, counted, and the gradient still flows (through Ḡ)."""
    _, _, td = build_pair(small_schema(), seed=7)
    x = t(batch(8, seed=7))
    want = td.elbo(x)["elbo"].detach()
    fused = nonsquare.fused_gram_logdet

    # The kernel's own NaN output: the cotangent the head gives it passes
    # through unchanged (a product with NaN would turn its zero into NaN).
    # That the real backward kernel keeps the gradient finite under that
    # zero cotangent is held on the card by chip_smoke.py's mixed batch of
    # NaN factors with ḡ_ld = 0.
    def nan_logdet(jac_cols):
        gram, ld = fused(jac_cols)
        return gram, ld + float("nan")

    monkeypatch.setattr(nonsquare, "fused_gram_logdet", nan_logdet)
    monkeypatch.setattr(nonsquare, "LOGDET_FALLBACKS", {})
    got = td.elbo(x)["elbo"]
    assert nonsquare.logdet_fallbacks() == 1
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), rtol=1e-5, atol=1e-3)
    (-got.mean()).backward()
    assert all(torch.isfinite(p.grad).all() for p in td.parameters())


def test_hutchinson_waits_for_a_later_slice():
    """On a flat chain Hutchinson's 'auto' solver resolves to the exact-Gram
    one in both packages, each warning once that the CG settings it was
    given are inert; the training elbo is finite and trains."""
    schema = small_schema(log_jacobian_method="hutch_with_cg")
    jd, _, td = build_pair(schema)
    with pytest.warns(UserWarning, match="resolved to the exact-Gram solver") as warned_j:
        assert jd._resolved_hutch_solver(5) == "gram"
        jd._resolved_hutch_solver(5)
    with pytest.warns(UserWarning, match="resolved to the exact-Gram solver") as warned_t:
        assert td._resolved_hutch_solver(5) == "gram"
        td._resolved_hutch_solver(5)
    assert len(warned_j) == len(warned_t) == 1
    assert [str(w.message) for w in warned_t] == [str(w.message) for w in warned_j]
    elbo = td.elbo(t(batch(4)), train=True, generator=torch.Generator().manual_seed(0))["elbo"]
    (-elbo.mean()).backward()
    assert torch.isfinite(elbo).all()
    assert all(torch.isfinite(p.grad).all() for p in td.parameters() if p.grad is not None)


def test_unported_layer_raises_naming_it():
    """The small schema with a ``sigmoid`` layer in its low-dimensional
    prior (after the tail's ``flatten``) builds in both packages and gives
    the same elbo; a layer type neither knows raises in ``cmf_tpu``'s
    words."""
    from cmf_tpu_torch.models import get_density

    schema = small_schema()
    schema.insert(7, {"type": "sigmoid"})
    assert [layer["type"] for layer in schema[5:8]] == ["non-square-base", "flatten", "sigmoid"]
    jd, jv, td = build_pair(schema, seed=9)
    x = batch(8, seed=9)
    info, _ = jax.jit(lambda v, xx: jd.elbo(v, xx))(jv, jnp.asarray(x))
    with torch.no_grad():
        elbo = td.elbo(t(x))["elbo"].numpy()
    want = np.asarray(info["elbo"])
    np.testing.assert_allclose(elbo, want, rtol=ELBO_TOL, atol=ELBO_TOL * np.abs(want).max())
    schema[7] = {"type": "softsign"}
    with pytest.raises(AssertionError, match="Invalid layer type softsign"):
        get_density(schema, x_shape=(11,), device="cpu")
