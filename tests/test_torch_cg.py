"""The port's batched CG (``cmf_tpu_torch/ops/cg.py``) against the JAX
package's ``batched_cg``, on the same SPD systems from a numpy seed: the
solution, the number of iterations (at the image configs' tolerance 1 and at
1e-6), ``first_matvec`` and a zero right-hand side. Then the non-square head's
Hutchinson + CG train elbo and gradients on a flat chain, against JAX with
the same probes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.ops import batched_cg as jax_batched_cg
from cmf_tpu_torch.ops.cg import batched_cg

from _torch_parity import assert_trees_close, batch, build_pair, small_schema, t, torch_grads

# fp32 both sides, the same update formulas in the same order; a few
# iterations of rounding apart.
CG_TOL = 1e-5


def _system(batch, d, s, seed):
    """SPD systems with eigenvalues in about [1, 4]: CG's residual falls by
    about 3× an iteration, so no convergence test lands at fp32's floor."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(batch, d, d)) * 0.5 / np.sqrt(d)
    spd = (np.einsum("bij,bkj->bik", a, a) + np.eye(d)).astype(np.float32)
    rhs = rng.normal(size=(batch, d, s)).astype(np.float32)
    return spd, rhs


def _jax_iterations(A, rhs, tolerance, max_iter, **kw):
    """The iterations the JAX solve ran: the least max_iter whose result is
    already the final one."""
    mv = lambda v: jnp.einsum("bij,bjs->bis", A, v)
    final = np.asarray(jax_batched_cg(mv, rhs, max_iter=max_iter, tolerance=tolerance, **kw))
    for k in range(1, max_iter + 1):
        if np.array_equal(np.asarray(jax_batched_cg(mv, rhs, max_iter=k, tolerance=tolerance, **kw)), final):
            return k, final
    raise AssertionError("unreachable")


@pytest.mark.parametrize("tolerance", [1.0, 1e-6], ids=["tol1", "tol1e-6"])
@pytest.mark.parametrize("first", [False, True], ids=["plain", "first_matvec"])
def test_batched_cg_matches_jax(tolerance, first):
    spd, rhs = _system(4, 32, 2, seed=1)
    A, b = torch.tensor(spd), torch.tensor(rhs)
    calls = []

    def mv(v):
        calls.append(1)
        return torch.einsum("bij,bjs->bis", A, v)

    kw = {"first_matvec": torch.einsum("bij,bjs->bis", A, b)} if first else {}
    got = batched_cg(mv, b, max_iter=32, tolerance=tolerance, **kw).numpy()
    jkw = {"first_matvec": jnp.einsum("bij,bjs->bis", spd, rhs)} if first else {}
    iters, want = _jax_iterations(jnp.asarray(spd), jnp.asarray(rhs), tolerance, 32, **jkw)

    np.testing.assert_allclose(got, want, rtol=CG_TOL, atol=CG_TOL * np.abs(want).max())
    # The peeled first iteration spends a matvec only without first_matvec.
    assert len(calls) == iters - 1 + (0 if first else 1)
    if tolerance == 1.0:
        assert iters == 1  # one Krylov step at the image configs' tolerance
    else:
        assert iters > 3
        np.testing.assert_allclose(np.einsum("bij,bjs->bis", spd, got), rhs, rtol=1e-3, atol=1e-3)


def test_batched_cg_zero_rhs_and_no_iterations():
    spd, rhs = _system(2, 4, 2, seed=2)
    rhs[:, :, 1] = 0.0
    A, b = torch.tensor(spd), torch.tensor(rhs)
    mv = lambda v: torch.einsum("bij,bjs->bis", A, v)
    got = batched_cg(mv, b, max_iter=32, tolerance=1e-6).numpy()
    want = np.asarray(jax_batched_cg(lambda v: jnp.einsum("bij,bjs->bis", spd, v), jnp.asarray(rhs),
                                     max_iter=32, tolerance=1e-6))
    np.testing.assert_array_equal(got[:, :, 1], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert torch.count_nonzero(batched_cg(mv, b, max_iter=0)) == 0


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("CMF_TPU_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("tolerance", [1.0, 1e-6], ids=["tol1", "tol1e-6"])
def test_flat_head_hutchinson_cg_matches_jax(tolerance, pallas_interpret):
    """The head's stochastic path with the iterative solver on a flat chain:
    elbo and every gradient against JAX with the same probes ε."""
    import jax

    schema = small_schema(log_jacobian_method="hutch_with_cg", cg_tolerance=tolerance)
    head = next(layer for layer in schema if layer["type"] == "non-square-head")
    head["hutchinson_solver"] = "cg"
    jd, jv, td = build_pair(schema, seed=11)
    x = batch(8, seed=11)
    rng = jax.random.PRNGKey(4)
    eps = np.asarray(jax.random.normal(rng, (8, 5, 1)))

    def jax_loss(params):
        info, _ = jd.elbo({"params": params, "state": jv["state"]}, jnp.asarray(x), rng=rng, train=True)
        return -jnp.mean(info["elbo"]), info["elbo"]

    (_, elbo_j), grads_j = jax.value_and_grad(jax_loss, has_aux=True)(jv["params"])
    elbo_t = td.elbo(t(x), train=True, hutchinson_eps=t(eps))["elbo"]
    (-elbo_t.mean()).backward()
    np.testing.assert_allclose(elbo_t.detach().numpy(), np.asarray(elbo_j), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(elbo_j)).max())
    grads_t = torch_grads(td)
    scale = max(np.abs(g).max() for g in grads_t.values())
    assert_trees_close(grads_t, grads_j, rtol=1e-3, atol=1e-3 * scale)
