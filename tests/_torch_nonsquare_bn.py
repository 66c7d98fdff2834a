"""Shared helpers of ``tests/test_torch_nonsquare_batchnorm.py`` and
``tests/test_torch_nonsquare_batchnorm_image.py``: the tolerances, the JAX
package's jitted training elbo with its gradient and state, the port's, and
the comparisons of gradients and post-forward statistics."""

import jax
import jax.numpy as jnp
import numpy as np

from cmf_tpu_torch.densities import NonSquareHeadDensity
from cmf_tpu_torch.interop import flatten_tree, jax_path
from cmf_tpu_torch.nets import batch_statistics

from _torch_parity import t, to_numpy, torch_grads

# The elbo and the statistics: relative to the largest entry.
ELBO_TOL = 1e-5
STATE_TOL = 1e-5
# Gradients: max err over the tensor's max |grad|. A tensor whose gradient
# vanishes in exact arithmetic (a log-scale or shift feeding a training-mode
# batch-norm, whose batch statistics take it away) holds rounding noise in
# both packages: where the JAX gradient's max is below GRAD_TOL of the
# model's largest, it is held at GRAD_TOL of the model's largest.
GRAD_TOL = 1e-4
def rel_err(got, want):
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got, np.float64) - want).max()
    return err / scale if scale else err


def assert_grads(td, jax_grads):
    got = torch_grads(td)
    want = flatten_tree(to_numpy(jax_grads))
    assert set(got) == set(want)
    top = max(np.abs(g).max() for g in want.values())
    for k, w in want.items():
        scale = np.abs(w).max()
        if scale < GRAD_TOL * top:
            scale = top
        assert np.abs(got[k] - w).max() <= GRAD_TOL * scale, k


def assert_state(td, jax_state):
    """Every buffer of the port that the JAX state holds, after the step."""
    want = flatten_tree(to_numpy(jax_state))
    got = {jax_path(n): b.detach().numpy() for n, b in td.named_buffers()}
    common = set(got) & set(want)
    assert any(k.endswith(("batch_mean", ".mean")) for k in common)
    for k in common:
        assert rel_err(got[k], want[k]) <= STATE_TOL, k


def jax_train_step(jd, jv, x, **kw):
    """The JAX training elbo, the gradient of its negated mean and the state
    it returns, jitted."""

    def loss(params):
        info, state = jd.elbo({"params": params, "state": jv["state"]}, jnp.asarray(x), train=True, **kw)
        return -jnp.mean(info["elbo"]), (info["elbo"], state)

    (_, (elbo, state)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jv["params"])
    return np.asarray(elbo), grads, state


def port_train_elbo(td, x, **kw):
    td.zero_grad(set_to_none=True)
    with batch_statistics(td):
        elbo = td.elbo(t(x), train=True, **kw)["elbo"]
    (-elbo.mean()).backward()
    return elbo.detach().numpy()


def head_of(td):
    return next(m for m in td.modules() if isinstance(m, NonSquareHeadDensity))
