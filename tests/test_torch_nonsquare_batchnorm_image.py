"""Batch-norm ResNet couplers in a non-square image model: mnist's
non-square schema at 8×8 with ``resnet_batchnorm=True`` against the JAX
package on the same weights (carried by ``interop``), with its
dequantization noise and Hutchinson probes passed in. The JAX package's
decode normalises each coupler's input by that input's batch statistics
under ``jax.linearize`` and drops the state it returns; the port's does the
same and its couplers move their running statistics once a step, in the
forward. Tolerances and helpers are those of
``tests/_torch_nonsquare_bn.py``; this file holds the one case
whose JAX side takes most of its time (the jit of the second-order
Hutchinson gradient through six conv couplers)."""

import jax
import jax.numpy as jnp
import numpy as np

from cmf_tpu.config import expand_grid, get_config, get_schema
from cmf_tpu.models import get_density as jax_get_density
from cmf_tpu_torch.interop import variables_from_jax
from cmf_tpu_torch.models import get_density
from cmf_tpu_torch.nets import BatchNorm2d

from _torch_nonsquare_bn import (
    ELBO_TOL,
    assert_grads,
    assert_state,
    head_of,
    jax_train_step,
    port_train_elbo,
    rel_err,
)
from _torch_parity import t, to_numpy

X_SHAPE = (1, 8, 8)
N = 4
IMAGE_LATENT = 20


def test_image_chain_with_batch_norm_resnets_matches_jax():
    """mnist's non-square schema at 8×8 with ``resnet_batchnorm=True``, the
    small RealNVP (two checkerboard, two channel and two more checkerboard
    couplings around the squeeze and the split) and a two-layer prior: the
    Hutchinson + CG training elbo. The JAX package's decode normalises each
    coupler's input by its batch statistics under ``jax.linearize`` and
    drops the state it returns; the couplers' running statistics move once,
    in the forward."""
    config = expand_grid(get_config("mnist", "non-square", use_baseline=False))[0]
    config.update(g_hidden_channels=[8], prior_hidden_channels=[8], resnet_batchnorm=True,
                  smaller_realnvp=True, prior_num_density_layers=2)
    schema = get_schema(config)
    jd = jax_get_density(schema, x_shape=X_SHAPE)
    jv = jd.init(jax.random.PRNGKey(0))
    td = get_density(schema, x_shape=X_SHAPE, device="cpu")
    variables_from_jax(td, to_numpy(jv))
    assert head_of(td).log_jacobian_method == "hutch_with_cg"
    num_bn = sum(isinstance(m, BatchNorm2d) for m in td.modules())
    assert num_bn == 6 * 3

    x = np.random.default_rng(0).integers(0, 256, size=(N, *X_SHAPE)).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    rng_deq, rng_rest = jax.random.split(rng)
    noise = np.asarray(jax.random.uniform(rng_deq, x.shape, dtype=jnp.float32))
    eps = np.asarray(jax.random.normal(rng_rest, (N, IMAGE_LATENT, 1), dtype=jnp.float32))
    elbo_j, grads_j, state_j = jax_train_step(jd, jv, x, rng=rng)
    elbo_t = port_train_elbo(td, x, dequantization_noise=t(noise), hutchinson_eps=t(eps))
    assert rel_err(elbo_t, elbo_j) <= ELBO_TOL
    assert_grads(td, grads_j)
    assert_state(td, state_j)
    # Every coupler batch-norm is back to moving its statistics.
    assert all(m.updates_running for m in td.modules() if isinstance(m, BatchNorm2d))

