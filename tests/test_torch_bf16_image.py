"""The small image Hutchinson + CG head of ``tests/test_nonsquare.py:317``
under ``compute_dtype="bfloat16"``, the port against the JAX package on the
same weights, dequantization noise and probes, at the limits of
``test_torch_bf16.py`` (whose helpers it uses): a file of its own, since
the JAX side's two compiles of the model's gradient take most of a minute
on a CPU."""

import jax
import jax.numpy as jnp
import numpy as np

from cmf_tpu.config import expand_grid, get_config, get_schema
from cmf_tpu.models import get_density as jax_get_density
from cmf_tpu_torch import nets
from cmf_tpu_torch.densities import NonSquareHeadDensity
from cmf_tpu_torch.interop import variables_from_jax
from cmf_tpu_torch.models import get_density

from _torch_parity import t, to_numpy, torch_grads
from test_torch_bf16 import (  # noqa: F401  (fp32_policies: the autouse fixture)
    VALUE_TOL,
    _jax_elbo_and_grads,
    assert_close_under_gap,
    assert_grads_close_under_gap,
    fp32_policies,
)

IMAGE_SHAPE, IMAGE_LATENT = (1, 8, 8), 4


def test_image_hutchinson_head_matches_jax():
    """The image model of tests/test_nonsquare.py:317 (mnist's non-square
    schema at 8×8, d = 4) through Hutchinson + CG, with the JAX package's
    dequantization noise and probes: the training elbo and every parameter
    gradient; the CG's JVPs and VJPs run through the bf16 convs. Its
    ResNets are cut from two blocks of width 4 to one, which halves the JAX
    side's two compiles (~35 s on a CPU at one block)."""
    config = expand_grid(get_config("mnist", "non-square", use_baseline=False))[0]
    config.update({"seed": 0, "g_hidden_channels": [4], "prior_num_density_layers": 2,
                   "prior_hidden_channels": [8] * 2, "latent_dimension": IMAGE_LATENT})
    schema = get_schema(config)
    jd = jax_get_density(schema, x_shape=IMAGE_SHAPE)
    jv = jd.init(jax.random.PRNGKey(0))
    td = get_density(schema, x_shape=IMAGE_SHAPE, device="cpu")
    variables_from_jax(td, to_numpy(jv))
    x = np.random.default_rng(0).uniform(0, 255, size=(4, *IMAGE_SHAPE)).astype(np.float32)
    rng = jax.random.PRNGKey(1)
    rng_deq, rng_rest = jax.random.split(rng)
    noise = np.asarray(jax.random.uniform(rng_deq, x.shape, dtype=jnp.float32))
    eps = np.asarray(jax.random.normal(rng_rest, (4, IMAGE_LATENT, 1), dtype=jnp.float32))
    (elbo32, g32), (elbo16, g16) = _jax_elbo_and_grads(jd, jv, x, rng=rng, train=True)
    head = next(m for m in td.modules() if isinstance(m, NonSquareHeadDensity))
    assert head._resolved_hutch_solver(IMAGE_LATENT) == "cg"
    with nets.compute_dtype("bfloat16"):
        elbo = td.elbo(t(x), train=True, dequantization_noise=t(noise), hutchinson_eps=t(eps))["elbo"]
    (-elbo.mean()).backward()
    assert_close_under_gap(elbo.detach().numpy(), elbo16, elbo32, VALUE_TOL, name="elbo")
    assert_grads_close_under_gap(torch_grads(td), g16, g32)
