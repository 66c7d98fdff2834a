"""Shared helper of the 2-D zoo's parity tests: one dataset's published
non-square model (``--model non-square``, its config at full width, with
overrides) built by both packages' factories, the JAX weights perturbed away
from their init (the affine prior starts at zero shift and log-scale) and
carried into the port by ``interop``, and rows of the dataset's train split.
"""

import jax
import numpy as np

from cmf_tpu.config import expand_grid, get_config, get_schema
from cmf_tpu.data.two_d import get_2d_data
from cmf_tpu.models import get_density as jax_get_density
from cmf_tpu_torch.interop import variables_from_jax
from cmf_tpu_torch.models import get_density as torch_get_density

from _torch_parity import to_numpy


def zoo_config(dataset, **overrides):
    config = expand_grid(get_config(dataset, "non-square", use_baseline=False))[0]
    return {**config, "model": "non-square", "dataset": dataset, **overrides}


def sphere_pair(dataset, seed=0, n=32, scale=0.1, **overrides):
    """(jax_density, jax_variables, torch_density, x (n, D) float32)."""
    schema = get_schema(zoo_config(dataset, **overrides))
    x = get_2d_data(dataset, n, seed=seed)
    x_shape = x.shape[1:]
    jd = jax_get_density(schema, x_shape=x_shape)
    jv = jd.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jv["params"] = jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.normal(size=a.shape).astype(np.float32), jv["params"]
    )
    td = torch_get_density(schema, x_shape=x_shape, device="cpu")
    variables_from_jax(td, to_numpy(jv))
    return jd, jv, td, x
