"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: one small
non-square model built by both packages' factories from one schema, with the
JAX package's weights and state carried into the port by ``interop``.
Inputs come from numpy seeds; arrays cross between the packages as numpy.
"""

import jax
import numpy as np
import torch

from cmf_tpu.config import expand_grid, get_config, get_schema
from cmf_tpu.models import get_density as jax_get_density
from cmf_tpu_torch.interop import flatten_tree, jax_path, variables_from_jax
from cmf_tpu_torch.models import get_density as torch_get_density

DIM = 11  # ambient D of the small models


def small_config(**overrides):
    """miniboone non-square, cut to a few layers and narrow widths."""
    config = expand_grid(get_config("miniboone", "non-square", use_baseline=False))[0]
    config.update(
        num_density_layers=3,
        coupler_hidden_channels=[16, 16],
        latent_dimension=5,
        prior_num_density_layers=2,
        prior_hidden_channels=[8],
    )
    config.update(overrides)
    return config


def small_schema(**overrides):
    return get_schema(small_config(**overrides))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def build_pair(schema, dim=DIM, seed=0):
    """(jax_density, jax_variables, torch_density) with equal weights."""
    jd = jax_get_density(schema, x_shape=(dim,))
    jv = jd.init(jax.random.PRNGKey(seed))
    td = torch_get_density(schema, x_shape=(dim,), device="cpu")
    variables_from_jax(td, to_numpy(jv))
    return jd, jv, td


def batch(n, dim=DIM, seed=0):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)


def torch_params(td):
    """{JAX path: numpy value} of the port's parameters."""
    return {jax_path(n): p.detach().numpy() for n, p in td.named_parameters()}


def torch_grads(td):
    """{JAX path: gradient}, zero where the loss does not reach a parameter
    (as jax.grad gives it)."""
    return {
        jax_path(n): np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
        for n, p in td.named_parameters()
    }


def assert_trees_close(got, want_tree, rtol, atol):
    """``got`` {JAX path: array} against a JAX params tree, leaf by leaf."""
    want = flatten_tree(to_numpy(want_tree))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def t(a):
    return torch.tensor(np.asarray(a))  # a copy: JAX's numpy views are read-only
