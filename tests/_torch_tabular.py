"""Shared helpers of ``tests/test_torch_square.py`` and
``tests/test_torch_cif.py``: the tabular square and CIF models of both
packages at D = 6 with narrow widths, the JAX package's draws of u in the
order the port takes them, and the per-tensor error measure."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cmf_tpu.config import expand_grid, get_config, get_schema
from cmf_tpu_torch.interop import flatten_tree, jax_path, variables_from_jax

from _torch_parity import build_pair, to_numpy

DIM = 6  # power's width; the masked nets need hidden widths of at least D
HIDDEN = 8

FWD_TOL = 1e-5  # values and log-jacobians, relative
GRAD_TOL = 1e-4  # max err over max |ref|, per tensor
INV_TOL = 1e-5
ROUND_TRIP_TOL = 1e-4  # the spline's quadratic root in fp32

# miniboone's published configs of the four commands, cut to 2 layers and
# widths of 8 (u = 3 for the CIFs).
CUT = {
    "maf": {"ar_map_hidden_channels": [HIDDEN] * 2, "st_nets": [HIDDEN] * 2,
            "p_nets": [HIDDEN] * 2, "q_nets": [HIDDEN] * 2},
    "nsf-ar": {"num_hidden_channels": HIDDEN, "st_nets": [HIDDEN] * 2, "p_nets": [HIDDEN] * 2,
               "q_nets": [HIDDEN] * 2},
    "cond-affine": {"st_nets": [HIDDEN] * 2, "p_nets": [HIDDEN] * 2, "q_nets": [HIDDEN] * 2},
}


def tabular_config(model, baseline=False, **overrides):
    """miniboone's published ``model`` config, cut (the first of a grid)."""
    config = expand_grid(get_config("miniboone", model, use_baseline=baseline))[0]
    config = {**config, "model": model, "dataset": "miniboone", "num_density_layers": 2, **CUT[model]}
    if config["use_cond_affine"]:
        config["num_u_channels"] = 3
    return {**config, **overrides}


def tabular_pair(model, baseline=False, seed=0, **overrides):
    """(config, jax_density, jax_variables, torch_density) at D = 6 with the
    same weights."""
    config = tabular_config(model, baseline, **overrides)
    return (config, *build_pair(get_schema(config), dim=DIM, seed=seed))


def inputs(n, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=(n, DIM))).astype(np.float32)


def jax_elbo_u_noise(key, num_cif_layers, batch, num_u):
    """The ε the JAX package's ``elbo`` draws under ``key``, outermost CIF
    layer first: each layer splits its key into (u's, the prior's)."""
    noise = []
    for _ in range(num_cif_layers):
        key_u, key = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(key_u, (batch, num_u))))
    return noise


def jax_sample_draws(key, num_cif_layers, n, num_u, dim=DIM):
    """The JAX package's draws of ``sample(key, n)`` through a chain of CIF
    layers, in the order the port draws them: the base Gaussian's, then
    each layer's u from the innermost out."""
    u_keys = []
    for _ in range(num_cif_layers):
        key, key_u = jax.random.split(key)
        u_keys.append(key_u)
    draws = [np.asarray(jax.random.normal(key, (n, dim)))]
    draws += [np.asarray(jax.random.normal(k, (n, num_u))) for k in reversed(u_keys)]
    return draws


def rel_err(got, want):
    """max |got − want| over max |want|."""
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got, np.float64) - want).max()
    return err / scale if scale else err


def assert_grads_close(module, want_tree, tol, prefix="", path=jax_path):
    """Every parameter gradient of ``module`` against the JAX gradient tree,
    max err over max |ref| per tensor; ``path`` maps a port name to its JAX
    path."""
    want = flatten_tree(to_numpy(want_tree))
    got = {path(prefix + n): p.grad.numpy() for n, p in module.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        assert rel_err(got[k], want[k]) <= tol, (k, rel_err(got[k], want[k]))


def t(a):
    return torch.tensor(np.asarray(a))


def bijection_pair(jax_bij, port_bij, seed, load=variables_from_jax):
    variables = jax_bij.init(jax.random.PRNGKey(seed))
    # Move every parameter off its init so that each one is exercised.
    leaves, treedef = jax.tree.flatten(variables["params"])
    keys = jax.random.split(jax.random.PRNGKey(seed + 100), len(leaves))
    leaves = [p + 0.1 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)]
    variables = {"params": jax.tree.unflatten(treedef, leaves), "state": variables["state"]}
    load(port_bij, to_numpy(variables))
    return variables


def check_forward(jax_bij, port_bij, x, seed=0, load=variables_from_jax, path=jax_path):
    """Forward values, log-jacobians and gradients (of a random linear
    functional of both, in the parameters and the input) against the JAX
    bijection on the same weights; returns (JAX variables, JAX z)."""
    variables = bijection_pair(jax_bij, port_bij, seed, load)
    r = np.random.default_rng(seed + 1)
    wz = r.normal(size=x.shape).astype(np.float32)
    wl = r.normal(size=x.shape[0]).astype(np.float32)

    @jax.jit
    def value_and_grads(params, xj):
        def loss(p, xx):
            z, lj, _ = jax_bij.forward({"params": p, "state": variables["state"]}, xx)
            return jnp.sum(z * wz) + jnp.sum(lj * wl), (z, lj)

        (_, (z, lj)), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, xj)
        return z, lj, grads

    z_j, lj_j, (g_params, g_x) = value_and_grads(variables["params"], jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    z_t, lj_t = port_bij(xt)
    ((z_t * t(wz)).sum() + (lj_t * t(wl)).sum()).backward()
    assert rel_err(z_t.detach().numpy(), z_j) <= FWD_TOL
    assert rel_err(lj_t.detach().numpy(), lj_j) <= FWD_TOL
    assert rel_err(xt.grad.numpy(), g_x) <= GRAD_TOL
    assert_grads_close(port_bij, g_params, GRAD_TOL, path=path)
    return variables, z_j


def check_bijection(jax_bij, port_bij, x, seed=0, inverse_tol=INV_TOL, round_trip_tol=None,
                    load=variables_from_jax, path=jax_path):
    """``check_forward``, then the inverse, and where asked the round
    trip."""
    variables, z_j = check_forward(jax_bij, port_bij, x, seed, load, path)
    x_j, lji_j = jax.jit(lambda v, zz: jax_bij.inverse(v, zz))(variables, z_j)
    with torch.no_grad():
        x_t, lji_t = port_bij.inverse(t(z_j))
    assert rel_err(x_t.numpy(), x_j) <= inverse_tol
    assert rel_err(lji_t.numpy(), lji_j) <= inverse_tol
    if round_trip_tol is not None:
        assert rel_err(x_t.numpy(), x) <= round_trip_tol


def assert_updated(td, grads_j, params_j, lr):
    """The gradients, then the parameters after the update: within 1e-5
    relative where the JAX gradient is above a thousandth of its tensor's
    largest, and within 2·lr (Adam's bound on a step) where it is not."""
    assert_grads_close(td, grads_j, GRAD_TOL)
    grads = flatten_tree(to_numpy(grads_j))
    for name, p in td.named_parameters():
        k = jax_path(name)
        want = flatten_tree(to_numpy(params_j))[k]
        diff = np.abs(p.detach().numpy() - want)
        big = np.abs(grads[k]) > 1e-3 * np.abs(grads[k]).max()
        assert np.all(diff[big] <= 1e-5 * np.abs(want[big]) + 1e-6), k
        assert np.all(diff <= 2 * lr), k
