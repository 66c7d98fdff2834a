"""Shared helpers of ``tests/test_torch_image_square.py`` and
``tests/test_torch_glow.py``: the four published image square-flow and
image-CIF commands cut to 8×8 images, 2-4 channel widths and 2 steps a
scale, built by both factories with the same weights; the JAX package's
draws recorded while its jitted functions trace and replayed into the port
in the same order; and the parity checks of one model."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import cmf_tpu.densities.gaussian as jax_gaussian
from cmf_tpu.config import expand_grid, get_config, get_schema
from cmf_tpu.models import get_density as jax_get_density
from cmf_tpu_torch.densities import DiagonalGaussianDensity, gaussian
from cmf_tpu_torch.interop import flatten_tree, jax_path, variables_from_jax
from cmf_tpu_torch.models import get_density
from cmf_tpu_torch.nets import BatchNorm2d, batch_statistics

from _torch_parity import to_numpy
from _torch_tabular import GRAD_TOL, rel_err, t

VALUE_TOL = 1e-5  # values, relative
STATE_TOL = 1e-5  # running statistics after a step, relative
BATCH = 8
SIZE = 8  # image height and width

# (dataset, model, baseline) → the cut of the published config.
COMMANDS = {
    "realnvp-mnist-baseline": ("mnist", "realnvp", True, {"g_hidden_channels": [4] * 2}),
    "realnvp-mnist": ("mnist", "realnvp", False, {
        "g_hidden_channels": [4] * 2, "st_nets": [2] * 2, "p_nets": [4] * 2, "q_nets": [4] * 2}),
    "glow-cifar10-baseline": ("cifar10", "glow", True, {"num_steps_per_scale": 2, "g_num_hidden_channels": 4}),
    "glow-mnist": ("mnist", "glow", False, {
        "num_steps_per_scale": 2, "g_num_hidden_channels": 4, "st_nets": 2, "p_nets": 4, "q_nets": 4}),
}
CHANNELS = {"mnist": 1, "cifar10": 3}


def command_config(name, **overrides):
    dataset, model, baseline, cut = COMMANDS[name]
    config = expand_grid(get_config(dataset, model, use_baseline=baseline))[0]
    return {**config, "model": model, "dataset": dataset, **cut, **overrides}


def x_shape(name):
    return (CHANNELS[COMMANDS[name][0]], SIZE, SIZE)


def perturbed(variables, seed, scale=0.05):
    """Every parameter moved off its init (GlowCNN's output conv starts at
    zero, which would exercise nothing upstream of it), and every running
    mean and variance moved up off 0 and 1; numpy draws, as numpy leaves."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        x = np.asarray(x)
        if path is not None and getattr(path[-1], "key", None) not in ("mean", "var"):
            return x
        noise = scale * rng.normal(size=x.shape)
        return (x + (noise if path is None else np.abs(noise))).astype(x.dtype)

    return {
        "params": jax.tree.map(lambda x: move(None, x), variables["params"]),
        "state": jax.tree_util.tree_map_with_path(move, variables["state"]),
    }


@functools.lru_cache(maxsize=None)
def _jax_pair(name, seed):
    """The JAX density and its perturbed variables, made once a process:
    an eager JAX init compiles each new shape."""
    schema = get_schema(command_config(name))
    jd = jax_get_density(schema, x_shape=x_shape(name))
    return schema, jd, perturbed(jd.init(jax.random.PRNGKey(seed)), seed)


def build_pair(name, seed=0):
    """(config, jax_density, jax_variables, port_density) with the same
    weights and state; the port's density is built afresh."""
    schema, jd, jv = _jax_pair(name, seed)
    td = get_density(schema, x_shape=x_shape(name), device="cpu")
    variables_from_jax(td, to_numpy(jv))
    return command_config(name), jd, jv, td


def images(n, shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(n, *shape)).astype(np.float32)


class Draws:
    """Standard normal draws, recorded as the JAX package's conditional
    Gaussians and base densities ask for them while a jitted function
    traces (constants of the trace), then replayed into the port's in the
    same order."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.recorded = []

    def _draw(self, shape):
        eps = self.rng.normal(size=shape).astype(np.float32)
        self.recorded.append(eps)
        return jnp.asarray(eps)

    def record_jax(self, monkeypatch):
        monkeypatch.setattr(jax_gaussian, "diagonal_gaussian_sample",
                            lambda rng, means, stddevs: _jax_reparam(self._draw(means.shape), means, stddevs))
        monkeypatch.setattr(jax_gaussian.DiagonalGaussianDensity, "sample",
                            lambda density, v, rng, n: self._draw((n, *density.shape)))

    def replay_port(self, monkeypatch):
        queue = [t(e) for e in self.recorded]
        real = gaussian.diagonal_gaussian_sample

        def sample(means, stddevs, generator=None, noise=None):
            return real(means, stddevs, generator, noise if noise is not None else queue.pop(0))

        monkeypatch.setattr(gaussian, "diagonal_gaussian_sample", sample)
        monkeypatch.setattr(DiagonalGaussianDensity, "_sample", lambda density, n, generator=None: queue.pop(0))
        return queue


def _jax_reparam(eps, means, stddevs):
    """``cmf_tpu``'s reparameterised sample on a given ε (gaussian.py:23-33)."""
    samples = stddevs * eps + means
    flat_eps = eps.reshape(eps.shape[0], -1)
    flat_std = stddevs.reshape(stddevs.shape[0], -1)
    dim = flat_eps.shape[1]
    eps_lp = -0.5 * dim * np.log(2 * np.pi) - 0.5 * jnp.sum(flat_eps**2, axis=1)
    return samples, -jnp.sum(jnp.log(flat_std), axis=1) + eps_lp


def dequantization_noise(key, shape):
    """The JAX ``DequantizationDensity``'s U[0,1) draw under ``key``."""
    rng_deq, _ = jax.random.split(key)
    return np.asarray(jax.random.uniform(rng_deq, shape, dtype=jnp.float32))


def port_train_elbo(td, x, noise):
    """The port's training-mode elbo (batch statistics on), as the
    trainer's step computes it."""
    with batch_statistics(td):
        return td.elbo(t(x), train=True, dequantization_noise=t(noise))["elbo"]


def batch_norm_layers(module):
    return [m for m in module.modules() if isinstance(m, BatchNorm2d)]


def check_train_step(name, monkeypatch, seed=0):
    """The training elbo, every gradient and every state leaf after the
    step (the running statistics moved, p's and q's kept), port against
    cmf_tpu on the same weights and draws."""
    _, jd, jv, td = build_pair(name, seed)
    x = images(BATCH, x_shape(name), seed + 1)
    key = jax.random.PRNGKey(seed + 2)
    draws = Draws(seed + 3)
    draws.record_jax(monkeypatch)

    @jax.jit
    def value_and_grads(params):
        def loss(p):
            info, new_state = jd.elbo({"params": p, "state": jv["state"]}, jnp.asarray(x), rng=key, train=True)
            return -jnp.mean(info["elbo"]), (info["elbo"], new_state)

        return jax.value_and_grad(loss, has_aux=True)(params)

    (_, (elbo_j, state_j)), grads_j = value_and_grads(jv["params"])
    queue = draws.replay_port(monkeypatch)
    elbo_t = port_train_elbo(td, x, dequantization_noise(key, x.shape))
    (-elbo_t.mean()).backward()
    assert not queue
    assert rel_err(elbo_t.detach().numpy(), elbo_j) <= VALUE_TOL

    want = flatten_tree(to_numpy(grads_j))
    # The LU invconv's ``bias`` has no gradient (the forward never adds
    # it); the JAX one is zero.
    got = {jax_path(n): np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
           for n, p in td.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        assert rel_err(got[k], want[k]) <= GRAD_TOL, (k, rel_err(got[k], want[k]))

    before = flatten_tree(to_numpy(jv["state"]))
    after = flatten_tree(to_numpy(state_j))
    port = {jax_path(n): b.numpy() for n, b in td.state_dict().items() if n.endswith((".mean", ".var"))}
    moved = 0
    for k, value in port.items():
        assert rel_err(value, after[k]) <= STATE_TOL, k
        moved += not np.array_equal(after[k], before[k])
        if ".p_u." in f".{k}" or ".q_u." in f".{k}":
            np.testing.assert_array_equal(value, before[k])
    assert moved > 0
    return td


def check_eval_and_samples(name, monkeypatch, seed=0):
    """The eval elbo (running statistics), ``sample`` on the same draws and
    ``fixed_sample`` (the stored base noise; a CIF's u at p's mean)."""
    _, jd, jv, td = build_pair(name, seed)
    x = images(BATCH, x_shape(name), seed + 4)
    key = jax.random.PRNGKey(seed + 5)
    draws = Draws(seed + 6)
    draws.record_jax(monkeypatch)
    elbo_j = jax.jit(lambda v, xx: jd.elbo(v, xx, rng=key, train=False)[0]["elbo"])(jv, jnp.asarray(x))
    samples_j = jax.jit(lambda v: jd.sample(v, key, 5))(jv)
    fixed_j = jax.jit(jd.fixed_sample)(jv)
    queue = draws.replay_port(monkeypatch)
    with torch.no_grad():
        elbo_t = td.elbo(t(x), dequantization_noise=t(dequantization_noise(key, x.shape)))["elbo"]
    samples_t = td.sample(5)
    assert not queue
    assert rel_err(elbo_t.numpy(), elbo_j) <= VALUE_TOL
    assert rel_err(samples_t.numpy(), samples_j) <= VALUE_TOL
    assert rel_err(td.fixed_sample().numpy(), fixed_j) <= VALUE_TOL
    for layer in batch_norm_layers(td):
        assert not layer.batch_stats
