"""The mnist slice as a whole: the mnist non-square schema (every layer of
``get_schema`` kept: dequantization, scalar and logit preprocessing, three
checkerboard couplings, the squeeze, three split-channel couplings, the
non-square split, four checkerboard couplings, the tail and the flat latent
flow) built by both factories at x_shape (1, 8, 8) with ResNet couplers of
width 8, the JAX weights and state carried across by ``interop``. After the
squeeze and the split the tail has 32 dimensions, which still hold d = 20.

Against the JAX package, with the same dequantization noise and Hutchinson
probes: the Hutchinson + CG train elbo and every parameter gradient, the
exact eval elbo through the generic (vmap of JVPs) Jacobian, and
``fixed_sample``. The JAX side is computed once per module: its eager
``value_and_grad`` of this model takes tens of seconds on a CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.config import expand_grid, get_config, get_schema
from cmf_tpu.models import get_density as jax_get_density
from cmf_tpu_torch.densities import NonSquareHeadDensity
from cmf_tpu_torch.interop import flatten_tree, variables_from_jax
from cmf_tpu_torch.main import main
from cmf_tpu_torch.models import get_density
from cmf_tpu_torch.ops import coupler_stack as cs

from _torch_parity import assert_trees_close, t, to_numpy, torch_grads

X_SHAPE = (1, 8, 8)
N = 4
LATENT = 20
ELBO_TOL = 1e-4
# Second-order terms through ten ResNet couplers, fp32 both sides.
GRAD_TOL = 1e-3
# Samples in data space [0, 256): the decode ends in a sigmoid and a scale.
SAMPLE_TOL = 1e-5


def mnist_config(**overrides):
    config = expand_grid(get_config("mnist", "non-square", use_baseline=False))[0]
    config.update(overrides)
    return config


def _head(density):
    return next(m for m in density.modules() if isinstance(m, NonSquareHeadDensity))


@pytest.fixture(scope="module")
def case():
    schema = get_schema(mnist_config(g_hidden_channels=[8], prior_hidden_channels=[8]))
    jd = jax_get_density(schema, x_shape=X_SHAPE)
    jv = jd.init(jax.random.PRNGKey(0))
    td = get_density(schema, x_shape=X_SHAPE, device="cpu")
    variables_from_jax(td, to_numpy(jv))

    x = np.random.default_rng(0).integers(0, 256, size=(N, *X_SHAPE)).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    # The JAX draws, as DequantizationDensity and the head make them: the
    # wrapper splits the key, the head draws ε from the second half.
    rng_deq, rng_rest = jax.random.split(rng)
    noise = np.asarray(jax.random.uniform(rng_deq, x.shape, dtype=jnp.float32))
    eps = np.asarray(jax.random.normal(rng_rest, (N, LATENT, 1), dtype=jnp.float32))

    def loss(params):
        info, _ = jd.elbo({"params": params, "state": jv["state"]}, jnp.asarray(x), rng=rng, train=True)
        return -jnp.mean(info["elbo"]), info["elbo"]

    (_, train_elbo), grads = jax.value_and_grad(loss, has_aux=True)(jv["params"])
    eval_info, _ = jd.elbo(jv, jnp.asarray(x), rng=rng, train=False)
    sample_noise = np.random.default_rng(1).normal(size=(3, LATENT)).astype(np.float32)
    return {
        "td": td, "x": x, "noise": noise, "eps": eps,
        "train_elbo": np.asarray(train_elbo), "grads": grads,
        "eval_elbo": np.asarray(eval_info["elbo"]),
        "sample_noise": sample_noise,
        "fixed_sample_noise": np.asarray(jd.fixed_sample(jv, noise=jnp.asarray(sample_noise))),
        "fixed_sample": np.asarray(jd.fixed_sample(jv)),
    }


def _train_elbo(case):
    td = case["td"]
    td.zero_grad(set_to_none=True)
    return td.elbo(t(case["x"]), train=True, dequantization_noise=t(case["noise"]),
                   hutchinson_eps=t(case["eps"]))["elbo"]


def test_train_elbo_matches_jax(case):
    got = _train_elbo(case).detach().numpy()
    want = case["train_elbo"]
    np.testing.assert_allclose(got, want, rtol=ELBO_TOL, atol=ELBO_TOL * np.abs(want).max())


def test_train_gradients_match_jax(case):
    (-_train_elbo(case).mean()).backward()
    grads = torch_grads(case["td"])
    assert len(grads) == 130
    scale = max(np.abs(g).max() for g in grads.values())
    assert_trees_close(grads, case["grads"], rtol=GRAD_TOL, atol=GRAD_TOL * scale)


def test_eval_elbo_through_the_generic_jacobian_matches_jax(case):
    td = case["td"]
    with torch.no_grad():
        got = td.elbo(t(case["x"]), dequantization_noise=t(case["noise"]))["elbo"].numpy()
    # Conv couplings: the dense decode program has conv stages, so the
    # exact path takes the vmap-of-JVPs Jacobian (nonsquare.py:220).
    assert _head(td)._dense_decode_program().has_conv
    want = case["eval_elbo"]
    np.testing.assert_allclose(got, want, rtol=ELBO_TOL, atol=ELBO_TOL * np.abs(want).max())


def test_fixed_sample_matches_jax(case):
    td = case["td"]
    for got, want in ((td.fixed_sample(t(case["sample_noise"])), case["fixed_sample_noise"]),
                      (td.fixed_sample(), case["fixed_sample"])):
        np.testing.assert_allclose(got.numpy(), want, rtol=SAMPLE_TOL, atol=SAMPLE_TOL * 256)


def test_sampling_routes_every_coupling_through_the_fused_coupler(case):
    td = case["td"]
    cs.reset_launch_counts()
    samples = td.sample(3, generator=torch.Generator().manual_seed(0))
    assert cs.CALLS == 10  # one per coupling inverse; no kernel launch on the CPU
    assert cs.LAUNCHES == 0
    assert tuple(samples.shape) == (3, *X_SHAPE) and torch.isfinite(samples).all()
    with torch.no_grad():
        conv = td._sample(3, generator=torch.Generator().manual_seed(0))
    assert cs.CALLS == 10
    np.testing.assert_allclose(samples.numpy(), conv.numpy(), rtol=SAMPLE_TOL, atol=SAMPLE_TOL * 256)


def test_full_width_mnist_tree_loads_through_interop():
    """Every leaf of the full-width mnist tree (28×28, ResNet [64]×8
    couplers, prior [32]×4) matches a port tensor in name and shape. The JAX
    tree's shapes come from ``eval_shape`` of its init; the values from a
    numpy seed."""
    schema = get_schema(mnist_config())
    shapes = jax.eval_shape(jax_get_density(schema, x_shape=(1, 28, 28)).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def fill(leaf):
        if jnp.issubdtype(leaf.dtype, jnp.integer):
            return rng.permutation(leaf.shape[0]).astype(leaf.dtype)
        return rng.normal(size=leaf.shape).astype(np.float32)

    tree = jax.tree.map(fill, shapes)
    td = get_density(schema, x_shape=(1, 28, 28), device="cpu")
    variables_from_jax(td, tree)
    params = flatten_tree(tree["params"])
    assert len(params) == len(list(td.parameters())) == 470
    assert sum(v.size for v in params.values()) == sum(p.numel() for p in td.parameters())
    w = params["density.prior.prior.prior.prior.bijection.coupler.blocks.7.conv2.w"]
    assert w.shape == (64, 64, 3, 3)
    got = td.density.prior.prior.prior.prior.bijection.coupler.net.blocks[7].conv2.w
    np.testing.assert_array_equal(got.detach().numpy(), w)


def test_cli_two_steps_on_cpu():
    cs.reset_launch_counts()
    (setup,) = main([
        "--model", "non-square", "--dataset", "mnist", "--synthetic-data", "--nosave",
        "--config", "likelihood_warmup=False", "--config", "early_stopping=False",
        "--config", "use_fid=False", "--config", "max_epochs=1", "--config", "max_dataset_size=8",
        "--config", "train_batch_size=4", "--config", "g_hidden_channels=[8]",
        "--config", "prior_hidden_channels=[8]", "--config", "seed=0", "--device", "cpu",
    ])
    history = setup["trainer"].history
    assert len(history) == 2 and all(np.isfinite(h[1]) and not h[3] for h in history)
    # Training takes the conv modules: the forward-only coupler is for sampling.
    assert cs.CALLS == 0
    assert _head(setup["density"]).log_jacobian_method == "hutch_with_cg"
