"""The ``sigmoid`` layer and affine couplings with u-channels (an ``acl``
layer in a CIF) in the port against the JAX package, built by both
factories from one schema with the JAX weights carried across by
``interop``.

``sigmoid`` (the logit's inverse, no parameters) in a chain on a flat and an
image shape. ``acl`` with u-channels for each mask (checkerboard and
split-channel on (2, 4, 4) with a one-block ResNet, alternating-channel on
(6,) with an MLP): the bijection's forward, inverse and log-det with u given;
the CIF's elbo and its gradients on the JAX package's draws of u; the fixed
sample (u at p's mean) and the latent (u at q's mean), whose ResNets take
the coupler kernel's route under inference mode, here its plain version,
with the passthrough and u channels as its input. In a non-square model the
layer works in the low-dimensional prior in both packages, and in the
decoded x-space stack both raise the same error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.bijections import CompositeBijection as JaxComposite
from cmf_tpu.models import get_bijection as jax_get_bijection
from cmf_tpu.models import get_density as jax_get_density
from cmf_tpu_torch.bijections import CompositeBijection
from cmf_tpu_torch.interop import variables_from_jax
from cmf_tpu_torch.models import get_density
from cmf_tpu_torch.models.factory import get_bijection
from cmf_tpu_torch.ops import coupler_stack

from _torch_image_square import Draws
from _torch_parity import DIM, small_schema, to_numpy
from _torch_tabular import assert_grads_close, rel_err, t

VALUE_TOL = 1e-5  # values and log-jacobians, relative to max |ref|
GRAD_TOL = 1e-4  # per tensor, relative to max |grad|
ELBO_TOL = 1e-4  # a non-square head's elbo, through the Gram and its log-det
NUM_U = 2

SIGMOID_CHAIN = [{"type": "sigmoid"}, {"type": "scalar-mult", "value": 3.0}, {"type": "sigmoid"}]


def _inputs(shape, n, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=(n, *shape))).astype(np.float32)


@pytest.mark.parametrize("shape", [(5,), (2, 4, 4)], ids=["flat", "image"])
def test_sigmoid_chain_matches_cmf_tpu(shape):
    """Forward, inverse and log-det of the chain, and the density's elbo
    over it (``interop`` takes the empty trees under each
    ``InverseBijection``'s ``.bijection``)."""
    jax_chain = JaxComposite([jax_get_bijection(layer, shape) for layer in SIGMOID_CHAIN])
    chain = CompositeBijection([get_bijection(layer, shape, None) for layer in SIGMOID_CHAIN])
    x = _inputs(shape, 6, seed=1, scale=2.0)
    z_j, lj_j, _ = jax.jit(lambda xx: jax_chain.forward(jax_chain.init(jax.random.PRNGKey(0)), xx))(jnp.asarray(x))
    x_j, lji_j = jax.jit(lambda zz: jax_chain.inverse(jax_chain.init(jax.random.PRNGKey(0)), zz))(z_j)
    with torch.no_grad():
        z_t, lj_t = chain(t(x))
        x_t, lji_t = chain.inverse(t(z_j))
    assert np.all((np.asarray(z_j) > 0) & (np.asarray(z_j) < 1))
    for got, want in ((z_t, z_j), (lj_t, lj_j), (x_t, x_j), (lji_t, lji_j)):
        assert rel_err(got.numpy(), want) <= VALUE_TOL

    jd = jax_get_density(SIGMOID_CHAIN, x_shape=shape)
    jv = jd.init(jax.random.PRNGKey(2))
    td = get_density(SIGMOID_CHAIN, x_shape=shape, device="cpu")
    variables_from_jax(td, to_numpy(jv))
    info, _ = jax.jit(lambda v, xx: jd.elbo(v, xx))(jv, jnp.asarray(x))
    with torch.no_grad():
        elbo = td.elbo(t(x))["elbo"]
    assert rel_err(elbo.numpy(), info["elbo"]) <= VALUE_TOL


def _coupler(net):
    return {"independent_nets": False, "shift_log_scale_net": net}


RESNET = {"type": "resnet", "hidden_channels": [4], "batchnorm": False}
MLP = {"type": "mlp", "hidden_channels": [8], "activation": "tanh"}
ACL_U = {
    "checkerboard": ((2, 4, 4), {"mask_type": "checkerboard", "reverse_mask": False}, RESNET),
    "split-channel": ((2, 4, 4), {"mask_type": "split-channel", "reverse_mask": True}, RESNET),
    "alternating-channel": ((6,), {"mask_type": "alternating-channel", "reverse_mask": False}, MLP),
}


def _acl_u_layer(mask, net):
    return {"type": "acl", **mask, "num_u_channels": NUM_U, "coupler": _coupler(net),
            "p_coupler": _coupler(net), "q_coupler": _coupler(net)}


def _random_variables(density, seed):
    """A variables tree of the JAX density's structure with every leaf drawn
    from numpy (the JAX init compiles for seconds; this layer's state is
    only the prior's fixed samples)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(density.init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: 0.3 * rng.normal(size=s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("name", sorted(ACL_U))
def test_acl_with_u_channels_matches_cmf_tpu(name):
    shape, mask, net = ACL_U[name]
    schema = [_acl_u_layer(mask, net)]
    jd = jax_get_density(schema, x_shape=shape)
    jv = _random_variables(jd, seed=3)
    td = get_density(schema, x_shape=shape, device="cpu")
    variables_from_jax(td, jv)
    u_shape = (NUM_U, *shape[1:])
    x, u, noise = _inputs(shape, 8, seed=4), _inputs(u_shape, 8, seed=5), _inputs(shape, 8, seed=7)
    key = jax.random.PRNGKey(6)

    @jax.jit
    def jax_side(v, xx, uu, nn):
        bv = {"params": v["params"]["bijection"], "state": v["state"]["bijection"]}
        z, lj, _ = jd.bijection.forward(bv, xx, u=uu)
        x_back, lji = jd.bijection.inverse(bv, z, u=uu)

        def loss(p):
            info, _ = jd.elbo({"params": p, "state": v["state"]}, xx, rng=key, train=True)
            return -jnp.mean(info["elbo"]), info["elbo"]

        (_, elbo), grads = jax.value_and_grad(loss, has_aux=True)(v["params"])
        return (z, lj, x_back, lji), (elbo, grads), (jd.fixed_sample(v, noise=nn), jd.extract_latent(v, xx))

    (z_j, lj_j, x_j, lji_j), (elbo_j, grads_j), (fixed_j, latent_j) = jax_side(
        jv, jnp.asarray(x), jnp.asarray(u), jnp.asarray(noise))

    # The bijection with u given.
    with torch.no_grad():
        z_t, lj_t = td.bijection(t(x), t(u))
        x_t, lji_t = td.bijection.inverse(t(z_j), t(u))
        point = td.bijection.inverse_point(t(z_j), t(u))
    for got, want in ((z_t, z_j), (lj_t, lj_j), (x_t, x_j), (lji_t, lji_j), (point, x_j)):
        assert rel_err(got.numpy(), want) <= VALUE_TOL
    assert rel_err(x_t.numpy(), x) <= VALUE_TOL

    # The CIF's elbo and its gradients on the JAX package's draw of u.
    eps = jax.random.normal(jax.random.split(key)[0], (8, *u_shape))
    elbo_t = td.elbo(t(x), train=True, u_noise=[t(eps)])["elbo"]
    (-elbo_t.mean()).backward()
    assert rel_err(elbo_t.detach().numpy(), elbo_j) <= VALUE_TOL
    assert_grads_close(td, grads_j, GRAD_TOL)

    # u at p's mean (the fixed sample) and at q's mean (the latent); the
    # image ResNets through the coupler kernel's route.
    coupler_stack.reset_launch_counts()
    fixed_t = td.fixed_sample(t(noise))
    with torch.inference_mode():
        latent_t = td.extract_latent(t(x))
    assert coupler_stack.CALLS == (4 if len(shape) == 3 else 0)  # p's and the coupling's; q's and the coupling's
    assert rel_err(fixed_t.numpy(), fixed_j) <= VALUE_TOL
    assert rel_err(latent_t.numpy(), latent_j) <= VALUE_TOL


def _nonsquare_with_cif(index):
    """The small non-square schema with its ``acl`` layer at ``index`` given
    u-channels and flat MLP p and q couplers."""
    schema = small_schema()
    assert schema[index]["type"] == "acl"
    schema[index] = {**schema[index], "num_u_channels": NUM_U, "p_coupler": _coupler(MLP),
                     "q_coupler": _coupler(MLP)}
    return schema


def test_acl_with_u_channels_in_a_nonsquare_model(monkeypatch):
    """In the low-dimensional prior (after ``non-square-base``) the CIF
    works in both packages: the head's training elbo on the JAX package's
    draw of u. In the decoded x-space stack both raise the same
    ``KeyError``: a CIF node hands up no ``low_dim_x``, the latent the head
    decodes."""
    x = _inputs((DIM,), 8, seed=9)
    schema = _nonsquare_with_cif(7)
    jd = jax_get_density(schema, x_shape=(DIM,))
    jv = to_numpy(jax.jit(jd.init)(jax.random.PRNGKey(8)))
    td = get_density(schema, x_shape=(DIM,), device="cpu")
    variables_from_jax(td, jv)
    draws = Draws(seed=10)
    draws.record_jax(monkeypatch)
    info, _ = jax.jit(lambda v, xx: jd.elbo(v, xx, rng=jax.random.PRNGKey(0), train=True))(jv, jnp.asarray(x))
    assert [e.shape for e in draws.recorded] == [(8, NUM_U)]
    with torch.no_grad():
        elbo = td.elbo(t(x), train=True, u_noise=[t(draws.recorded[0])])["elbo"]
    want = np.asarray(info["elbo"])
    np.testing.assert_allclose(elbo.numpy(), want, rtol=ELBO_TOL, atol=ELBO_TOL * np.abs(want).max())

    schema = _nonsquare_with_cif(2)
    jd = jax_get_density(schema, x_shape=(DIM,))
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(8))
    with pytest.raises(KeyError) as want:
        jax.eval_shape(lambda v: jd.elbo(v, jnp.asarray(x), rng=jax.random.PRNGKey(0)), shapes)
    with pytest.raises(KeyError) as got:
        get_density(schema, x_shape=(DIM,), device="cpu").elbo(t(x))
    assert got.value.args == want.value.args == ("low_dim_x",)
