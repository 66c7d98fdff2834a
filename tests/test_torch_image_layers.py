"""The image layers of the port against the JAX package, each built by both
factories from one schema layer with the JAX weights carried across by
``interop``: the checkerboard and split-channel couplings with ResNet
couplers, the squeeze, the logit and scalar preprocessing (forward, inverse
and log-jacobian); the split density; dequantization with the same noise;
and the synthetic image data, byte for byte."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.data.image import _synthetic_raw as jax_synthetic_raw
from cmf_tpu.data.image import get_image_datasets as jax_get_image_datasets
from cmf_tpu.data.loaders import get_loaders as jax_get_loaders
from cmf_tpu.models import get_density as jax_get_density
from cmf_tpu_torch.data import get_image_datasets, get_loaders
from cmf_tpu_torch.data.image import _synthetic_raw
from cmf_tpu_torch.interop import variables_from_jax
from cmf_tpu_torch.models import get_density

from _torch_parity import t, to_numpy

# fp32 both sides; the couplings run a 5-conv ResNet in another sum order.
TOL = 2e-5


def _acl(mask_type, reverse_mask):
    return {
        "type": "acl", "mask_type": mask_type, "reverse_mask": reverse_mask, "num_u_channels": 0,
        "coupler": {"independent_nets": False, "shift_log_scale_net": {
            "type": "resnet", "hidden_channels": [8, 8], "batchnorm": False,
            "ignore_batch_effects": False}},
    }


LAYERS = {
    "checkerboard": (_acl("checkerboard", False), (1, 8, 8)),
    "checkerboard-reverse": (_acl("checkerboard", True), (2, 6, 6)),
    "split-channel": (_acl("split-channel", False), (4, 6, 6)),
    "split-channel-reverse-odd": (_acl("split-channel", True), (3, 6, 6)),
    "squeeze": ({"type": "squeeze", "factor": 2}, (2, 8, 8)),
    "logit": ({"type": "logit"}, (1, 4, 4)),
    "scalar-mult": ({"type": "scalar-mult", "value": (1 - 2e-6) / 256}, (1, 4, 4)),
    "scalar-add": ({"type": "scalar-add", "value": 1e-6}, (1, 4, 4)),
}


def _pair(schema, x_shape, seed=0):
    jd = jax_get_density(schema, x_shape=x_shape)
    jv = to_numpy(jd.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb_head(path, leaf):
        """Move the ResNet heads off their ones / zeros so they are exercised."""
        if getattr(path[-1], "key", None) in ("head_w", "head_b"):
            return (0.3 * rng.normal(size=leaf.shape)).astype(np.float32)
        return leaf

    jv["params"] = jax.tree_util.tree_map_with_path(perturb_head, jv["params"])
    td = get_density(schema, x_shape=x_shape, device="cpu")
    variables_from_jax(td, jv)
    return jd, jv, td


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_forward_inverse_and_log_jacobian(name):
    layer, x_shape = LAYERS[name]
    jd, jv, td = _pair([layer], x_shape, seed=len(name))
    jbij = jd.bijection
    jbv = {"params": jv["params"]["bijection"], "state": jv["state"]["bijection"]}
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, *x_shape)).astype(np.float32)
    if name == "logit":
        x = rng.uniform(0.01, 0.99, size=(3, *x_shape)).astype(np.float32)

    z_j, lj_j, _ = jbij.forward(jbv, jnp.asarray(x))
    z_t, lj_t = td.bijection(t(x))
    _close(z_t, z_j)
    _close(lj_t, lj_j)

    x_j, ilj_j = jbij.inverse(jbv, z_j)
    x_t, ilj_t = td.bijection.inverse(t(np.asarray(z_j)))
    _close(x_t, x_j)
    _close(ilj_t, ilj_j)
    np.testing.assert_allclose(x_t.detach().numpy(), x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("non_square", [False, True], ids=["square", "non-square"])
def test_split_density(non_square):
    schema = [{"type": "split", "non_square": non_square}]
    jd, jv, td = _pair(schema, (2, 4, 4), seed=3)
    x = np.random.default_rng(3).normal(size=(5, 2, 4, 4)).astype(np.float32)
    info, _ = jd.elbo(jv, jnp.asarray(x))
    _close(td.elbo(t(x))["elbo"], info["elbo"])
    noise = np.random.default_rng(4).normal(size=(5, 1, 4, 4)).astype(np.float32)
    if non_square:
        # The non-square split zero-pads the half it drops.
        want = jd.fixed_sample(jv, noise=jnp.asarray(noise))
        _close(td.fixed_sample(t(noise)), want)
        np.testing.assert_array_equal(td.fixed_sample(t(noise))[:, 1:].numpy(), 0.0)
    _close(td.fixed_sample(), jd.fixed_sample(jv))
    assert tuple(td.sample(7, torch.Generator().manual_seed(0)).shape) == (7, 2, 4, 4)


def test_dequantization_with_the_same_noise():
    schema = [{"type": "dequantization"}, {"type": "scalar-mult", "value": 1 / 256}]
    jd, jv, td = _pair(schema, (1, 4, 4), seed=5)
    x = np.random.default_rng(5).integers(0, 256, size=(6, 1, 4, 4)).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    info, _ = jd.elbo(jv, jnp.asarray(x), rng=rng)
    noise = np.asarray(jax.random.uniform(jax.random.split(rng)[0], x.shape, dtype=jnp.float32))
    _close(td.elbo(t(x), dequantization_noise=t(noise))["elbo"], info["elbo"])
    # Drawn from the generator instead.
    drawn = td.elbo(t(x), generator=torch.Generator().manual_seed(0))["elbo"]
    assert torch.isfinite(drawn).all()


def test_synthetic_mnist_is_byte_equal():
    ours = get_image_datasets("mnist", synthetic=True, seed=3)
    theirs = jax_get_image_datasets("mnist", synthetic=True, seed=3)
    for (ox, oy), (wx, wy) in zip(ours, theirs):
        assert ox.dtype == wx.dtype == np.uint8
        np.testing.assert_array_equal(ox, wx)
        np.testing.assert_array_equal(oy, wy)
    assert ours[0][0].shape == (9000, 1, 28, 28)


@pytest.mark.parametrize("name", ["fashion-mnist", "cifar10"])
def test_synthetic_stand_ins_of_other_datasets_are_byte_equal(name):
    for train in (True, False):
        ox, oy = _synthetic_raw(name, train, seed=1, max_n=40)
        wx, wy = jax_synthetic_raw(name, train, seed=1, max_n=40)
        np.testing.assert_array_equal(ox, wx)
        np.testing.assert_array_equal(oy, wy)


def test_get_loaders_image_branch_matches(tmp_path):
    config = {"train_batch_size": 50, "valid_batch_size": 50, "test_batch_size": 50,
              "max_dataset_size": 500}
    ours = get_loaders("mnist", config, "cpu", seed=2, synthetic=True)
    theirs = jax_get_loaders("mnist", config, seed=2, synthetic=True)
    for o, w in zip(ours, theirs):
        assert o.x.dtype == np.float32
        np.testing.assert_array_equal(o.x, w.x)
        assert len(o) == len(w)
    assert len(ours[0]) == 10 and tuple(ours[0].x_shape) == (1, 28, 28)
    # Off disk, where the files are absent: cmf_tpu's error (the readers
    # themselves: tests/test_torch_image_data.py).
    with pytest.raises(FileNotFoundError, match="Local copy of `mnist' not found"):
        get_image_datasets("mnist", data_root=str(tmp_path), synthetic=False)


def test_resnet_coupler_with_batchnorm_waits_for_a_later_slice():
    """The coupling with a batch-norm ResNet coupler, which once waited for
    a later slice, now builds and matches the JAX layer: by the running
    statistics outside a training step (forward, inverse, log-jacobian),
    by the batch's inside one (forward, log-jacobian and the moved running
    statistics)."""
    from cmf_tpu_torch.nets import batch_statistics

    layer = _acl("checkerboard", False)
    layer["coupler"]["shift_log_scale_net"]["batchnorm"] = True
    jd, jv, td = _pair([layer], (1, 8, 8), seed=5)
    jbij = jd.bijection
    jbv = {"params": jv["params"]["bijection"], "state": jv["state"]["bijection"]}
    x = np.random.default_rng(2).normal(size=(3, 1, 8, 8)).astype(np.float32)
    z_j, lj_j, _ = jbij.forward(jbv, jnp.asarray(x))
    z_t, lj_t = td.bijection(t(x))
    _close(z_t, z_j)
    _close(lj_t, lj_j)
    x_j, _ = jbij.inverse(jbv, z_j)
    _close(td.bijection.inverse(t(np.asarray(z_j)))[0], x_j)

    z_j, lj_j, state_j = jbij.forward(jbv, jnp.asarray(x), train=True)
    with batch_statistics(td):
        z_t, lj_t = td.bijection(t(x))
    _close(z_t, z_j)
    _close(lj_t, lj_j)
    bn = td.bijection.coupler.net.blocks[0].bn1
    _close(bn.var, state_j["coupler"]["blocks"][0]["bn1"]["var"])
