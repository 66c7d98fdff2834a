"""Glow's layers and models in the port against the JAX package:
GlowCNN (with a non-zero output conv, in training and eval mode), both
invertible 1×1 convs (forward, log-jacobian, gradients, inverse and round
trip; the LU one also with u-channels, which no published config reaches),
and glow's two published commands, ``--dataset cifar10 --model glow
--baseline`` and ``--dataset mnist --model glow``, cut to 8×8 images, 2
steps a scale and widths of 2-4: the training elbo, every gradient and the
state after the step, the eval elbo and samples on the same draws. Last,
every leaf of the four image commands' state comes across."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.bijections.linear import BruteForceInvertible1x1ConvBijection as JaxBruteForce
from cmf_tpu.bijections.linear import LUInvertible1x1ConvBijection as JaxLU
from cmf_tpu.nets.core import GlowCNN as JaxGlowCNN
from cmf_tpu_torch.bijections import BruteForceInvertible1x1ConvBijection, LUInvertible1x1ConvBijection
from cmf_tpu_torch.interop import flatten_tree, jax_path, variables_from_jax
from cmf_tpu_torch.nets import GlowCNN

from _torch_image_square import (
    COMMANDS,
    build_pair,
    check_eval_and_samples,
    check_train_step,
    perturbed,
)
from _torch_parity import to_numpy
from _torch_tabular import INV_TOL, check_bijection, t
from test_torch_image_square import _net_grads, _normal, assert_net_matches


@pytest.mark.parametrize("train", [True, False])
def test_glow_cnn_matches_cmf_tpu(train):
    """conv3x3 → BN → relu → conv1x1 → BN → relu → conv3x3: output,
    gradients and state, its output conv moved off the zeros it starts at;
    at init both of that conv's tensors are zero, as in the JAX package."""
    jax_net = JaxGlowCNN(3, 4, 6)
    init = jax_net.init(jax.random.PRNGKey(0))
    port = GlowCNN(3, 4, 6)
    assert not port.conv3.w.any() and not port.conv3.b.any()
    assert port.conv1.b is None and port.conv2.b is None
    variables = perturbed(init, 1, scale=0.2)
    assert np.abs(variables["params"]["conv3"]["w"]).min() > 0
    variables_from_jax(port, to_numpy(variables))
    x = _normal((4, 3, 6, 6), 2)
    assert_net_matches(port, *_net_grads(jax_net, port, variables, x, train, 3))


class _JaxIndexed:
    """A JAX conditional bijection with its index fixed."""

    def __init__(self, bij, u):
        self.bij, self.u = bij, u

    def init(self, key):
        return self.bij.init(key)

    def forward(self, variables, x):
        return self.bij.forward(variables, x, u=self.u)

    def inverse(self, variables, z):
        return self.bij.inverse(variables, z, u=self.u)


class _Indexed(LUInvertible1x1ConvBijection):
    def __init__(self, x_shape, u):
        super().__init__(x_shape, num_u_channels=u.shape[1])
        self.u = u

    def forward(self, x):
        return super().forward(x, self.u)

    def inverse(self, z):
        return super().inverse(z, self.u)


@pytest.mark.parametrize("kind", ["lu", "brute-force", "lu-u-channels"])
def test_invconv_matches_cmf_tpu(kind):
    """W·x across the channels of an image (and, with u-channels, W·x + V·u
    over flat inputs): forward, log-jacobian (log|det W| times H·W),
    gradients, the inverse through inv(W) and the round trip. The LU
    layer's ``bias`` is a parameter the forward never adds: zero
    gradient on both sides."""
    if kind == "lu-u-channels":
        u = _normal((16, 2), 4)
        jax_bij = _JaxIndexed(JaxLU((5,), num_u_channels=2), jnp.asarray(u))
        port = _Indexed((5,), t(u))
        x = _normal((16, 5), 5)
    else:
        shape = (4, 3, 3)
        jax_cls, port_cls = (JaxLU, LUInvertible1x1ConvBijection) if kind == "lu" else (
            JaxBruteForce, BruteForceInvertible1x1ConvBijection)
        jax_bij, port = jax_cls(shape), port_cls(shape)
        x = _normal((6, *shape), 6)
    # Gradients accumulate into zeros, so the unused ``bias`` has one too,
    # as jax.grad gives it.
    for p in port.parameters():
        p.grad = torch.zeros_like(p)
    check_bijection(jax_bij, port, x, seed=7, inverse_tol=INV_TOL, round_trip_tol=1e-4)
    if kind != "brute-force":
        assert {n for n, _ in port.named_buffers()} == {"P", "sign_s", "l_mask"}
        z, _ = port(t(x).requires_grad_(True))
        z.sum().backward()
        assert not port.bias.grad.any()


GLOW = ["glow-cifar10-baseline", "glow-mnist"]


@pytest.mark.parametrize("name", GLOW)
def test_glow_train_step_matches_cmf_tpu(name, monkeypatch):
    check_train_step(name, monkeypatch)


@pytest.mark.parametrize("name", GLOW)
def test_glow_eval_elbo_and_samples_match_cmf_tpu(name, monkeypatch):
    check_eval_and_samples(name, monkeypatch)


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_image_square_state_comes_across_whole(name):
    """Every parameter and buffer of the port holds the JAX leaf at its
    path: the batch-norm scales, biases and running statistics, the LU
    factors and their fixed P, sign and mask, the fixed samples."""
    _, _, jv, td = build_pair(name, seed=1)
    leaves = {**flatten_tree(to_numpy(jv["params"])), **flatten_tree(to_numpy(jv["state"]))}
    port = td.state_dict()
    assert len(port) == len(leaves)
    for n, value in port.items():
        np.testing.assert_array_equal(value.numpy(), leaves[jax_path(n)])
