"""The coupler-stack kernel's plain version (``cmf_tpu_torch/ops/
coupler_stack.py``) against the JAX package's ``fused_resnet_coupler`` in
interpret mode and against JAX ``ResNet.apply``; the port's ``ResNet`` module
against JAX; and the route ``ResNet.forward`` takes: the fused coupler under
``torch.inference_mode()`` (the sampling path), the conv modules elsewhere,
inside ``torch.func.jvp`` above all. The CUDA kernel itself runs only on the
card: ``chip_smoke.py`` holds it against this plain version there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.nets import ResNet as JaxResNet
from cmf_tpu.ops.pallas.coupler_stack import fused_resnet_coupler as jax_fused_resnet_coupler
from cmf_tpu_torch.interop import variables_from_jax
from cmf_tpu_torch.nets import ResNet
from cmf_tpu_torch.ops import coupler_stack as cs

from _torch_parity import t, to_numpy

# The JAX package's own tolerance for its kernel against ResNet.apply
# (tests/test_ops.py:312-335): fp32, sums in another order.
TOL = 2e-5

# (C_in, C_out, H=W, blocks, batch) of tests/test_ops.py:324, hidden 16: the
# 28×28 checkerboard and the 14×14 post-squeeze geometries.
GEOMETRIES = [(1, 2, 28, 2, 6), (4, 8, 14, 3, 5)]
IDS = ["28x28", "14x14"]


def _pair(c_in, c_out, hw, blocks, batch, seed=0):
    """JAX ResNet variables (head perturbed off its ones / zeros), the port's
    ResNet with the same weights, and an input."""
    net = JaxResNet(c_in, [16] * blocks, c_out, use_batchnorm=False)
    variables = to_numpy(net.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    variables["params"]["head_w"] = rng.normal(size=(c_out, 1, 1)).astype(np.float32)
    variables["params"]["head_b"] = rng.normal(size=(c_out, 1, 1)).astype(np.float32)
    port = ResNet(c_in, [16] * blocks, c_out)
    variables_from_jax(port, variables)
    x = rng.normal(size=(batch, c_in, hw, hw)).astype(np.float32)
    return net, variables, port, x


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=IDS)
def test_plain_matches_jax_kernel_in_interpret_mode(geometry):
    _, variables, port, x = _pair(*geometry)
    want = jax_fused_resnet_coupler(jnp.asarray(x), variables["params"], num_blocks=geometry[3],
                                    interpret=True)
    with torch.no_grad():
        got = cs.coupler_stack_plain(t(x), port.kernel_params())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=IDS)
def test_plain_and_module_match_jax_resnet_apply(geometry):
    net, variables, port, x = _pair(*geometry, seed=1)
    want, _ = net.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        plain = cs.coupler_stack_plain(t(x), port.kernel_params())
        module = port(t(x))
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(module.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_inference_mode_routes_through_the_fused_coupler():
    _, _, port, x = _pair(*GEOMETRIES[1], seed=2)
    x = t(x)
    cs.reset_launch_counts()
    with torch.no_grad():
        conv = port(x)
    assert cs.CALLS == 0
    with torch.inference_mode():
        fused = port(x)
    # On a CPU tensor the wrapper takes the plain version: routed, not launched.
    assert (cs.CALLS, cs.LAUNCHES) == (1, 0)
    np.testing.assert_allclose(fused.numpy(), conv.numpy(), rtol=TOL, atol=TOL)


def test_func_jvp_never_reaches_the_forward_only_kernel():
    """The Hutchinson solve's matvecs run without a graph but inside
    torch.func transforms, which turn inference mode off: even called under
    torch.inference_mode() the JVP takes the conv modules."""
    _, _, port, x = _pair(*GEOMETRIES[1], seed=3)
    x, v = t(x), torch.ones(x.shape)
    cs.reset_launch_counts()
    with torch.inference_mode():
        _, tangent = torch.func.jvp(port, (x,), (v,))
    assert cs.CALLS == 0
    with torch.no_grad():
        _, want = torch.func.jvp(port, (x,), (v,))
    np.testing.assert_array_equal(tangent.numpy(), want.numpy())


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    _, _, port, x = _pair(*GEOMETRIES[1], seed=4)
    with torch.no_grad():
        params = port.kernel_params()
        with pytest.raises(ValueError, match="CUDA tensor"):
            cs.coupler_stack_cuda(t(x), params)
        with pytest.raises(ValueError, match="shape"):
            cs.pack_weights(params, c_in=3, hidden=16, c_out=8, device=torch.device("cpu"))
    assert cs.LAUNCHES == 0


def test_pack_weights_layout():
    """The kernel reads each 3×3 conv as [input][tap][output] and the 1×1
    conv as [input][output], in the order of the ResNet's layers."""
    _, _, port, _ = _pair(*GEOMETRIES[1], seed=5)
    with torch.no_grad():
        params = port.kernel_params()
        packed = cs.pack_weights(params, c_in=4, hidden=16, c_out=8, device=torch.device("cpu"))
        w_in = params["conv_in"]["w"]  # (16, 4, 3, 3)
        assert packed.numel() == sum(p.numel() for p in port.parameters())
        # w_in[o=5, i=2, ky=1, kx=0] sits at [i=2][tap=3][o=5].
        assert packed[(2 * 9 + 3) * 16 + 5] == w_in[5, 2, 1, 0]
        w_out = params["conv_out"]["w"]  # (8, 16, 1, 1)
        start = packed.numel() - 3 * 8 - 16 * 8
        assert packed[start + 7 * 8 + 3] == w_out[3, 7, 0, 0]


def test_flops_of_the_mnist_couplers():
    """The operation counts that set the kernel's bound: about 926 MFLOP an
    image at 28×28 (1→2 channels) and 232 MFLOP at 14×14 (2→4), hidden 64,
    8 blocks."""
    assert abs(cs.flops(1, 1, 64, 2, 8, 28, 28) - 926e6) < 1e6
    assert abs(cs.flops(1, 2, 64, 4, 8, 14, 14) - 232e6) < 1e6
    assert cs.flops(50, 1, 64, 2, 8, 28, 28) == 50 * cs.flops(1, 1, 64, 2, 8, 28, 28)
