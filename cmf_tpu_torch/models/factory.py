"""Model factory: schema (list of layer dicts) → density module tree
(``cmf_tpu/models/factory.py`` in torch, the subset the flat non-square
schemas use).

Covered: ``non-square-head`` (exact log-det), ``non-square-base``,
``flatten``, ``flip``, ``rand-channel-perm``, ``acl`` with alternating-channel
masks and MLP couplers, and the standard Gaussian. Any other layer type, mask, net or option raises
``NotImplementedError`` naming it.

Weights are drawn from ``generator`` (a ``torch.Generator``, seeded by the
caller), then the tree moves to ``device``. They are the port's own draws:
parity with the JAX package goes through ``interop.variables_from_jax``.
"""

import numpy as np

from ..bijections import (
    AlternatingChannelwiseCouplingBijection,
    FlipBijection,
    RandomChannelwisePermutationBijection,
    ViewBijection,
)
from ..couplers import ChunkedSharedCoupler, IndependentCoupler
from ..densities import (
    BijectionDensity,
    DiagonalGaussianDensity,
    NonSquareHeadDensity,
    NonSquareTailDensity,
)
from ..nets import MLP, get_activation


def _later(what):
    return NotImplementedError(f"{what} waits for a later slice of the port")


def get_density(schema, x_shape, device, generator=None):
    """Build the density tree for input shape ``x_shape`` (no batch dim) on
    ``device``."""
    return get_density_recursive(schema, tuple(x_shape), generator).to(device)


def get_standard_gaussian_density(x_shape, generator):
    return DiagonalGaussianDensity(shape=x_shape, num_fixed_samples=64, generator=generator)


def get_density_recursive(schema, x_shape, generator):
    if not schema:
        return get_standard_gaussian_density(x_shape, generator)

    layer_config = schema[0]
    schema_tail = schema[1:]
    ty = layer_config["type"]

    if ty == "non-square-head":
        if layer_config["m_flow"]:
            raise _later("the M-flow head (m_flow=True)")
        return NonSquareHeadDensity(
            prior=get_density_recursive(schema_tail, x_shape, generator),
            regularization_param=layer_config["regularization_param"],
            log_jacobian_method=layer_config["log_jacobian_method"],
            x_shape=x_shape,
            latent_dimension=layer_config["latent_dimension"],
        )

    if ty == "non-square-base":
        d = layer_config["latent_dimension"]
        return NonSquareTailDensity(
            prior=get_density_recursive(schema_tail, (d,), generator),
            x_shape=x_shape,
            latent_dimension=d,
            detach_before_prior=layer_config["m_flow"],
            generator=generator,
        )

    if layer_config.get("num_u_channels", 0) != 0:
        raise _later("the CIF u-channel densities (num_u_channels > 0)")
    bijection = get_bijection(layer_config, x_shape, generator)
    prior = get_density_recursive(schema_tail, bijection.z_shape, generator)
    return BijectionDensity(bijection=bijection, prior=prior)


def get_bijection(layer_config, x_shape, generator):
    ty = layer_config["type"]
    if ty == "flatten":
        return ViewBijection(x_shape=x_shape, z_shape=(int(np.prod(x_shape)),))
    if ty == "flip":
        return FlipBijection(x_shape=x_shape, axis=1)
    if ty == "rand-channel-perm":
        return RandomChannelwisePermutationBijection(x_shape=x_shape, generator=generator)
    if ty == "acl":
        return get_acl_bijection(layer_config, x_shape, generator)
    raise _later(f"layer type `{ty}'")


def get_acl_bijection(config, x_shape, generator):
    if config["mask_type"] != "alternating-channel":
        raise _later(f"acl mask type `{config['mask_type']}'")
    num_x_channels = x_shape[0]

    def coupler_factory(num_passthrough_channels):
        return get_coupler(
            input_shape=(num_passthrough_channels, *x_shape[1:]),
            num_channels_per_output=num_x_channels - num_passthrough_channels,
            config=config["coupler"],
            generator=generator,
        )

    return AlternatingChannelwiseCouplingBijection(
        x_shape=x_shape, coupler_factory=coupler_factory, reverse_mask=config["reverse_mask"]
    )


def get_coupler(input_shape, num_channels_per_output, config, generator):
    if config["independent_nets"]:
        return IndependentCoupler(
            shift_net=get_coupler_net(
                input_shape, num_channels_per_output, config["shift_net"], generator
            ),
            log_scale_net=get_coupler_net(
                input_shape, num_channels_per_output, config["log_scale_net"], generator
            ),
        )
    return ChunkedSharedCoupler(
        shift_log_scale_net=get_coupler_net(
            input_shape, 2 * num_channels_per_output, config["shift_log_scale_net"], generator
        )
    )


def get_coupler_net(input_shape, num_output_channels, net_config, generator):
    if net_config["type"] != "mlp":
        raise _later(f"coupler net type `{net_config['type']}'")
    assert len(input_shape) == 1
    return MLP(
        n_in=input_shape[0],
        hidden=net_config["hidden_channels"],
        n_out=num_output_channels,
        activation=get_activation(net_config["activation"]),
        generator=generator,
    )
