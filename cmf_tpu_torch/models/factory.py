"""Model factory: schema (list of layer dicts) → density module tree
(``cmf_tpu/models/factory.py`` in torch, the subset the flat and the
multiscale image non-square schemas use).

Covered: ``dequantization``, ``split``, ``non-square-head`` (exact and
Hutchinson + CG log-det; the M-flow head with ``m_flow``),
``non-square-base``, ``affine``, ``flatten``, ``flip``, ``rand-channel-perm``,
``squeeze``, ``logit``, ``tanh``, ``scalar-mult``,
``scalar-add``, ``acl`` with alternating-channel, checkerboard and
split-channel masks, ``made``, ``linear`` (LU), ``invconv`` (LU or free),
``sos``, ``nsf-ar``, ``nsf-c``, ``bnaf``, ``planar``, and a layer with
u-channels (``cond-affine``, ``cond-planar``: the CIF ``ELBODensity`` with
its p(u|z) and q(u|x), on flat or image shapes), MLP, ResNet (with or
without batch-norm), GlowCNN, constant and identity coupler nets, and the
standard Gaussian, ``batch-norm`` and the ``passthrough-before-eval``
wrapper (first in a schema only). Any other layer type, the ``acl`` layer
with u-channels, or another mask or net raises ``NotImplementedError``
naming it.

Weights are drawn from ``generator`` (a ``torch.Generator``, seeded by the
caller), then the tree moves to ``device``. They are the port's own draws:
parity with the JAX package goes through ``interop.variables_from_jax``.
"""

import numpy as np

from ..bijections import (
    AffineBijection,
    AlternatingChannelwiseCouplingBijection,
    AutoregressiveRationalQuadraticSplineBijection,
    BatchNormBijection,
    BlockNeuralAutoregressiveBijection,
    BruteForceInvertible1x1ConvBijection,
    Checkerboard2dCouplingBijection,
    ConditionalAffineBijection,
    ConditionalPlanarBijection,
    CoupledRationalQuadraticSplineBijection,
    FlipBijection,
    LogitBijection,
    LUInvertible1x1ConvBijection,
    LULinearBijection,
    MADEBijection,
    PlanarBijection,
    RandomChannelwisePermutationBijection,
    ScalarAdditionBijection,
    ScalarMultiplicationBijection,
    SplitChannelwiseCouplingBijection,
    Squeeze2dBijection,
    SumOfSquaresPolynomialBijection,
    TanhBijection,
    ViewBijection,
)
from ..couplers import ChunkedSharedCoupler, IndependentCoupler
from ..densities import (
    BijectionDensity,
    DequantizationDensity,
    DiagonalGaussianConditionalDensity,
    DiagonalGaussianDensity,
    ELBODensity,
    ManifoldFlowHeadDensity,
    NonSquareHeadDensity,
    NonSquareTailDensity,
    PassthroughBeforeEvalDensity,
    SplitDensity,
)
from ..nets import MLP, ConstantNetwork, GlowCNN, IdentityNetwork, ResNet, get_activation


def _later(what):
    return NotImplementedError(f"{what} waits for a later slice of the port")


def get_density(schema, x_shape, device, generator=None):
    """Build the density tree for input shape ``x_shape`` (no batch dim) on
    ``device``. A ``passthrough-before-eval`` first layer wraps the rest;
    the experiment attaches its rows of training data (factory.py:54-65)."""
    if schema and schema[0]["type"] == "passthrough-before-eval":
        density = PassthroughBeforeEvalDensity(
            density=get_density_recursive(schema[1:], tuple(x_shape), generator),
            num_points=schema[0]["num_passthrough_data_points"],
        )
    else:
        density = get_density_recursive(schema, tuple(x_shape), generator)
    return density.to(device)


def get_standard_gaussian_density(x_shape, generator):
    return DiagonalGaussianDensity(shape=x_shape, num_fixed_samples=64, generator=generator)


def get_density_recursive(schema, x_shape, generator):
    if not schema:
        return get_standard_gaussian_density(x_shape, generator)

    layer_config = schema[0]
    schema_tail = schema[1:]
    ty = layer_config["type"]

    if ty == "dequantization":
        return DequantizationDensity(density=get_density_recursive(schema_tail, x_shape, generator))

    if ty == "split":
        split_x_shape = (x_shape[0] // 2, *x_shape[1:])
        return SplitDensity(
            density_1=get_density_recursive(schema_tail, split_x_shape, generator),
            density_2=get_standard_gaussian_density(split_x_shape, generator),
            axis=1,
            non_square=layer_config["non_square"],
        )

    if ty == "passthrough-before-eval":
        raise AssertionError("`passthrough-before-eval` must occur first in a schema")

    if ty == "non-square-head":
        head_cls = ManifoldFlowHeadDensity if layer_config["m_flow"] else NonSquareHeadDensity
        d = layer_config["latent_dimension"]
        max_cg = layer_config["max_cg_iterations"]
        return head_cls(
            prior=get_density_recursive(schema_tail, x_shape, generator),
            regularization_param=layer_config["regularization_param"],
            log_jacobian_method=layer_config["log_jacobian_method"],
            x_shape=x_shape,
            hutchinson_distribution=layer_config["hutchinson_distribution"],
            num_hutchinson_samples=layer_config["hutchinson_samples"],
            max_cg_iterations=min(max_cg, d) if max_cg else d,
            cg_tolerance=layer_config["cg_tolerance"],
            latent_dimension=d,
            hutchinson_solver=layer_config.get("hutchinson_solver", "auto"),
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

    return get_bijection_density(layer_config, schema_tail, x_shape, generator)


def get_bijection_density(layer_config, schema_tail, x_shape, generator):
    """The layer's bijection over the rest of the schema: a
    ``BijectionDensity``, or with u-channels the CIF ``ELBODensity``
    (factory.py:128-145)."""
    bijection = get_bijection(layer_config, x_shape, generator)
    prior = get_density_recursive(schema_tail, bijection.z_shape, generator)
    num_u_channels = layer_config.get("num_u_channels", 0)
    if num_u_channels == 0:
        return BijectionDensity(bijection=bijection, prior=prior)
    return ELBODensity(
        bijection=bijection,
        prior=prior,
        p_u_density=get_conditional_density(num_u_channels, layer_config["p_coupler"], x_shape, generator),
        q_u_density=get_conditional_density(num_u_channels, layer_config["q_coupler"], x_shape, generator),
    )


def get_conditional_density(num_u_channels, coupler_config, x_shape, generator):
    """(factory.py:290-298)"""
    return DiagonalGaussianConditionalDensity(
        coupler=get_coupler(
            input_shape=x_shape,
            num_channels_per_output=num_u_channels,
            config=coupler_config,
            generator=generator,
        )
    )


def get_bijection(layer_config, x_shape, generator):
    ty = layer_config["type"]
    if ty == "flatten":
        return ViewBijection(x_shape=x_shape, z_shape=(int(np.prod(x_shape)),))
    if ty == "flip":
        return FlipBijection(x_shape=x_shape, axis=1)
    if ty == "rand-channel-perm":
        return RandomChannelwisePermutationBijection(x_shape=x_shape, generator=generator)
    if ty == "squeeze":
        return Squeeze2dBijection(x_shape=x_shape, factor=layer_config["factor"])
    if ty == "logit":
        return LogitBijection(x_shape=x_shape)
    if ty == "tanh":
        return TanhBijection(x_shape=x_shape)
    if ty == "scalar-mult":
        return ScalarMultiplicationBijection(x_shape=x_shape, value=layer_config["value"])
    if ty == "scalar-add":
        return ScalarAdditionBijection(x_shape=x_shape, value=layer_config["value"])
    if ty == "batch-norm":
        return BatchNormBijection(
            x_shape=x_shape,
            per_channel=layer_config["per_channel"],
            apply_affine=layer_config["apply_affine"],
            momentum=layer_config["momentum"],
            detach=layer_config["detach"],
        )
    if ty == "affine":
        return AffineBijection(x_shape=x_shape, per_channel=layer_config["per_channel"])
    if ty == "acl":
        return get_acl_bijection(layer_config, x_shape, generator)
    if ty == "made":
        assert len(x_shape) == 1
        return MADEBijection(
            num_input_channels=x_shape[0],
            hidden_channels=layer_config["hidden_channels"],
            activation=get_activation(layer_config["activation"]),
            generator=generator,
        )
    if ty == "cond-affine":
        return ConditionalAffineBijection(
            x_shape=x_shape,
            coupler=get_coupler(
                input_shape=(layer_config["num_u_channels"], *x_shape[1:]),
                num_channels_per_output=x_shape[0],
                config=layer_config["st_coupler"],
                generator=generator,
            ),
        )
    if ty == "linear":
        assert len(x_shape) == 1
        return LULinearBijection(num_input_channels=x_shape[0], generator=generator)
    if ty == "invconv":
        cls = LUInvertible1x1ConvBijection if layer_config["lu"] else BruteForceInvertible1x1ConvBijection
        return cls(x_shape=x_shape, generator=generator)
    if ty == "nsf-ar":
        assert len(x_shape) == 1
        return AutoregressiveRationalQuadraticSplineBijection(
            num_input_channels=x_shape[0],
            num_hidden_layers=layer_config["num_hidden_layers"],
            num_hidden_channels=layer_config["num_hidden_channels"],
            num_bins=layer_config["num_bins"],
            tail_bound=layer_config["tail_bound"],
            activation=get_activation(layer_config["activation"]),
            dropout_probability=layer_config["dropout_probability"],
            generator=generator,
        )
    if ty == "nsf-c":
        assert len(x_shape) == 1
        return CoupledRationalQuadraticSplineBijection(
            num_input_channels=x_shape[0],
            num_hidden_layers=layer_config["num_hidden_layers"],
            num_hidden_channels=layer_config["num_hidden_channels"],
            num_bins=layer_config["num_bins"],
            tail_bound=layer_config["tail_bound"],
            activation=get_activation(layer_config["activation"]),
            dropout_probability=layer_config["dropout_probability"],
            reverse_mask=layer_config["reverse_mask"],
            generator=generator,
        )
    if ty == "sos":
        assert len(x_shape) == 1
        return SumOfSquaresPolynomialBijection(
            num_input_channels=x_shape[0],
            hidden_channels=layer_config["hidden_channels"],
            activation=get_activation(layer_config["activation"]),
            num_polynomials=layer_config["num_polynomials"],
            polynomial_degree=layer_config["polynomial_degree"],
            generator=generator,
        )
    if ty == "bnaf":
        assert len(x_shape) == 1
        return BlockNeuralAutoregressiveBijection(
            num_input_channels=x_shape[0],
            num_hidden_layers=layer_config["num_hidden_layers"],
            hidden_channels_factor=layer_config["hidden_channels_factor"],
            activation=layer_config["activation"],
            residual=layer_config["residual"],
            generator=generator,
        )
    if ty == "planar":
        assert len(x_shape) == 1
        return PlanarBijection(num_input_channels=x_shape[0], generator=generator)
    if ty == "cond-planar":
        assert len(x_shape) == 1
        return ConditionalPlanarBijection(
            num_input_channels=x_shape[0],
            num_u_channels=layer_config["num_u_channels"],
            cond_hidden_channels=layer_config["cond_hidden_channels"],
            cond_activation=get_activation(layer_config["cond_activation"]),
            generator=generator,
        )
    raise _later(f"layer type `{ty}'")


def get_acl_bijection(config, x_shape, generator):
    if config.get("num_u_channels", 0) > 0:
        raise _later("the acl layer with u-channels")
    num_x_channels = x_shape[0]
    if config["mask_type"] == "checkerboard":
        return Checkerboard2dCouplingBijection(
            x_shape=x_shape,
            coupler=get_coupler(
                input_shape=(num_x_channels, *x_shape[1:]),
                num_channels_per_output=num_x_channels,
                config=config["coupler"],
                generator=generator,
            ),
            reverse_mask=config["reverse_mask"],
        )

    def coupler_factory(num_passthrough_channels):
        return get_coupler(
            input_shape=(num_passthrough_channels, *x_shape[1:]),
            num_channels_per_output=num_x_channels - num_passthrough_channels,
            config=config["coupler"],
            generator=generator,
        )

    masks = {
        "alternating-channel": AlternatingChannelwiseCouplingBijection,
        "split-channel": SplitChannelwiseCouplingBijection,
    }
    if config["mask_type"] not in masks:
        raise _later(f"acl mask type `{config['mask_type']}'")
    return masks[config["mask_type"]](
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
    ty = net_config["type"]
    if ty == "resnet":
        assert len(input_shape) == 3
        return ResNet(
            c_in=input_shape[0],
            hidden_channels=net_config["hidden_channels"],
            c_out=num_output_channels,
            use_batchnorm=net_config.get("batchnorm", True),
            detach_bn=net_config.get("ignore_batch_effects", False),
            generator=generator,
        )
    if ty == "glow-cnn":
        assert len(input_shape) == 3
        return GlowCNN(
            c_in=input_shape[0],
            c_hidden=net_config["num_hidden_channels"],
            c_out=num_output_channels,
            zero_init_output=net_config["zero_init_output"],
            generator=generator,
        )
    if ty == "constant":
        return ConstantNetwork(
            shape=(num_output_channels, *input_shape[1:]), value=net_config["value"], fixed=net_config["fixed"]
        )
    if ty == "identity":
        assert num_output_channels == input_shape[0]
        return IdentityNetwork()
    if ty != "mlp":
        raise _later(f"coupler net type `{ty}'")
    assert len(input_shape) == 1
    return MLP(
        n_in=input_shape[0],
        hidden=net_config["hidden_channels"],
        n_out=num_output_channels,
        activation=get_activation(net_config["activation"]),
        generator=generator,
    )
