"""Schema compiler: config dict → flat list of layer dicts.

Behavioral contract from reference config/schemas.py:1-689 — the schema
language is what the factory consumes and what run configs snapshot, so its
semantics (layer ordering, coupler-net mini-language, non-square wrapping,
batch-norm replacement, preprocessing insertion) match the reference.
"""

import numpy as np


def get_schema(config):
    schema = get_base_schema(config)

    if config.get("non_square", False):
        schema = apply_non_square_settings(schema, config)

    if config["pure_cond_affine"]:
        assert config["use_cond_affine"]
        schema = [layer for layer in schema if layer["type"] == "normalise"]

    if config["use_cond_affine"]:
        assert config["num_u_channels"] > 0
        schema = add_cond_affine_before_each_normalise(schema, config)

    schema = apply_pq_coupler_config_settings(schema, config)

    schema = get_preproc_schema(config) + schema

    if config["batch_norm"]:
        schema = replace_normalise_with_batch_norm(schema, config)
    else:
        schema = [layer for layer in schema if layer["type"] != "normalise"]

    if config.get("non_square", False):
        schema = remove_cond_affine_before_base(schema)

    return schema


def get_preproc_schema(config):
    schema = [{"type": "dequantization"}] if config["dequantize"] else []

    if config.get("logit_tf_lambda") is not None and config.get("logit_tf_scale") is not None:
        assert config.get("rescale_tf_scale") is None
        lam, scale = config["logit_tf_lambda"], config["logit_tf_scale"]
        schema += [
            {"type": "scalar-mult", "value": (1 - 2 * lam) / scale},
            {"type": "scalar-add", "value": lam},
            {"type": "logit"},
        ]
    elif config.get("centering_tf_scale") is not None:
        assert config.get("logit_tf_lambda") is None
        assert config.get("logit_tf_scale") is None
        schema += [
            {"type": "scalar-mult", "value": 1 / config["centering_tf_scale"]},
            {"type": "scalar-add", "value": -0.5},
        ]

    return schema


def apply_non_square_settings(schema, config):
    """Wrap the x-space schema with the non-square head and the tail + low-dim
    prior layers (schemas.py:53-105)."""
    head_layer = {
        "type": "non-square-head",
        "regularization_param": config["regularization_param"],
        "log_jacobian_method": config["log_jacobian_method"],
        "hutchinson_distribution": config.get("hutchinson_distribution", "normal"),
        "hutchinson_samples": config.get("hutchinson_samples", 1),
        "m_flow": config["m_flow"],
        "max_cg_iterations": config.get("max_cg_iterations", None),
        "cg_tolerance": config.get("cg_tolerance", 1),
        "latent_dimension": config["latent_dimension"],
        "metric_regularization_param": config["metric_regularization_param"],
    }

    tail_layers = [
        {
            "type": "non-square-base",
            "latent_dimension": config["latent_dimension"],
            "m_flow": config["m_flow"],
        }
    ]

    if config["prior"] == "affine":
        tail_layers.append({"type": "affine", "per_channel": False})
    elif config["prior"] == "realnvp":
        tail_layers += get_flat_realnvp_schema(
            num_density_layers=config["prior_num_density_layers"],
            coupler_shared_nets=True,
            coupler_hidden_channels=config["prior_hidden_channels"],
            batch_norm=True,
        )
    elif config["prior"] == "nsf":
        # Hard-coded low-dim NSF prior constants (schemas.py:88-103).
        tail_layers += get_nsf_schema(
            num_density_layers=config["prior_num_density_layers"],
            use_linear=True,
            autoregressive=True,
            num_hidden_channels=config["prior_hidden_channels"][0],
            num_hidden_layers=len(config["prior_hidden_channels"]),
            num_bins=8,
            tail_bound=3.0,
            dropout_probability=0.0,
        )

    # TPU-only extension key (not in the reference's schema language, so only
    # emitted when explicitly configured — keeps schema parity byte-for-byte):
    # selects the detached Hutchinson solve ("gram" exact / "cg" iterative /
    # "auto" = gram for d ≤ 64). See densities/nonsquare.py::_approx_log_det.
    if "hutchinson_solver" in config:
        head_layer["hutchinson_solver"] = config["hutchinson_solver"]

    return [head_layer] + schema + tail_layers


def remove_cond_affine_before_base(schema):
    """Strip cond-affines from the x-space stack of a non-square model
    (schemas.py:108-115)."""
    new_schema = []
    for i, layer in enumerate(schema):
        if layer["type"] == "non-square-base":
            return new_schema + schema[i:]
        if layer["type"] != "cond-affine":
            new_schema.append(layer)
    return new_schema


def get_base_schema(config):
    ty = config["schema_type"]
    if ty == "multiscale-realnvp":
        return get_multiscale_realnvp_schema(
            coupler_hidden_channels=config["g_hidden_channels"],
            non_square=config.get("non_square", False),
            resnet_batchnorm=config.get("resnet_batchnorm", True),
            ignore_batch_effects=config.get("ignore_batch_effects", False),
            smaller_schema=config.get("smaller_realnvp", False),
        )
    if ty == "flat-realnvp":
        return get_flat_realnvp_schema(
            num_density_layers=config["num_density_layers"],
            coupler_shared_nets=config["coupler_shared_nets"],
            coupler_hidden_channels=config["coupler_hidden_channels"],
        )
    if ty == "maf":
        return get_maf_schema(
            num_density_layers=config["num_density_layers"],
            hidden_channels=config["ar_map_hidden_channels"],
        )
    if ty == "sos":
        return get_sos_schema(
            num_density_layers=config["num_density_layers"],
            hidden_channels=config["g_hidden_channels"],
            num_polynomials_per_layer=config["num_polynomials_per_layer"],
            polynomial_degree=config["polynomial_degree"],
        )
    if ty == "nsf":
        return get_nsf_schema(
            num_density_layers=config["num_density_layers"],
            use_linear=config.get("use_linear", True),
            autoregressive=config["autoregressive"],
            num_hidden_channels=config["num_hidden_channels"],
            num_hidden_layers=config["num_hidden_layers"],
            num_bins=config["num_bins"],
            tail_bound=config["tail_bound"],
            dropout_probability=config["dropout_probability"],
        )
    if ty == "bnaf":
        return get_bnaf_schema(
            num_density_layers=config["num_density_layers"],
            num_hidden_layers=config["num_hidden_layers"],
            activation=config["activation"],
            hidden_channels_factor=config["hidden_channels_factor"],
        )
    if ty == "glow":
        return get_glow_schema(
            num_scales=config["num_scales"],
            num_steps_per_scale=config["num_steps_per_scale"],
            coupler_num_hidden_channels=config["g_num_hidden_channels"],
            lu_decomposition=True,
            non_square=config.get("non_square", False),
        )
    if ty == "planar":
        return get_planar_schema(config)
    if ty == "cond-affine":
        return [{"type": "flatten"}] + [{"type": "normalise"}] * config["num_density_layers"]
    if ty == "affine":
        return [{"type": "flatten"}] + [
            {"type": "affine", "per_channel": False}
        ] * config["num_density_layers"]
    raise AssertionError(f"Invalid schema type `{ty}'")


def replace_normalise_with_batch_norm(schema, config):
    """(schemas.py:202-233) Swap normalise pseudo-layers for batch-norm; with
    running averages off, momentum=1 snapshot mode plus a
    passthrough-before-eval wrapper holding 100k training points."""
    if config["batch_norm_use_running_averages"]:
        new_schema = []
        momentum = config["batch_norm_momentum"]
    else:
        new_schema = [
            {"type": "passthrough-before-eval", "num_passthrough_data_points": 100_000}
        ]
        momentum = 1.0

    for layer in schema:
        if layer["type"] == "normalise":
            new_schema.append(
                {
                    "type": "batch-norm",
                    "per_channel": True,
                    "momentum": momentum,
                    "apply_affine": config["batch_norm_apply_affine"],
                    "detach": config.get("ignore_batch_effects", False),
                }
            )
        else:
            new_schema.append(layer)
    return new_schema


def add_cond_affine_before_each_normalise(schema, config):
    new_schema = []
    flattened = False
    for layer in schema:
        if layer["type"] == "flatten":
            flattened = True
        elif layer["type"] == "normalise":
            new_schema.append(
                {
                    "type": "cond-affine",
                    "num_u_channels": config["num_u_channels"],
                    "st_coupler": get_coupler_config("t", "s", "st", config, flattened),
                }
            )
        new_schema.append(layer)
    return new_schema


def apply_pq_coupler_config_settings(schema, config):
    new_schema = []
    flattened = False
    for layer in schema:
        if layer["type"] == "flatten":
            flattened = True
        if layer.get("num_u_channels", 0) > 0:
            layer = {
                **layer,
                "p_coupler": get_coupler_config("p_mu", "p_sigma", "p", config, flattened),
                "q_coupler": get_coupler_config("q_mu", "q_sigma", "q", config, flattened),
            }
        new_schema.append(layer)
    return new_schema


def get_coupler_config(shift_prefix, log_scale_prefix, shift_log_scale_prefix, config, flattened):
    shift_key = f"{shift_prefix}_nets"
    log_scale_key = f"{log_scale_prefix}_nets"
    shift_log_scale_key = f"{shift_log_scale_prefix}_nets"

    if shift_key in config and log_scale_key in config:
        assert shift_log_scale_key not in config, "Over-specified coupler config"
        return {
            "independent_nets": True,
            "shift_net": get_coupler_net_config(config[shift_key], flattened),
            "log_scale_net": get_coupler_net_config(config[log_scale_key], flattened),
        }
    if shift_log_scale_key in config:
        assert shift_key not in config and log_scale_key not in config, (
            "Over-specified coupler config"
        )
        return {
            "independent_nets": False,
            "shift_log_scale_net": get_coupler_net_config(config[shift_log_scale_key], flattened),
        }
    raise AssertionError(
        f"Must specify either `{shift_log_scale_key}', or both `{shift_key}' and `{log_scale_key}'"
    )


def get_coupler_net_config(net_spec, flattened):
    """Coupler-net mini-language (schemas.py:335-377): list→mlp (flat) or
    resnet (conv); int→mlp×2 (flat) or glow-cnn; constant/identity strings."""
    if net_spec in ["fixed-constant", "learned-constant"]:
        return {"type": "constant", "value": 0, "fixed": net_spec == "fixed-constant"}
    if net_spec == "identity":
        return {"type": "identity"}
    if isinstance(net_spec, list):
        if flattened:
            return {"type": "mlp", "activation": "tanh", "hidden_channels": net_spec}
        return {"type": "resnet", "hidden_channels": net_spec}
    if isinstance(net_spec, int):
        if flattened:
            return {"type": "mlp", "activation": "tanh", "hidden_channels": [net_spec] * 2}
        return {"type": "glow-cnn", "num_hidden_channels": net_spec, "zero_init_output": True}
    raise AssertionError(f"Invalid net specifier {net_spec}")


def get_multiscale_realnvp_schema(
    coupler_hidden_channels, non_square, resnet_batchnorm, ignore_batch_effects, smaller_schema=False
):
    if smaller_schema:
        base_schema = [
            {"type": "acl", "mask_type": "checkerboard", "reverse_mask": False},
            {"type": "acl", "mask_type": "checkerboard", "reverse_mask": True},
            {"type": "squeeze", "factor": 2},
            {"type": "acl", "mask_type": "split-channel", "reverse_mask": False},
            {"type": "acl", "mask_type": "split-channel", "reverse_mask": True},
            {"type": "split", "non_square": non_square},
            {"type": "acl", "mask_type": "checkerboard", "reverse_mask": False},
            {"type": "acl", "mask_type": "checkerboard", "reverse_mask": True},
        ]
    else:
        base_schema = [
            {"type": "acl", "mask_type": "checkerboard", "reverse_mask": False},
            {"type": "acl", "mask_type": "checkerboard", "reverse_mask": True},
            {"type": "acl", "mask_type": "checkerboard", "reverse_mask": False},
            {"type": "squeeze", "factor": 2},
            {"type": "acl", "mask_type": "split-channel", "reverse_mask": True},
            {"type": "acl", "mask_type": "split-channel", "reverse_mask": False},
            {"type": "acl", "mask_type": "split-channel", "reverse_mask": True},
            {"type": "split", "non_square": non_square},
            {"type": "acl", "mask_type": "checkerboard", "reverse_mask": False},
            {"type": "acl", "mask_type": "checkerboard", "reverse_mask": True},
            {"type": "acl", "mask_type": "checkerboard", "reverse_mask": False},
            {"type": "acl", "mask_type": "checkerboard", "reverse_mask": True},
        ]

    schema = []
    for layer in base_schema:
        if layer["type"] == "acl":
            schema += [
                {
                    **layer,
                    "num_u_channels": 0,
                    "coupler": {
                        "independent_nets": False,
                        "shift_log_scale_net": {
                            "type": "resnet",
                            "hidden_channels": coupler_hidden_channels,
                            "batchnorm": resnet_batchnorm,
                            "ignore_batch_effects": ignore_batch_effects,
                        },
                    },
                },
                {"type": "normalise"},
            ]
        else:
            schema.append(layer)
    return schema


def get_glow_schema(num_scales, num_steps_per_scale, coupler_num_hidden_channels, lu_decomposition, non_square):
    schema = []
    for i in range(num_scales):
        if i > 0:
            schema.append({"type": "split", "non_square": non_square})
        schema.append({"type": "squeeze", "factor": 2})
        for _ in range(num_steps_per_scale):
            schema += [
                {"type": "normalise"},
                {"type": "invconv", "lu": lu_decomposition},
                {
                    "type": "acl",
                    "mask_type": "split-channel",
                    "reverse_mask": False,
                    "coupler": {
                        "independent_nets": False,
                        "shift_log_scale_net": {
                            "type": "glow-cnn",
                            "num_hidden_channels": coupler_num_hidden_channels,
                            "zero_init_output": True,
                        },
                    },
                    "num_u_channels": 0,
                },
            ]
    return schema


def get_flat_realnvp_schema(num_density_layers, coupler_shared_nets, coupler_hidden_channels, batch_norm=True):
    result = [{"type": "flatten"}]
    if coupler_shared_nets:
        coupler_config = {
            "independent_nets": False,
            "shift_log_scale_net": {
                "type": "mlp",
                "hidden_channels": coupler_hidden_channels,
                "activation": "tanh",
            },
        }
    else:
        coupler_config = {
            "independent_nets": True,
            "shift_net": {
                "type": "mlp",
                "hidden_channels": coupler_hidden_channels,
                "activation": "relu",
            },
            "log_scale_net": {
                "type": "mlp",
                "hidden_channels": coupler_hidden_channels,
                "activation": "tanh",
            },
        }
    for i in range(num_density_layers):
        result.append(
            {
                "type": "acl",
                "mask_type": "alternating-channel",
                "reverse_mask": i % 2 != 0,
                "coupler": coupler_config,
                "num_u_channels": 0,
            }
        )
        if batch_norm:
            result.append({"type": "normalise"})
    return result


def get_maf_schema(num_density_layers, hidden_channels):
    result = [{"type": "flatten"}]
    for i in range(num_density_layers):
        if i > 0:
            result.append({"type": "flip"})
        result += [
            {"type": "made", "hidden_channels": hidden_channels, "activation": "tanh"},
            {"type": "normalise"},
        ]
    return result


def get_sos_schema(num_density_layers, hidden_channels, num_polynomials_per_layer, polynomial_degree):
    result = [{"type": "flatten"}]
    for i in range(num_density_layers):
        if i > 0:
            result.append({"type": "flip"})
        result += [
            {
                "type": "sos",
                "hidden_channels": hidden_channels,
                "activation": "tanh",
                "num_polynomials": num_polynomials_per_layer,
                "polynomial_degree": polynomial_degree,
            },
            {"type": "normalise"},
        ]
    return result


def get_nsf_schema(
    num_density_layers, use_linear, autoregressive, num_hidden_channels,
    num_hidden_layers, num_bins, tail_bound, dropout_probability,
):
    result = [{"type": "flatten"}]
    for i in range(num_density_layers):
        result += [{"type": "rand-channel-perm"}]
        if use_linear:
            result += [{"type": "linear"}]
        layer = {
            "type": "nsf-ar" if autoregressive else "nsf-c",
            "num_hidden_channels": num_hidden_channels,
            "num_hidden_layers": num_hidden_layers,
            "num_bins": num_bins,
            "tail_bound": tail_bound,
            "activation": "relu",
            "dropout_probability": dropout_probability,
        }
        if not autoregressive:
            layer["reverse_mask"] = i % 2 == 0
        result.append(layer)
        result.append({"type": "normalise"})
    result += [{"type": "rand-channel-perm"}]
    if use_linear:
        result += [{"type": "linear"}]
    return result


def get_bnaf_schema(num_density_layers, num_hidden_layers, activation, hidden_channels_factor):
    result = [{"type": "flatten"}]
    for i in range(num_density_layers):
        if i > 0:
            result.append({"type": "flip"})
        result += [
            {
                "type": "bnaf",
                "num_hidden_layers": num_hidden_layers,
                "hidden_channels_factor": hidden_channels_factor,
                "activation": activation,
                "residual": i < num_density_layers - 1,
            },
            {"type": "normalise"},
        ]
    return result


def get_planar_schema(config):
    if config["num_u_channels"] == 0:
        layer = {"type": "planar"}
    else:
        layer = {
            "type": "cond-planar",
            "num_u_channels": config["num_u_channels"],
            "cond_hidden_channels": config["cond_hidden_channels"],
            "cond_activation": "tanh",
        }
    return [{"type": "flatten"}] + [layer, {"type": "normalise"}] * config["num_density_layers"]
