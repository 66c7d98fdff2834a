"""Config composition and grid expansion (contract: reference config/config.py).

``get_config`` merges a group base config with a model config. For
``non-square``, the model config names an ``underlying_flow`` whose config is
fetched first and overlaid (config.py:39-55); baseline mode strips CIF coupler
nets and zeroes u-channels (config.py:64-79). ``expand_grid`` turns nested
``GridParams`` into a cartesian product of concrete configs (config.py:84-116).
"""

from .dsl import CONFIG_GROUPS, GridParams
from . import defaults  # noqa: F401  (registers the groups)


def get_config_group(dataset):
    for name, data in CONFIG_GROUPS.items():
        if dataset in data["datasets"]:
            return name
    raise AssertionError(f"Dataset `{dataset}' not found")


def get_datasets():
    result = []
    for data in CONFIG_GROUPS.values():
        result += data["datasets"]
    return result


def get_models():
    result = []
    for data in CONFIG_GROUPS.values():
        result += list(data["model_configs"])
    return result


def get_base_config(dataset, use_baseline):
    return CONFIG_GROUPS[get_config_group(dataset)]["base_config"](dataset, use_baseline)


def get_model_config(dataset, model, use_baseline):
    group_data = CONFIG_GROUPS[get_config_group(dataset)]
    return group_data["model_configs"][model](dataset, model, use_baseline)


def get_config(dataset, model, use_baseline):
    if model == "non-square":
        non_square_config = get_model_config(dataset, model, use_baseline)
        # In the non-square context "baseline" means "no CIF base": inferred
        # from the u-channel count (config.py:43-47).
        use_baseline = non_square_config["num_u_channels"] == 0
        underlying = non_square_config["underlying_flow"]
        underlying_config = get_model_config(dataset, underlying, use_baseline)
        model_config = {**underlying_config, **non_square_config}
    else:
        model_config = get_model_config(dataset, model, use_baseline)

    config = {**get_base_config(dataset, use_baseline), **model_config}

    if use_baseline:
        for prefix in ["s", "t", "st"]:
            config.pop(f"{prefix}_nets", None)
        for prefix in ["p", "q"]:
            for suffix in ["", "_mu", "_sigma"]:
                config.pop(f"{prefix}{suffix}_nets", None)
        config = {
            **config,
            "num_u_channels": 0,
            "use_cond_affine": False,
            "pure_cond_affine": False,
            "num_valid_elbo_samples": 1,
            "num_test_elbo_samples": 1,
        }

    return config


def expand_grid_generator(config):
    if not config:
        yield {}
        return
    items = list(config.items())
    first_key, first_val = items[0]
    rest = dict(items[1:])
    for tail in expand_grid_generator(rest):
        if isinstance(first_val, GridParams):
            for val in first_val:
                yield {first_key: val, **tail}
        elif isinstance(first_val, dict):
            for sub in expand_grid_generator(first_val):
                yield {first_key: sub, **tail}
        else:
            yield {first_key: first_val, **tail}


def expand_grid(config):
    return list(expand_grid_generator(config))
