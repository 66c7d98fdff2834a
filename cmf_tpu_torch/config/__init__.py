"""Config DSL, group defaults and schema compiler: the port's own copy of
``cmf_tpu.config`` (pure Python). ``tests/test_torch_config.py`` holds
``get_config`` / ``get_schema`` equal to the original for every
(dataset, model) pair."""

from .dsl import CONFIG_GROUPS, GridParams, group, base, provides
from .config import (
    expand_grid,
    get_config,
    get_config_group,
    get_datasets,
    get_models,
)
from .schemas import get_schema

__all__ = [
    "CONFIG_GROUPS",
    "GridParams",
    "group",
    "base",
    "provides",
    "expand_grid",
    "get_config",
    "get_config_group",
    "get_datasets",
    "get_models",
    "get_schema",
]
