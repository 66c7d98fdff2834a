"""The port's copy of the config DSL, group defaults and schema compiler
gives what ``cmf_tpu.config`` gives, for every (dataset, model) pair."""

import pytest

import cmf_tpu.config as jax_config
import cmf_tpu_torch.config as torch_config

MODELS = sorted(set(jax_config.get_models()))


def _outcome(fn):
    """The value of ``fn()``, or the type of what it raised."""
    try:
        return fn()
    except Exception as e:  # the two packages must fail alike
        return ("raised", type(e).__name__)


def _grids_and_schemas(cfg, dataset, model, baseline):
    config = cfg.get_config(dataset=dataset, model=model, use_baseline=baseline)
    return [
        (c, _outcome(lambda c=c: cfg.get_schema({"model": model, "dataset": dataset, **c})))
        for c in cfg.expand_grid(config)
    ]


def test_same_datasets_and_models():
    assert torch_config.get_datasets() == jax_config.get_datasets()
    assert torch_config.get_models() == jax_config.get_models()


@pytest.mark.parametrize("dataset", jax_config.get_datasets())
def test_config_and_schema_match(dataset):
    compared = 0
    for model in MODELS:
        for baseline in (False, True):
            want = _outcome(lambda: _grids_and_schemas(jax_config, dataset, model, baseline))
            got = _outcome(lambda: _grids_and_schemas(torch_config, dataset, model, baseline))
            assert got == want, (dataset, model, baseline)
            compared += not isinstance(want, tuple)
    assert compared > 0
