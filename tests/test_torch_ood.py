"""The OOD battery in the port against the JAX package: ``density.ood`` of
the mnist model on converted weights (the exact log-det through the generic
Jacobian, under ``torch.no_grad()``), the stump classification on the same
arrays, and an empty train split raising in both. The battery's CLI runs in
``tests/test_torch_image_default_run.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.config import expand_grid, get_config, get_schema
from cmf_tpu.data.loaders import ArrayLoader as JaxArrayLoader
from cmf_tpu.models import get_density as jax_get_density
from cmf_tpu.training import experiment as jax_experiment
from cmf_tpu.training.trainer import Trainer as JaxTrainer
from cmf_tpu_torch.data import ArrayLoader
from cmf_tpu_torch.interop import variables_from_jax
from cmf_tpu_torch.models import get_density
from cmf_tpu_torch.ops import coupler_stack as cs
from cmf_tpu_torch.training import Trainer, experiment, get_objective, make_optimizer

from _torch_parity import to_numpy

X_SHAPE = (1, 8, 8)
# The likelihood term carries the exact log-det of a 20×20 Gram of JVP
# columns through ten ResNet couplers; fp32 both sides.
OOD_TOL = 1e-4


def _mnist_config(**overrides):
    config = expand_grid(get_config("mnist", "non-square", use_baseline=False))[0]
    config.update(g_hidden_channels=[8], prior_hidden_channels=[8], **overrides)
    return config


@pytest.fixture(scope="module")
def pair():
    schema = get_schema(_mnist_config())
    jd = jax_get_density(schema, x_shape=X_SHAPE)
    jv = jd.init(jax.random.PRNGKey(0))
    td = get_density(schema, x_shape=X_SHAPE, device="cpu")
    variables_from_jax(td, to_numpy(jv))
    return jd, jv, td


def test_ood_matches_cmf_tpu(pair):
    jd, jv, td = pair
    x = np.random.default_rng(0).integers(0, 256, size=(5, *X_SHAPE)).astype(np.float32)
    want = jax.jit(lambda v, xb: jd.ood(v, xb))(jv, jnp.asarray(x))
    cs.reset_launch_counts()
    with torch.no_grad():
        got = td.ood(torch.tensor(x))
    assert cs.CALLS == 0  # the decode's tangents need the conv modules
    assert set(got) == set(want) == {"likelihood", "reconstruction-error"}
    for k in want:
        w = np.asarray(want[k])
        assert w.shape == (5,) and np.isfinite(w).all()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=OOD_TOL, atol=OOD_TOL * np.abs(w).max())


def test_ood_classification_matches_cmf_tpu(tmp_path):
    rng = np.random.default_rng(5)
    for split in ("train", "test"):
        arr_in = rng.normal(size=(40, 2))
        arr_out = rng.normal(loc=(1.0, -0.5), size=(30, 2))
        arr_out[:3, 0] = arr_in[:3, 0]  # ties across the classes
        np.save(tmp_path / f"ood_metrics_{split}_in.npy", arr_in)
        np.save(tmp_path / f"ood_metrics_{split}_out.npy", arr_out)
    got = experiment.ood_classification(str(tmp_path))
    want = jax_experiment.ood_classification(str(tmp_path))
    assert got == want
    assert set(got) == {"train/likelihood", "train/reconstruction-error",
                        "test/likelihood", "test/reconstruction-error"}


def test_train_split_under_1000_rows_gives_no_batch_in_either(pair):
    """The battery's batch of 1000 on the drop-last train loader: 999 rows
    give no batch, and both packages raise (copied, not repaired)."""
    jd, jv, td = pair
    x = np.zeros((999, *X_SHAPE), np.float32)
    jax_loader = JaxArrayLoader(x, 1000, shuffle=True, drop_last=True)
    loader = ArrayLoader(x, 1000, "cpu", shuffle=True, drop_last=True)
    assert len(jax_loader) == len(loader) == 0
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.__dict__.update(density=jd, params=jv["params"], model_state=jv["state"], rng=jax.random.PRNGKey(0),
                       batch_sharding=None, _eval_cache={})
    with pytest.raises(KeyError):
        jt.test_ood(jax_loader, "ood_metrics_train_in")
    trainer = Trainer(td, get_objective(_mnist_config()), [make_optimizer({"lr": 1e-4}, td.parameters())],
                      None, max_epochs=0)
    with pytest.raises(KeyError):
        trainer.test_ood(loader, "ood_metrics_train_in")
