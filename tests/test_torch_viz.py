"""The port's visualisers (``cmf_tpu_torch/viz``) against the JAX package's
(``cmf_tpu/viz``): the same choice of visualiser for each config; the image
grid drawn into a run dir as the same figure; a refusal, naming ROADMAP
module 9, wherever the JAX package would draw with a visualiser the port
lacks; and the run-dir refusal where matplotlib does not import.

TensorBoard is blocked (importing it pulls in TensorFlow where that is
installed)."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from cmf_tpu.config import expand_grid, get_config
from cmf_tpu.viz import get_visualizer as jax_get_visualizer
from cmf_tpu_torch import viz
from cmf_tpu_torch.training import DummyWriter, Writer, check_supported

# (dataset, model, overrides, x_shape of one example)
CASES = {
    "mnist": ("mnist", "non-square", {}, (1, 28, 28)),
    "mnist-metric": ("mnist", "non-square", {"test_metric": True}, (1, 28, 28)),
    "mnist-input-images": ("mnist", "non-square", {"test_input_images": True}, (1, 28, 28)),
    "cifar10-center": ("cifar10", "non-square", {"test_center": True}, (3, 32, 32)),
    "power": ("power", "non-square", {}, (6,)),
    "miniboone": ("miniboone", "non-square", {}, (43,)),
    "gas": ("gas", "non-square", {}, (8,)),
    "2d-non-square": ("sphere", "non-square", {"latent_dimension": 1}, (2,)),
    "2d-density": ("sphere", "non-square", {"latent_dimension": 3}, (2,)),
    "3d-non-square": ("sphere", "non-square", {"latent_dimension": 2}, (3,)),
    "4d-non-square": ("sphere", "non-square", {"latent_dimension": 2}, (4,)),
}
MISSING = [k for k in CASES if k not in ("mnist", "miniboone", "gas")]


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _config(case):
    dataset, model, overrides, x_shape = CASES[case]
    config = expand_grid(get_config(dataset, model, use_baseline=False))[0]
    return {**config, "dataset": dataset, "model": model, **overrides}, x_shape


@pytest.mark.parametrize("case", list(CASES))
def test_choice_matches_cmf_tpu(case):
    config, x_shape = _config(case)
    want = type(jax_get_visualizer(config, None, np.zeros((4, *x_shape), np.float32))).__name__
    assert viz.reference_visualizer(config, x_shape) == want


@pytest.mark.parametrize("case", MISSING)
def test_missing_visualisers_raise_naming_module_9(case, tmp_path):
    """Into a writer that keeps it, or with a folder to write to, the
    missing visualiser raises; into a ``DummyWriter`` with no folder the JAX
    package's visualiser keeps nothing, and the port gives the dummy."""
    config, x_shape = _config(case)
    name = viz.reference_visualizer(config, x_shape)
    writer = Writer(str(tmp_path), make_subdir=False, tee=False)
    with pytest.raises(NotImplementedError, match=f"{name}.*module 9"):
        viz.get_visualizer(config, writer, x_shape=x_shape)
    with pytest.raises(NotImplementedError, match="module 9"):
        viz.get_visualizer(config, DummyWriter(), write_folder=str(tmp_path), x_shape=x_shape)
    dummy = viz.get_visualizer(config, DummyWriter(), x_shape=x_shape)
    assert isinstance(dummy, viz.DummyDensityVisualizer)


@pytest.mark.parametrize("case", ["mnist-metric", "cifar10-center", "power"])
def test_check_supported_refuses_a_run_dir_of_a_missing_visualiser(case):
    config, _ = _config(case)
    with pytest.raises(NotImplementedError, match="module 9"):
        check_supported(config)
    check_supported({**config, "nosave": True})


class _Grid:
    """A density whose fixed samples are 9 images (a 3×3 grid) of [0, 256)
    values, some outside it."""

    def __init__(self):
        self.calls = 0

    def fixed_sample(self):
        self.calls += 1
        return torch.linspace(-20.0, 300.0, 9 * 4 * 5).reshape(9, 1, 4, 5)


def test_image_grid_matches_cmf_tpu(tmp_path):
    """The same grid image to the writer, a PDF per epoch in the run dir."""
    import jax.numpy as jnp

    images = []

    class JaxDensity:
        def fixed_sample(self, variables):
            return jnp.asarray(_Grid().fixed_sample().numpy())

    class JaxWriter:
        def write_image(self, tag, image, global_step=None):
            images.append(("jax", tag, image, global_step))

        def write_figure(self, tag, figure, global_step=None):
            images.append(("jax-figure", tag, global_step))

    jax_get_visualizer(_config("mnist")[0], JaxWriter(), np.zeros((4, 1, 28, 28))).visualize(
        JaxDensity(), {}, 3)
    writer = Writer(str(tmp_path), make_subdir=False, tee=False)
    writer.write_image = lambda tag, image, global_step=None: images.append(("port", tag, image, global_step))
    visualizer = viz.get_visualizer(_config("mnist")[0], writer)
    assert isinstance(visualizer, viz.ImageDensityVisualizer)
    visualizer.visualize(_Grid(), 3)
    (_, tag_j, grid_j, step_j), (_, ftag, fstep), (_, tag_t, grid_t, step_t) = images
    assert (tag_t, step_t) == (tag_j, step_j) == ("samples", 3) and (ftag, fstep) == ("samples_epoch3", 3)
    assert grid_t.shape == (1, 12, 15)
    np.testing.assert_array_equal(grid_t, np.asarray(grid_j))
    assert os.path.getsize(tmp_path / "samples_epoch3.pdf") > 0


def test_image_grid_into_a_dummy_writer_draws_nothing():
    density = _Grid()
    viz.get_visualizer(_config("mnist")[0], DummyWriter()).visualize(density, 1)
    assert density.calls == 0


def test_image_run_dir_without_matplotlib_is_refused(monkeypatch):
    config, _ = _config("mnist")
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    with pytest.raises(ImportError, match="matplotlib"):
        check_supported(config)
    check_supported({**config, "nosave": True})
    assert isinstance(viz.get_visualizer(config, DummyWriter()), viz.ImageDensityVisualizer)
