"""The port's visualisers (``cmf_tpu_torch/viz``) against the JAX package's
(``cmf_tpu/viz``): the same choice of visualiser for each config; the image
grid drawn into a run dir as the same figure; the 2-D density, 2-D and 3-D
non-square visualisers drawing the same arrays as the JAX package's on the
same weights (every matplotlib call recorded on both sides), with their
figures in the run dir and the folder; a refusal, naming ROADMAP module 9,
wherever the JAX package would draw with the image metric or centering
analysis; and the run-dir refusal, by name, where matplotlib does not
import.

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
MISSING = ["mnist-metric", "mnist-input-images", "cifar10-center"]
PORTED = {
    "2d-non-square": "TwoDimensionalNonSquareVisualizer",
    "2d-density": "TwoDimensionalDensityVisualizer",
    "3d-non-square": "ThreeDimensionalNonSquareVisualizer",
    "4d-non-square": "HighDimensionalNonSquareVisualizer",
    "power": "HighDimensionalNonSquareVisualizer",
}


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
        viz.get_visualizer(config, writer)
    with pytest.raises(NotImplementedError, match="module 9"):
        viz.get_visualizer(config, DummyWriter(), write_folder=str(tmp_path))
    dummy = viz.get_visualizer(config, DummyWriter())
    assert isinstance(dummy, viz.DummyDensityVisualizer)


@pytest.mark.parametrize("case", sorted(PORTED))
def test_ported_visualisers_are_given_wherever_they_draw(case, tmp_path):
    """Into a writer that keeps it, into a folder, and into a ``DummyWriter``
    with no folder, where it draws nothing."""
    config, x_shape = _config(case)
    data = np.zeros((4, *x_shape), np.float32)
    writer = Writer(str(tmp_path), make_subdir=False, tee=False)
    for w, folder in ((writer, None), (DummyWriter(), str(tmp_path)), (DummyWriter(), None)):
        visualizer = viz.get_visualizer(config, w, train_data=data, write_folder=folder)
        assert type(visualizer).__name__ == PORTED[case]
    visualizer.visualize(None, 1)  # keeps nothing: touches no density


@pytest.mark.parametrize("case", ["mnist-metric", "mnist-input-images", "cifar10-center"])
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


ZOO_RUNS = {
    "power": ("power", "HighDimensionalNonSquareVisualizer"),
    "sphere": ("sphere", "ThreeDimensionalNonSquareVisualizer"),
    "hemisphere-2-6": ("hemisphere-2-6", "HighDimensionalNonSquareVisualizer"),
    "von-mises-circle": ("von-mises-circle", "TwoDimensionalNonSquareVisualizer"),
}


def _published(dataset):
    config = expand_grid(get_config(dataset, "non-square", use_baseline=False))[0]
    return {**config, "dataset": dataset, "model": "non-square"}


@pytest.mark.parametrize("case", sorted(ZOO_RUNS))
def test_run_dir_of_a_drawing_visualiser_needs_matplotlib(case, monkeypatch):
    """The published defaults pass where matplotlib imports; where it does
    not, their run dir is refused naming the visualiser, before any work,
    and ``--nosave`` passes."""
    dataset, name = ZOO_RUNS[case]
    config = _published(dataset)
    assert viz.reference_visualizer(config) == name
    check_supported(config)
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda mod, *a: None if mod == "matplotlib" else real(mod, *a))
    with pytest.raises(ImportError, match=f"{name}.*matplotlib"):
        check_supported(config)
    check_supported({**config, "nosave": True})


class _Calls:
    """Every ``scatter``, ``plot``, ``contourf`` and ``hist`` that a
    visualiser calls (the outermost call only), with its array arguments and
    its ``c`` colours, as float64 arrays."""

    def __init__(self, monkeypatch):
        import matplotlib.axes
        from mpl_toolkits.mplot3d.axes3d import Axes3D

        self.calls, self._depth = [], 0
        for cls, name in ((matplotlib.axes.Axes, "scatter"), (matplotlib.axes.Axes, "plot"),
                          (matplotlib.axes.Axes, "contourf"), (matplotlib.axes.Axes, "hist"),
                          (Axes3D, "scatter")):
            monkeypatch.setattr(cls, name, self._recording(getattr(cls, name), name))

    def _recording(self, original, name):
        def method(ax, *args, **kw):
            if self._depth == 0:
                arrays = [np.asarray(a, np.float64) for a in args if not isinstance(a, str)]
                if isinstance(kw.get("c"), np.ndarray):
                    arrays.append(np.asarray(kw["c"], np.float64))
                self.calls.append((name, arrays))
            self._depth += 1
            try:
                return original(ax, *args, **kw)
            finally:
                self._depth -= 1

        return method

    def take(self):
        calls, self.calls = self.calls, []
        return calls


class _JaxFigures:
    def write_figure(self, tag, figure, global_step=None):
        pass


# (dataset, overrides, port class, JAX class, its extra arguments, indices
# of the calls that draw the epoch's random draws).
DRAWN = {
    "2d-non-square-1d": ("von-mises-circle", {"latent_dimension": 1}, "TwoDimensionalNonSquareVisualizer",
                         {"log_prob_low": -3, "log_prob_high": -1, "dataset": "von-mises-circle"}, ()),
    "2d-non-square-2d": ("8gaussians", {"latent_dimension": 2}, "TwoDimensionalNonSquareVisualizer",
                         {"log_prob_low": -3, "log_prob_high": -1, "dataset": "8gaussians"}, (2,)),
    "2d-density": ("8gaussians", {"latent_dimension": 2}, "TwoDimensionalDensityVisualizer",
                   {"num_elbo_samples": 1}, ()),
    "3d-latent-2": ("sphere", {}, "ThreeDimensionalNonSquareVisualizer", {"latent_dimension": 2}, (1,)),
    "3d-latent-3": ("sphere", {"latent_dimension": 3}, "ThreeDimensionalNonSquareVisualizer",
                    {"latent_dimension": 3}, (1,)),
}
FIGURES = {"TwoDimensionalNonSquareVisualizer": ("manifold_epoch3.pdf", "density_epoch3.pdf"),
           "TwoDimensionalDensityVisualizer": ("density_epoch3.pdf",),
           "ThreeDimensionalNonSquareVisualizer": ("manifold3d_epoch3.pdf",)}


@pytest.mark.parametrize("case", sorted(DRAWN))
def test_drawn_arrays_match_cmf_tpu(case, monkeypatch, tmp_path):
    """The same arrays to every matplotlib call as the JAX package's
    visualiser on the same weights and data (the epoch's random draws
    aside: the port's generators are not JAX's PRNG), the figure in the run
    dir and ``density.pdf`` in the folder. Tolerance 1e-4 of the largest
    magnitude of each array: fp32 decodes and exact log-dets."""
    from cmf_tpu import viz as jax_viz

    from _sphere_pair import sphere_pair

    dataset, overrides, cls, kwargs, random_calls = DRAWN[case]
    jd, jv, td, data = sphere_pair(dataset, seed=8, n=600, **overrides)
    calls = _Calls(monkeypatch)
    getattr(jax_viz, cls)(_JaxFigures(), data, **kwargs).visualize(jd, jv, 3)
    theirs = calls.take()
    writer = Writer(str(tmp_path), make_subdir=False, tee=False)
    getattr(viz, cls)(writer, data, **kwargs).visualize(td, 3, write_folder=str(tmp_path))
    ours = calls.take()
    assert [(n, len(a)) for n, a in ours] == [(n, len(a)) for n, a in theirs]
    for i, ((name, got), (_, want)) in enumerate(zip(ours, theirs)):
        for g, w in zip(got, want):
            assert g.shape == w.shape, (i, name)
            if i not in random_calls:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(w).max()),
                                           err_msg=f"call {i}: {name}")
    assert any(tag in os.listdir(tmp_path) for tag in FIGURES[cls])
    assert os.path.getsize(tmp_path / "density.pdf") > 0
