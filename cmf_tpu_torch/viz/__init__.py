"""Visualiser selection (``cmf_tpu/viz/__init__.py:14-69`` in torch).

``reference_visualizer`` names the visualiser the JAX package's
``get_visualizer`` picks for a config. ``get_visualizer`` gives the port's:
the image grid, the image metric analysis (``test_metric`` or
``test_input_images``) and the centering analysis (``test_center``), the
2-D density, the 2-D and 3-D non-square and the 4/6-D non-square
visualisers, and the dummy. Every visualiser but the dummy draws with
matplotlib: a run dir (or a folder) for one of them needs it to import,
checked here, before any work. Into a ``DummyWriter`` with no folder the
JAX package's visualisers keep nothing, and the port's skip the work there.
The card has no matplotlib; ``--nosave`` runs need none.
"""

import importlib.util

from ..data.image import DATASET_SHAPES as IMAGE_SHAPES
from ..data.tabular import DATASET_SHAPES as TABULAR_SHAPES
from ..data.two_d import _GENERATORS as TWO_D_GENERATORS, data_width
from ..training.writer import DummyWriter
from .metric_analysis import (
    HighDimensionalNonSquareVisualizer,
    ImageCenteringDensityVisualizer,
    ImageMetricDensityVisualizer,
)
from .visualizer import (
    DummyDensityVisualizer,
    ImageDensityVisualizer,
    ThreeDimensionalNonSquareVisualizer,
    TwoDimensionalDensityVisualizer,
    TwoDimensionalNonSquareVisualizer,
)

# The port's visualisers by the JAX package's class name:
# (writer, train_data, config) -> visualiser.
_FACTORIES = {
    "DummyDensityVisualizer": lambda writer, data, config: DummyDensityVisualizer(writer),
    "ImageDensityVisualizer": lambda writer, data, config: ImageDensityVisualizer(writer),
    "ImageMetricDensityVisualizer": lambda writer, data, config: ImageMetricDensityVisualizer(writer, data),
    "ImageCenteringDensityVisualizer": lambda writer, data, config: ImageCenteringDensityVisualizer(writer, data),
    "TwoDimensionalNonSquareVisualizer": lambda writer, data, config: TwoDimensionalNonSquareVisualizer(
        writer, data, log_prob_low=config.get("vis_log_prob_min"),
        log_prob_high=config.get("vis_log_prob_max"), dataset=config["dataset"]),
    "TwoDimensionalDensityVisualizer": lambda writer, data, config: TwoDimensionalDensityVisualizer(
        writer, data, num_elbo_samples=config.get("num_test_elbo_samples", 10)),
    "ThreeDimensionalNonSquareVisualizer": lambda writer, data, config: ThreeDimensionalNonSquareVisualizer(
        writer, data, latent_dimension=config.get("latent_dimension")),
    "HighDimensionalNonSquareVisualizer": lambda writer, data, config: HighDimensionalNonSquareVisualizer(
        writer, data, num_elbo_samples=config.get("num_test_elbo_samples", 1)),
}


def _data_shape(dataset):
    """One example's shape of a tabular or 2-D zoo dataset, without loading
    it."""
    if dataset in TABULAR_SHAPES:
        return (TABULAR_SHAPES[dataset][0],)
    if dataset in TWO_D_GENERATORS:
        return (data_width(dataset),)
    return None


def reference_visualizer(config, x_shape=None):
    """The class name of the JAX package's visualiser for ``config`` and
    data of shape ``x_shape`` (one example's; by default the dataset's)."""
    dataset = config["dataset"]
    if dataset in IMAGE_SHAPES:
        if config.get("test_metric") or config.get("test_input_images"):
            return "ImageMetricDensityVisualizer"
        if config.get("test_center"):
            return "ImageCenteringDensityVisualizer"
        return "ImageDensityVisualizer"
    if x_shape is None:
        x_shape = _data_shape(dataset)
    dim = x_shape[0] if x_shape is not None and len(x_shape) == 1 else None
    non_square = config.get("model") == "non-square" or config.get("non_square", False)
    latent = config.get("latent_dimension")
    if dim == 2:
        if non_square and latent in (1, 2):
            return "TwoDimensionalNonSquareVisualizer"
        return "TwoDimensionalDensityVisualizer"
    if dim == 3 and non_square and latent in (1, 2, 3):
        return "ThreeDimensionalNonSquareVisualizer"
    if dim in (4, 6) and non_square:
        return "HighDimensionalNonSquareVisualizer"
    return "DummyDensityVisualizer"


def _checked(config, keeps, write_folder=None, x_shape=None):
    """The key in ``_FACTORIES`` of ``config``'s visualiser, or raise: ``keeps``
    says whether its writer keeps what it is given. The image grid draws
    only into a writer that keeps it (the JAX package's ignores the folder);
    the others into either."""
    name = reference_visualizer(config, x_shape)
    if name == "DummyDensityVisualizer":
        return name
    draws = keeps or (write_folder is not None and name != "ImageDensityVisualizer")
    if draws:
        require_matplotlib(f"`{name}', the visualiser of `{config['dataset']}',",
                           "a run dir of this dataset needs it (pass --nosave)")
    return name


def require_matplotlib(what, needs):
    """Raise, naming ``what`` draws and what ``needs`` it, unless matplotlib
    imports here."""
    if importlib.util.find_spec("matplotlib") is None:
        raise ImportError(f"{what} draws with matplotlib, which does not import here; {needs}")


def check_visualizer(config, write_folder=None):
    """Raise unless the port can draw ``config``'s visualiser into a run
    dir, or into ``write_folder``."""
    _checked(config, keeps=write_folder is None, write_folder=write_folder)


def get_visualizer(config, writer, train_data=None, write_folder=None):
    """The visualiser of ``config`` over ``writer``; ``train_data`` (a numpy
    array of the train split) is what the 2-D, 3-D and 4/6-D ones draw
    over, and its shape decides the choice (by default the dataset's)."""
    x_shape = None if train_data is None else tuple(train_data.shape[1:])
    keeps = not isinstance(writer, DummyWriter)
    return _FACTORIES[_checked(config, keeps, write_folder, x_shape)](writer, train_data, config)


__all__ = [
    "check_visualizer",
    "get_visualizer",
    "reference_visualizer",
    "require_matplotlib",
    "DummyDensityVisualizer",
    "HighDimensionalNonSquareVisualizer",
    "ImageCenteringDensityVisualizer",
    "ImageDensityVisualizer",
    "ImageMetricDensityVisualizer",
    "ThreeDimensionalNonSquareVisualizer",
    "TwoDimensionalDensityVisualizer",
    "TwoDimensionalNonSquareVisualizer",
]
