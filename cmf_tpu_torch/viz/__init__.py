"""Visualiser selection (``cmf_tpu/viz/__init__.py:14-69`` in torch).

``reference_visualizer`` names the visualiser the JAX package's
``get_visualizer`` picks for a config. ``get_visualizer`` gives the port's
where the port has it (the image grid, the dummy). Where it has not (the
metric and centering analyses of image data, the 2-D, 3-D and 4/6-D
non-square visualisers: ROADMAP module 9), it raises
``NotImplementedError`` if that visualiser would leave anything behind: its
writer keeps what it is given, or a ``write_folder`` is named. Into a
``DummyWriter`` with no folder the JAX package's visualiser draws and keeps
nothing, so there the port gives the dummy. An image grid into a writer that
keeps it needs matplotlib, checked here, before any training.
"""

import importlib.util

from ..data.image import DATASET_SHAPES as IMAGE_SHAPES
from ..data.tabular import DATASET_SHAPES as TABULAR_SHAPES
from ..training.writer import DummyWriter
from .visualizer import DummyDensityVisualizer, ImageDensityVisualizer


def reference_visualizer(config, x_shape=None):
    """The class name of the JAX package's visualiser for ``config`` and
    data of shape ``x_shape`` (one example's); without it, the shape of the
    image and tabular datasets the port loads (any other, such as the 2-D
    zoo of module 8, then counts as having none)."""
    dataset = config["dataset"]
    if dataset in IMAGE_SHAPES:
        if config.get("test_metric") or config.get("test_input_images"):
            return "ImageMetricDensityVisualizer"
        if config.get("test_center"):
            return "ImageCenteringDensityVisualizer"
        return "ImageDensityVisualizer"
    if x_shape is None and dataset in TABULAR_SHAPES:
        x_shape = (TABULAR_SHAPES[dataset][0],)
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


def _port_visualizer(config, keeps, write_folder=None, x_shape=None):
    """The port's visualiser class for ``config``, or raise: ``keeps`` says
    whether its writer keeps what it is given."""
    name = reference_visualizer(config, x_shape)
    if name == "ImageDensityVisualizer":
        if keeps and importlib.util.find_spec("matplotlib") is None:
            raise ImportError(
                "the image visualiser draws its sample grid with matplotlib, which does not "
                "import here; a run dir of an image dataset needs it (pass --nosave)"
            )
        return ImageDensityVisualizer
    if name == "DummyDensityVisualizer" or (not keeps and write_folder is None):
        return DummyDensityVisualizer
    raise NotImplementedError(
        f"`{name}', the visualiser of `{config['dataset']}' for this config, waits for a later "
        "slice of the port (ROADMAP module 9); pass --nosave"
    )


def check_visualizer(config):
    """Raise unless the port can draw ``config``'s visualiser into a run dir."""
    _port_visualizer(config, keeps=True)


def get_visualizer(config, writer, write_folder=None, x_shape=None):
    keeps = not isinstance(writer, DummyWriter)
    return _port_visualizer(config, keeps, write_folder, x_shape)(writer)


__all__ = [
    "check_visualizer",
    "get_visualizer",
    "reference_visualizer",
    "DummyDensityVisualizer",
    "ImageDensityVisualizer",
]
