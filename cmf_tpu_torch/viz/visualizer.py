"""Visualisers (``cmf_tpu/viz/visualizer.py`` in torch): what the trainer
draws after each test pass.

``visualize(density, epoch, write_folder=None)`` observes the density and
writes to the visualiser's writer. The port has two so far: the dummy, which
draws nothing, and the image visualiser's grid of fixed samples
(visualizer.py:20-48). Matplotlib (Agg) is imported when a grid is drawn,
not when this module is: the figure goes to a writer that keeps it. Into a
``DummyWriter`` the JAX package draws and keeps nothing, so the port skips
the drawing there: the outputs are the same, and a run without a run dir
needs no matplotlib.
"""

import numpy as np

from ..training.writer import DummyWriter


class DummyDensityVisualizer:
    def __init__(self, writer=None):
        self._writer = writer

    def visualize(self, density, epoch, write_folder=None):
        return


class ImageDensityVisualizer:
    """The n×n grid of ``fixed_sample()``, clipped to [0, 256) and scaled
    to [0, 1): an image to the writer and a figure ``samples_epoch<k>``."""

    def __init__(self, writer):
        self._writer = writer

    def visualize(self, density, epoch, write_folder=None):
        if isinstance(self._writer, DummyWriter):
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        imgs = density.fixed_sample().cpu().numpy()
        imgs = np.clip(imgs, 0.0, 256.0) / 256.0
        n = int(np.floor(np.sqrt(imgs.shape[0])))
        imgs = imgs[: n * n]
        c, h, w = imgs.shape[1:]
        grid = imgs.reshape(n, n, c, h, w).transpose(2, 0, 3, 1, 4).reshape(c, n * h, n * w)
        self._writer.write_image("samples", grid, global_step=epoch)
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.imshow(np.moveaxis(grid, 0, 2).squeeze(), cmap="gray" if c == 1 else None)
        ax.axis("off")
        self._writer.write_figure(f"samples_epoch{epoch}", fig, global_step=epoch)
        plt.close(fig)
