"""Visualisers (``cmf_tpu/viz/visualizer.py`` in torch): what the trainer
draws after each test pass.

``visualize(density, epoch, write_folder=None)`` observes the density and
writes to the visualiser's writer, and with ``write_folder`` saves its
figure there too (``density.pdf``), as the JAX package's do. The port has:
the dummy, which draws nothing; the image visualiser's grid of fixed samples
(visualizer.py:20-48); the 2-D density contour (visualizer.py:51-80); the
2-D non-square one, a 1-D latent's manifold, decoder speed, pullback
density and latent histogram, or a 2-D latent's density and samples
(visualizer.py:83-197); and the 3-D non-square one (visualizer.py:200-292).
Matplotlib (Agg) is imported when a figure is drawn, not when this module
is. Into a ``DummyWriter`` with no folder the JAX package draws and keeps
nothing, so the port skips the drawing there: the outputs are the same, and
a run without a run dir needs no matplotlib. Random draws (the 2-D latent's
samples, the 3-D visualiser's first panel) are the port's own, from
generators seeded with the epoch, as the JAX package seeds ``PRNGKey(epoch)``;
every other number is the same function of the model.
"""

import numpy as np
import torch

from ..eval.metrics import metrics
from ..training.writer import DummyWriter


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _keeps_nothing(writer, write_folder):
    return isinstance(writer, DummyWriter) and write_folder is None


def _device(density):
    return next(density.parameters()).device


def _grid_log_probs(density, g1, g2, num_elbo_samples, epoch):
    """``metrics``' log-prob over the grid points (g1, g2), shaped as g1."""
    dev = _device(density)
    grid = torch.tensor(np.stack([g1.reshape(-1), g2.reshape(-1)], 1), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(epoch)
    return metrics(density, grid, num_elbo_samples, generator=gen)["log-prob"].cpu().numpy().reshape(g1.shape)


def _save(writer, fig, tag, epoch, write_folder, **savefig_kw):
    writer.write_figure(f"{tag}_epoch{epoch}", fig, global_step=epoch)
    if write_folder is not None:
        fig.savefig(f"{write_folder}/density.pdf", **savefig_kw)


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
        plt = _pyplot()
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


class TwoDimensionalDensityVisualizer:
    """The contour of exp(log p) on a 100×100 grid over the data's range,
    over 500 training points (visualizer.py:51-80)."""

    _GRID_SIZE = 100
    _NUM_TRAIN_POINTS = 500

    def __init__(self, writer, train_data, num_elbo_samples=10):
        self._writer = writer
        self._x = np.asarray(train_data)
        self._num_elbo_samples = num_elbo_samples

    @torch.no_grad()
    def visualize(self, density, epoch, write_folder=None):
        if _keeps_nothing(self._writer, write_folder):
            return
        plt = _pyplot()
        x1 = np.linspace(self._x[:, 0].min(), self._x[:, 0].max(), self._GRID_SIZE)
        x2 = np.linspace(self._x[:, 1].min(), self._x[:, 1].max(), self._GRID_SIZE)
        g1, g2 = np.meshgrid(x1, x2)
        probs = np.exp(_grid_log_probs(density, g1, g2, self._num_elbo_samples, epoch))

        fig, ax = plt.subplots(figsize=(6, 6))
        cs = ax.contourf(g1, g2, probs, levels=50)
        ax.scatter(self._x[: self._NUM_TRAIN_POINTS, 0], self._x[: self._NUM_TRAIN_POINTS, 1],
                   s=2, c="white", alpha=0.5)
        fig.colorbar(cs)
        _save(self._writer, fig, "density", epoch, write_folder)
        plt.close(fig)


class TwoDimensionalNonSquareVisualizer:
    """A non-square model of 2-D data (visualizer.py:83-197). A 1-D latent:
    the decoded curve over the latent's 0.5-99.5 percentile range coloured
    by log-density over the data, the decoder's speed |g'(z)|, the pullback
    log-density (with the von Mises truth for ``von-mises-circle``) and the
    latent histogram. A 2-D latent: the density contour and 1000 samples
    over the data."""

    _NUM_SWEEP = 1000

    def __init__(self, writer, train_data, log_prob_low, log_prob_high, dataset=None):
        self._writer = writer
        self._x = np.asarray(train_data)
        self._bounds = (log_prob_low, log_prob_high)
        self._dataset = dataset

    @torch.no_grad()
    def visualize(self, density, epoch, write_folder=None):
        if _keeps_nothing(self._writer, write_folder):
            return
        x = torch.as_tensor(self._x[:2000], device=_device(density))
        lat = density.extract_latent(x).cpu().numpy()
        if lat.shape[1] == 1:
            self._visualize_1d(density, lat, epoch, write_folder)
        else:
            self._visualize_2d(density, epoch, write_folder)

    def _visualize_1d(self, density, lat, epoch, write_folder):
        plt = _pyplot()
        dev = _device(density)
        lo, hi = np.percentile(lat[:, 0], [0.5, 99.5])
        sweep_np = np.linspace(lo, hi, self._NUM_SWEEP, dtype=np.float32)
        sweep = torch.tensor(sweep_np, device=dev)[:, None]
        curve_t = density.decode(sweep)
        curve = curve_t.cpu().numpy()
        log_probs = density.elbo(curve_t, train=False)["elbo"].cpu().numpy()
        # The decoder's speed |dg/dz| along the sweep: one JVP of the batch,
        # its rows independent.
        _, tangents = torch.func.jvp(density.decode, (sweep,), (torch.ones_like(sweep),))
        speed = np.linalg.norm(tangents.reshape(self._NUM_SWEEP, -1).cpu().numpy(), axis=1)

        fig, axes = plt.subplots(2, 2, figsize=(12, 9))
        axes[0, 0].scatter(self._x[:1000, 0], self._x[:1000, 1], s=2, c="grey", alpha=0.4)
        sc = axes[0, 0].scatter(
            curve[:, 0], curve[:, 1], s=4,
            c=np.clip(log_probs, *self._bounds) if self._bounds[0] is not None else log_probs,
            cmap="viridis",
        )
        fig.colorbar(sc, ax=axes[0, 0])
        axes[0, 0].set_title("manifold, colored by log-density")

        axes[0, 1].plot(sweep_np, speed)
        axes[0, 1].set_title("decoder speed |g'(z)|")

        # The pullback density along the curve (the JAX package draws this
        # panel where the density has the method).
        if hasattr(density, "pullback_log_jac_jac_transpose"):
            pullback = density.pullback_log_jac_jac_transpose(curve_t).cpu().numpy()
            axes[1, 0].plot(sweep_np, log_probs + pullback / 2.0, label="model pullback")
            if self._dataset == "von-mises-circle":
                from scipy.stats import vonmises

                theta = np.arctan2(curve[:, 1], curve[:, 0])
                axes[1, 0].plot(
                    sweep_np, np.log(vonmises.pdf(theta, 1.0, loc=np.pi / 2) + 1e-12),
                    "--", label="von-Mises ground truth",
                )
            axes[1, 0].legend()
            axes[1, 0].set_title("pullback log-density")

        axes[1, 1].hist(lat[:, 0], bins=50, density=True)
        axes[1, 1].set_title("latent histogram")
        _save(self._writer, fig, "manifold", epoch, write_folder)
        plt.close(fig)

    def _visualize_2d(self, density, epoch, write_folder):
        plt = _pyplot()
        g = 80
        x1 = np.linspace(self._x[:, 0].min() - 0.5, self._x[:, 0].max() + 0.5, g)
        x2 = np.linspace(self._x[:, 1].min() - 0.5, self._x[:, 1].max() + 0.5, g)
        g1, g2 = np.meshgrid(x1, x2)
        probs = np.exp(_grid_log_probs(density, g1, g2, 1, epoch))
        gen = torch.Generator(device=_device(density)).manual_seed(epoch)
        samples = density.sample(1000, generator=gen).cpu().numpy()

        fig, axes = plt.subplots(1, 2, figsize=(12, 5))
        cs = axes[0].contourf(g1, g2, probs, levels=40)
        fig.colorbar(cs, ax=axes[0])
        axes[0].set_title("model density")
        axes[1].scatter(self._x[:1000, 0], self._x[:1000, 1], s=2, alpha=0.4, label="data")
        axes[1].scatter(samples[:, 0], samples[:, 1], s=2, alpha=0.4, label="model")
        axes[1].legend()
        _save(self._writer, fig, "density", epoch, write_folder)
        plt.close(fig)


class ThreeDimensionalNonSquareVisualizer:
    """3-D ambient manifolds with 1, 2 or 3-D latents (visualizer.py:200-292):
    a panel of 500 random latents through ``fixed_sample``, then one panel a
    latent axis sweeping linspace(−2.5, 2.5, 100) with the others at 0, each
    coloured by the elbo without the reconstruction term (min-max scaled to
    [−1, 1] for a 3-D latent) over 500 training points; 1- and 2-D latents
    in stacked panels, a 3-D latent in a row."""

    _NUM_TRAIN_POINTS_TO_SHOW = 500
    _NUM_SAMPLE_POINTS_TO_SHOW = 500
    _NUM_SWEEP = 100
    _SWEEP_LO, _SWEEP_HI = -2.5, 2.5
    _CMAP = "plasma"
    _FS = 15

    def __init__(self, writer, train_data, latent_dimension=None):
        self._writer = writer
        self._x = np.asarray(train_data)
        self._latent_dimension = latent_dimension

    def latent_panels(self, latent_dim, epoch):
        """[(label, latent noise (N, L))]: a random draw, then the sweeps."""
        sweep = np.linspace(self._SWEEP_LO, self._SWEEP_HI, self._NUM_SWEEP, dtype=np.float32)
        gen = torch.Generator().manual_seed(epoch)
        panels = [torch.randn((self._NUM_SAMPLE_POINTS_TO_SHOW, latent_dim), generator=gen).numpy()]
        for k in range(latent_dim):
            noise = np.zeros((self._NUM_SWEEP, latent_dim), np.float32)
            noise[:, k] = sweep
            panels.append(noise)
        labels = ["(i)", "(ii)", "(iii)", "(iv)"][: latent_dim + 1]
        return list(zip(labels, panels))

    @torch.no_grad()
    def visualize(self, density, epoch, write_folder=None):
        if _keeps_nothing(self._writer, write_folder):
            return
        plt = _pyplot()
        dev = _device(density)
        latent_dim = self._latent_dimension
        if latent_dim is None:
            latent_dim = density.extract_latent(torch.as_tensor(self._x[:2], device=dev)).shape[1]
        panels = self.latent_panels(latent_dim, epoch)

        x = self._x[np.random.default_rng(epoch).integers(0, self._x.shape[0], self._NUM_TRAIN_POINTS_TO_SHOW)]
        row_layout = latent_dim == 3  # 3-D latent: four panels in a row
        fig = plt.figure(figsize=(16, 4.5) if row_layout else (6, 5 * len(panels)))
        im = None
        for i, (label, noise) in enumerate(panels):
            if row_layout:
                ax = fig.add_subplot(1, len(panels), i + 1, projection="3d")
            else:
                ax = fig.add_subplot(len(panels), 1, i + 1, projection="3d")
            ax.grid(False)
            ax.set_axis_off()
            embedded_t = density.fixed_sample(torch.tensor(noise, device=dev)).clone()
            info = density.elbo(embedded_t, train=False, add_reconstruction=False, likelihood_wt=1.0)
            embedded = embedded_t.cpu().numpy()
            log_probs = info["elbo"].cpu().numpy().reshape(-1)
            if row_layout:
                lo, hi = log_probs.min(), log_probs.max()
                log_probs = 2.0 * (log_probs - lo) / max(hi - lo, 1e-12) - 1.0
            ax.text2D(0.05, 0.9, label, fontsize=self._FS, transform=ax.transAxes)
            ax.scatter(x[:, 0], x[:, 1], x[:, 2], c="k", marker=".", s=7, linewidth=0.5, alpha=0.3)
            im = ax.scatter(
                embedded[:, 0], embedded[:, 1], embedded[:, 2],
                c=log_probs, cmap=self._CMAP, marker="o", s=40 if row_layout else 7,
            )
            if not row_layout:
                cb = fig.colorbar(im, ax=ax, extend="both", shrink=0.8)
                cb.set_label(r"$\log p(x)$", fontsize=self._FS)
        if row_layout and im is not None:
            cax = fig.add_axes([0.92, 0.15, 0.015, 0.7])
            cb = fig.colorbar(im, cax=cax)
            cb.set_label(r"$\log p(x)$", fontsize=self._FS)
        _save(self._writer, fig, "manifold3d", epoch, write_folder, bbox_inches="tight")
        plt.close(fig)
