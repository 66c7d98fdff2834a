"""Diagonal Gaussian densities (``cmf_tpu/densities/gaussian.py`` in torch)."""

import numpy as np
import torch

from .base import Density


def diagonal_gaussian_log_prob(w, means, stddevs):
    """Closed-form diagonal Gaussian log density (gaussian.py:9-22), (B,)."""
    flat_w = w.reshape(w.shape[0], -1)
    flat_means = means.reshape(means.shape[0], -1)
    flat_vars = stddevs.reshape(stddevs.shape[0], -1) ** 2
    dim = flat_w.shape[1]
    const = -0.5 * dim * np.log(2 * np.pi)
    log_det = -0.5 * torch.log(flat_vars).sum(dim=1)
    quad = -0.5 * ((flat_w - flat_means) ** 2 / flat_vars).sum(dim=1)
    return const + log_det + quad


class DiagonalGaussianDensity(Density):
    """Fixed-parameter diagonal Gaussian with an optional buffer of fixed
    samples (gaussian.py:44-87, num_fixed_samples=64 from factory.py)."""

    def __init__(self, shape, num_fixed_samples=0, generator=None):
        super().__init__()
        self.shape = tuple(shape)
        self.num_fixed_samples = num_fixed_samples
        if num_fixed_samples > 0:
            self.register_buffer(
                "fixed_samples", torch.randn((num_fixed_samples, *self.shape), generator=generator)
            )

    def elbo(self, x, **kw):
        mean = torch.zeros_like(x)
        std = torch.ones_like(x)
        return {"elbo": diagonal_gaussian_log_prob(x, mean, std), "z": x}

    def _sample(self, num_samples, generator=None):
        """Standard normal draws (gaussian.py:72-73), on the generator's
        device, else the fixed samples' device."""
        if generator is not None:
            device = generator.device
        elif self.num_fixed_samples > 0:
            device = self.fixed_samples.device
        else:
            device = None
        return torch.randn((num_samples, *self.shape), generator=generator, device=device)

    def _fixed_sample(self, noise=None):
        return noise if noise is not None else self.fixed_samples

    def extract_latent(self, x, earliest=False):
        return x
