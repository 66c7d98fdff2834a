"""Diagonal Gaussian densities (``cmf_tpu/densities/gaussian.py`` in torch):
the fixed standard Gaussian at the base of every flow, and the conditional
Gaussian q(u|x) / p(u|z) of the CIF layers with its reparameterised sample
and entropy."""

import numpy as np
import torch
from torch import nn

from ..nets import BatchNorm2d
from ..parallel.mesh import draw_rows
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


def diagonal_gaussian_sample(means, stddevs, generator=None, noise=None):
    """A reparameterised sample and its log-prob (gaussian.py:23-33): ε is
    ``noise`` where the caller passes it (the parity tests pass the JAX
    package's draw), else a standard normal draw from ``generator`` on the
    means' device."""
    epsilon = noise
    if epsilon is None:
        epsilon = draw_rows(
            lambda shape: torch.randn(shape, generator=generator, dtype=means.dtype, device=means.device),
            means.shape,
        )
    samples = stddevs * epsilon + means
    flat_eps = epsilon.reshape(epsilon.shape[0], -1)
    flat_std = stddevs.reshape(stddevs.shape[0], -1)
    dim = flat_eps.shape[1]
    eps_lp = -0.5 * dim * np.log(2 * np.pi) - 0.5 * (flat_eps**2).sum(dim=1)
    return samples, -torch.log(flat_std).sum(dim=1) + eps_lp


def diagonal_gaussian_entropy(stddevs):
    """(gaussian.py:36-39), (B,)."""
    flat_std = stddevs.reshape(stddevs.shape[0], -1)
    dim = flat_std.shape[1]
    return torch.log(flat_std).sum(dim=1) + 0.5 * dim * (1 + np.log(2 * np.pi))


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


class DiagonalGaussianConditionalDensity(nn.Module):
    """q(u|x) or p(u|z), a diagonal Gaussian whose means and log-stddevs
    come from a coupler of the conditioning input (gaussian.py:78-102). Not
    a ``Density``: a conditional distribution with ``log_prob``, ``sample``
    and ``entropy``. Its coupler's batch-norm layers normalise by the batch
    in a training step but keep their running statistics: the JAX package's
    ``ELBODensity`` hands p's and q's state back unchanged (elbo.py:36-41)."""

    def __init__(self, coupler):
        super().__init__()
        self.coupler = coupler
        for m in coupler.modules():
            if isinstance(m, BatchNorm2d):
                m.updates_running = False

    def means_and_stddevs(self, cond_inputs):
        shift, log_scale = self.coupler(cond_inputs)
        return shift, torch.exp(log_scale)

    def log_prob(self, inputs, cond_inputs):
        return diagonal_gaussian_log_prob(inputs, *self.means_and_stddevs(cond_inputs))

    def sample(self, cond_inputs, generator=None, noise=None):
        return diagonal_gaussian_sample(*self.means_and_stddevs(cond_inputs), generator, noise)

    def entropy(self, cond_inputs):
        return diagonal_gaussian_entropy(self.means_and_stddevs(cond_inputs)[1])
