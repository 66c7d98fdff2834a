"""DequantizationDensity (``cmf_tpu/densities/wrapper.py:18-53`` in torch):
adds U[0,1) noise to the input before the wrapped density's elbo.

The noise is drawn from the ``generator`` the caller passes (a
``torch.Generator`` on the data's device), unless the caller passes the
noise itself as ``dequantization_noise``, as the parity tests do. The same
generator goes on down, where the Hutchinson probes are drawn from it.
"""

import torch

from .base import Density


class DequantizationDensity(Density):
    def __init__(self, density):
        super().__init__()
        self.density = density

    def elbo(self, x, generator=None, dequantization_noise=None, **kw):
        noise = dequantization_noise
        if noise is None:
            noise = torch.rand(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        return self.density.elbo(x + noise, generator=generator, **kw)

    @property
    def step_capturable(self):
        """No: a training step draws the noise from the caller's generator,
        which a CUDA graph does not hold."""
        return False

    def decode(self, u):
        return self.density.decode(u)

    def ood(self, x):
        """No noise: the JAX package's wrapper passes ``ood`` straight on."""
        return self.density.ood(x)

    def _sample(self, num_samples, generator=None):
        return self.density._sample(num_samples, generator)

    def _fixed_sample(self, noise=None):
        return self.density._fixed_sample(noise)
