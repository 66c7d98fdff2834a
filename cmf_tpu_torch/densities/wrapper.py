"""The wrapper densities (``cmf_tpu/densities/wrapper.py`` in torch).

``DequantizationDensity`` (wrapper.py:18-53) adds U[0,1) noise to the input
before the wrapped density's elbo. The noise is drawn from the
``generator`` the caller passes (a ``torch.Generator`` on the data's
device), unless the caller passes the noise itself as
``dequantization_noise``, as the parity tests do. The same generator goes on
down, where the Hutchinson probes are drawn from it.

``PassthroughBeforeEvalDensity`` (wrapper.py:56-78) holds rows of the
training data and, before an evaluation, runs the wrapped density's
training-mode elbo over them in one batch (``refresh_state``), so that its
momentum-1 batch-norm layers snapshot their statistics. The JAX package
returns the refreshed state; here the buffers move in place, and the
trainer puts the training state back after the evaluation.
"""

import torch

from .base import Density
from ..nets import batch_statistics


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

    def extract_latent(self, x, earliest=False):
        return self.density.extract_latent(x, earliest=earliest)

    def ood(self, x):
        """No noise: the JAX package's wrapper passes ``ood`` straight on."""
        return self.density.ood(x)

    def _sample(self, num_samples, generator=None):
        return self.density._sample(num_samples, generator)

    def _fixed_sample(self, noise=None):
        return self.density._fixed_sample(noise)


class PassthroughBeforeEvalDensity(Density):
    def __init__(self, density, num_points):
        super().__init__()
        self.density = density
        self.num_points = num_points
        # The stored rows (``attach_data``): a plain attribute, not a
        # buffer, so that neither the step's non-finite freeze nor a
        # checkpoint copies them; the experiment makes them anew from the
        # seed on every setup, a resume's too.
        self.passthrough_x = None

    def attach_data(self, x):
        self.passthrough_x = x

    def refresh_state(self, generator=None, **draws):
        """The wrapped density's elbo in training mode over the stored rows,
        under ``torch.no_grad()``: every batch-norm layer takes the rows'
        statistics (``draws``: the CIF's ``u_noise``, as the tests pass
        it)."""
        with torch.no_grad(), batch_statistics(self.density):
            self.density.elbo(self.passthrough_x, train=True, generator=generator, **draws)

    def elbo(self, x, **kw):
        return self.density.elbo(x, **kw)

    def decode(self, u):
        return self.density.decode(u)

    def extract_latent(self, x, earliest=False):
        return self.density.extract_latent(x, earliest=earliest)

    def ood(self, x):
        return self.density.ood(x)

    def _sample(self, num_samples, generator=None):
        return self.density._sample(num_samples, generator)

    def _fixed_sample(self, noise=None):
        return self.density._fixed_sample(noise)
