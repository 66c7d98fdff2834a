"""Density protocol (``cmf_tpu/densities/base.py`` in torch).

A density is an ``nn.Module`` holding its parameters (``nn.Parameter``) and
its state (persistent buffers: permutations, fixed samples), nested under the
same keys as the JAX package's ``{"params", "state"}`` trees, so
``interop.variables_from_jax`` can load one into the other.

* ``elbo(x, **kw) -> info`` — info always has "elbo" (B,); inside a
  non-square chain it also carries "low_dim_x" and "low_dim_elbo" bubbled up
  from the tail.
* ``decode(u) -> x`` — the injective decoder g: ℝᵈ→ℝᴰ of the non-square
  chain.
* ``sample(n, generator=None)`` and ``fixed_sample(noise=None)`` run under
  ``torch.inference_mode()``, which routes every batch-norm-free ResNet
  coupler through the fused coupler-stack kernel (``nets/core.py``). ``_sample`` /
  ``_fixed_sample`` are the same functions in whatever mode the caller is
  in: under ``torch.no_grad()`` they take the conv modules instead.
* ``extract_latent(x, earliest=False) -> latent`` — the encoder's latent of
  ``x``: in a non-square chain the d coordinates the tail keeps, or with
  ``earliest`` the base density's input below the latent prior.
* ``ood(x) -> {"likelihood", "reconstruction-error"}`` — each example's
  likelihood term and reconstruction error (exact log-det), the OOD
  battery's features; through the chain to the non-square head.
* ``step_capturable`` — whether a training step's elbo can run inside a CUDA
  graph: it reads nothing on the host and draws no random numbers, or draws
  them only from a generator the graph can hold (the CIF's u). A density is
  as capturable as the densities it holds; one that reads the host or draws
  says so itself.
"""

import torch
from torch import nn

from ..tracing import span


class Density(nn.Module):
    def elbo(self, x, **kw):
        raise NotImplementedError

    @property
    def step_capturable(self):
        return all(m.step_capturable for m in self.children() if isinstance(m, Density))

    def sample(self, num_samples, generator=None):
        with span("sample"), torch.inference_mode():
            return self._sample(num_samples, generator)

    def fixed_sample(self, noise=None):
        with torch.inference_mode():
            return self._fixed_sample(noise)

    def _sample(self, num_samples, generator=None):
        raise NotImplementedError

    def _fixed_sample(self, noise=None):
        raise NotImplementedError

    def decode(self, u):
        raise NotImplementedError(f"{type(self).__name__} is not part of a non-square chain")

    def extract_latent(self, x, earliest=False):
        raise NotImplementedError(f"{type(self).__name__} has no latent")

    def ood(self, x):
        raise NotImplementedError(f"{type(self).__name__} has no OOD features")
