"""BijectionMixtureDensity (``cmf_tpu/densities/mixture.py`` in torch): a
mixture over K bijections that share one prior, weighted by a net of z
(reference exact.py:50-106). The factory never builds it, in either
package; it is kept for the API.

elbo(x) = logsumexp_i [log|det ∂z_i/∂x| + prior_elbo(z_i) + log w_i(z_i)],
z_i the i-th bijection's image of x and w the softmax of the weight map.
"""

import torch
from torch import nn

from .base import Density


class BijectionMixtureDensity(Density):
    """Params ``prior``, ``weight_map`` (a net z → (B, K) logits) and
    ``bijections.<i>``, as the JAX tree's."""

    def __init__(self, prior, bijections, weight_map):
        super().__init__()
        assert bijections, "Must have at least one bijection"
        self.prior = prior
        self.bijections = nn.ModuleList(bijections)
        self.weight_map = weight_map

    def elbo(self, x, **kw):
        terms = []
        for i, bijection in enumerate(self.bijections):
            z, log_jac = bijection(x)
            prior_elbo = self.prior.elbo(z, **kw)["elbo"]
            log_w = torch.log_softmax(self.weight_map(z.reshape(z.shape[0], -1)), dim=-1)[:, i]
            terms.append(log_jac + prior_elbo + log_w)
        return {"elbo": torch.logsumexp(torch.stack(terms), dim=0)}

    def sample(self, num_samples, generator=None, noise=None, indices=None):
        with torch.inference_mode():
            return self._sample(num_samples, generator, noise, indices)

    def _sample(self, num_samples, generator=None, noise=None, indices=None):
        """z from the prior (or ``noise``, the prior's sample), a component
        for each row from the categorical of the weight map's logits at z
        (or ``indices``), and that component's inverse of z
        (mixture.py:57-72)."""
        z = self.prior._sample(num_samples, generator) if noise is None else noise
        if indices is None:
            probs = torch.softmax(self.weight_map(z.reshape(num_samples, -1)), dim=-1)
            indices = torch.multinomial(probs, 1, generator=generator)[:, 0]
        xs = torch.stack([bijection.inverse(z)[0] for bijection in self.bijections])  # (K, B, ...)
        return xs[indices, torch.arange(num_samples, device=xs.device)]
