"""BijectionDensity: density through an exact bijection
(``cmf_tpu/densities/exact.py`` in torch).

elbo(x) = prior_elbo(bij(x)) + log|det ∂z/∂x|; the non-square chain keys
("low_dim_x", "low_dim_elbo") bubble up from the prior, and ``decode`` is
``bij⁻¹ ∘ prior.decode``. Sampling maps the prior's samples back through the
inverse (exact.py:36-47).
"""

from .base import Density

_CHAIN_KEYS = ("low_dim_x", "low_dim_elbo")


class BijectionDensity(Density):
    def __init__(self, bijection, prior):
        super().__init__()
        self.bijection = bijection
        self.prior = prior

    def elbo(self, x, **kw):
        z, log_jac = self.bijection(x)
        prior_info = self.prior.elbo(z, **kw)
        info = {"elbo": prior_info["elbo"] + log_jac}
        for k in _CHAIN_KEYS:
            if k in prior_info:
                info[k] = prior_info[k]
        return info

    def decode(self, u):
        return self.bijection.inverse_point(self.prior.decode(u))

    def ood(self, x):
        z, _ = self.bijection(x)
        return self.prior.ood(z)

    def _sample(self, num_samples, generator=None):
        x, _ = self.bijection.inverse(self.prior._sample(num_samples, generator))
        return x

    def _fixed_sample(self, noise=None):
        x, _ = self.bijection.inverse(self.prior._fixed_sample(noise))
        return x
