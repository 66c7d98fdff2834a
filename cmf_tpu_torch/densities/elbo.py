"""ELBODensity, the continuously-indexed flow (CIF) layer
(``cmf_tpu/densities/elbo.py`` in torch).

elbo(x) = log-jac + log p(u|z) − log q(u|x) + prior_elbo(z), with
u ~ q(·|x) reparameterised and the bijection indexed by u. u is drawn from
the ``generator`` the caller passes (a ``torch.Generator`` on the data's
device), unless the caller passes the draws as ``u_noise``: a list of
standard normal ε, this layer's first and the rest for the CIF layers
below, as the parity tests pass the JAX package's draws. ``sample`` draws
u from p(u|z), ``fixed_sample`` takes u at p's mean and ``extract_latent``
at q's mean.
"""

import torch

from .base import Density

# A CUDA graph holds a draw from a generator of the caller's only where the
# generator can be registered with the graph (PyTorch 2.5 and later).
GRAPH_SAFE_GENERATORS = hasattr(torch.cuda.CUDAGraph, "register_generator_state")


class ELBODensity(Density):
    def __init__(self, prior, p_u_density, bijection, q_u_density):
        super().__init__()
        self.prior = prior
        self.p_u = p_u_density
        self.bijection = bijection
        self.q_u = q_u_density

    @property
    def step_capturable(self):
        """A training step draws u from the trainer's generator: capturable
        where that generator can be registered with the graph, and the
        prior's step is."""
        return GRAPH_SAFE_GENERATORS and super().step_capturable

    def elbo(self, x, generator=None, u_noise=None, **kw):
        noise, below = (None, {}) if u_noise is None else (u_noise[0], {"u_noise": u_noise[1:]})
        u, log_q_u = self.q_u.sample(x, generator, noise)
        z, log_jac = self.bijection(x, u)
        log_p_u = self.p_u.log_prob(u, z)
        prior_info = self.prior.elbo(z, generator=generator, **below, **kw)
        return {"elbo": log_jac + log_p_u - log_q_u + prior_info["elbo"]}

    def _sample(self, num_samples, generator=None):
        z = self.prior._sample(num_samples, generator)
        u, _ = self.p_u.sample(z, generator)
        x, _ = self.bijection.inverse(z, u)
        return x

    def _fixed_sample(self, noise=None):
        z = self.prior._fixed_sample(noise)
        means, _ = self.p_u.means_and_stddevs(z)
        x, _ = self.bijection.inverse(z, means)
        return x

    def extract_latent(self, x, earliest=False):
        means, _ = self.q_u.means_and_stddevs(x)
        z, _ = self.bijection(x, means)
        return self.prior.extract_latent(z, earliest=earliest)
