"""ConcreteConditionalDensity (``cmf_tpu/densities/concrete.py`` in torch):
the Gumbel-softmax (Concrete) conditional distribution, with the
log-density of Maddison et al. 2016, eq. (10) (reference concrete.py:1-80).
The factory never builds it, in either package.

Not a ``Density``: a conditional distribution with ``log_prob`` and
``sample``, as the conditional Gaussian is. Its JAX ``init`` returns the
net's variables bare, so the JAX tree loads into ``log_alpha_map``
(``interop.py``).
"""

import math

import torch
from torch import nn

from ..parallel.mesh import draw_rows


class ConcreteConditionalDensity(nn.Module):
    def __init__(self, log_alpha_map, lam):
        super().__init__()
        self.log_alpha_map = log_alpha_map  # a net: cond → (B, K) log-alphas
        self.lam = float(lam)

    def log_prob(self, inputs, cond_inputs):
        """log p(inputs | cond), inputs on the simplex, (B, K) → (B,)
        (concrete.py:22-34)."""
        log_alpha = self.log_alpha_map(cond_inputs)
        k = log_alpha.shape[-1]
        log_x = torch.log(inputs + 1e-20)
        term1 = math.lgamma(k) + (k - 1) * math.log(self.lam)
        term2 = (log_alpha - (self.lam + 1) * log_x).sum(dim=-1)
        term3 = -k * torch.logsumexp(log_alpha - self.lam * log_x, dim=-1)
        return term1 + term2 + term3

    def sample(self, cond_inputs, generator=None, gumbel=None):
        """softmax((log α + g)/λ) and its log-prob (concrete.py:36-40): g is
        ``gumbel`` where the caller passes it (the tests pass the JAX
        package's draw), else −log(−log U) of a uniform draw from
        ``generator``."""
        log_alpha = self.log_alpha_map(cond_inputs)
        if gumbel is None:
            tiny = torch.finfo(log_alpha.dtype).tiny
            u = draw_rows(
                lambda shape: torch.rand(shape, generator=generator, dtype=log_alpha.dtype, device=log_alpha.device),
                log_alpha.shape,
            )
            gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
        sample = torch.softmax((log_alpha + gumbel) / self.lam, dim=-1)
        return sample, self.log_prob(sample, cond_inputs)
