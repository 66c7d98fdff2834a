"""Sum-of-squares polynomial autoregressive flow (Jaini et al. 2019,
``cmf_tpu/bijections/sos.py`` in torch). Forward-only:

  z_i = c + Σ_k Σ_{l,m} a_{ikl} a_{ikm} x_i^{l+m+1} / (l+m+1)

with the coefficients a_{ik·} from an autoregressive MLP of x_{<i}, and
log|det| = Σ_i log(Σ_k (Σ_l a_{ikl} x_i^l)² + 1e-12).

The powers of x are built by repeated products, x^0 = 1, x^{n+1} = x^n·x:
integer powers that keep their sign for negative x, with a finite gradient
at x = 0.
"""

import numpy as np
import torch
from torch import nn

from ..nets import AutoregressiveMLP
from .base import Bijection


def integer_powers(x, n):
    """x^0, ..., x^n stacked on a new last axis, by repeated products."""
    powers = [torch.ones_like(x)]
    for _ in range(n):
        powers.append(powers[-1] * x)
    return torch.stack(powers, dim=-1)


class SumOfSquaresPolynomialBijection(Bijection):
    """Params ``net`` (the masked MLP, K·(r+1) heads) and ``c``, a 0-d
    tensor, zero at init (sos.py:21-41)."""

    def __init__(self, num_input_channels, hidden_channels, activation, num_polynomials, polynomial_degree,
                 generator=None):
        shape = (num_input_channels,)
        super().__init__(x_shape=shape, z_shape=shape)
        self.d = num_input_channels
        self.K = num_polynomials
        self.r = polynomial_degree
        self.net = AutoregressiveMLP(n_in=num_input_channels, hidden=hidden_channels,
                                     num_output_heads=(polynomial_degree + 1) * num_polynomials,
                                     activation=activation, generator=generator)
        self.c = nn.Parameter(torch.zeros(()))
        exponents = np.arange(polynomial_degree + 1)
        lm = exponents[:, None] + exponents[None, :] + 1  # (r+1, r+1): the integral's exponents
        self.register_buffer("lm", torch.as_tensor(lm), persistent=False)

    def forward(self, x):
        b = x.shape[0]
        a = self.net(x).reshape(b, self.K, self.r + 1, self.d).movedim(-1, 1)  # (B, d, K, r+1)
        powers = integer_powers(x, 2 * self.r + 1)  # (B, d, 2r+2)
        poly = torch.einsum("bdkl,bdl->bdk", a, powers[..., : self.r + 1])
        log_jac = torch.log((poly**2).sum(dim=-1) + 1e-12).sum(dim=-1)
        outer = torch.einsum("bdkl,bdkm->bdlm", a, a)
        integral = (outer * powers[..., self.lm] / self.lm).sum(dim=(-2, -1))
        return self.c + integral, log_jac

    def inverse(self, z):
        raise NotImplementedError("SOS polynomial flows have no analytic inverse")
