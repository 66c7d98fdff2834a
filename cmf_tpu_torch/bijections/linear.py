"""The LU-parameterised linear bijection over flat inputs
(``cmf_tpu/bijections/linear.py:117-164`` in torch), the ``linear`` layer
of the NSF schemas.

z = (L·U)x + b with unit-diagonal L (``lower`` below the diagonal) and U
with ``upper`` above it and exp(``log_diag``) on it; the log-jacobian is
Σ log_diag. The inverse is two triangular solves. ``l_mask`` (the strict
lower triangle) is state, as in the JAX package.
"""

import numpy as np
import torch
from torch import nn

from .base import Bijection


class LULinearBijection(Bijection):
    def __init__(self, num_input_channels, generator=None):
        super().__init__(x_shape=(num_input_channels,), z_shape=(num_input_channels,))
        n = self.n = num_input_channels
        # Identity with a touch of noise off the diagonal, as the JAX
        # package's init draws it: U(-eps, eps), eps = 1e-3 / sqrt(n).
        eps = 1e-3 / np.sqrt(n)

        def uniform():
            return (torch.rand(n, n, generator=generator) * 2.0 - 1.0) * eps

        self.lower = nn.Parameter(uniform())
        self.upper = nn.Parameter(uniform())
        self.log_diag = nn.Parameter(torch.zeros(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("l_mask", torch.tril(torch.ones(n, n), -1))

    def _lu(self):
        eye = torch.eye(self.n, dtype=self.lower.dtype, device=self.lower.device)
        lower = self.lower * self.l_mask + eye
        upper = self.upper * self.l_mask.T + torch.diag(torch.exp(self.log_diag))
        return lower, upper

    def _log_jac(self, batch_size):
        return self.log_diag.sum().expand(batch_size)

    def forward(self, x):
        lower, upper = self._lu()
        return x @ (lower @ upper).T + self.bias, self._log_jac(x.shape[0])

    def inverse(self, z):
        lower, upper = self._lu()
        rhs = (z - self.bias).T
        y = torch.linalg.solve_triangular(lower, rhs, upper=False)
        x = torch.linalg.solve_triangular(upper, y, upper=True).T
        return x, -self._log_jac(z.shape[0])
