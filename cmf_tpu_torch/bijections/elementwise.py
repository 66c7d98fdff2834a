"""Elementwise bijections: logit, tanh and the scalar multiply / add of the
image preprocessing (``cmf_tpu/bijections/elementwise.py:16-91`` in torch).

As in the JAX package, the inverse log-jacobian is evaluated at the
reconstructed domain point, not at the codomain argument, and tanh's
log-derivative is log tanh'(x) = 2·(log 2 − x − softplus(−2x)), the JAX
package's fix of the reference's undefined variable.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .base import Bijection


class _ElementwiseBijection(Bijection):
    def __init__(self, x_shape):
        super().__init__(x_shape=x_shape, z_shape=x_shape)

    def forward(self, x):
        return self._f(x), self._log_df(x).reshape(x.shape[0], -1).sum(dim=1)

    def inverse(self, z):
        x = self._f_inv(z)
        return x, -self._log_df(x).reshape(x.shape[0], -1).sum(dim=1)


class LogitBijection(_ElementwiseBijection):
    _EPS = 1e-7

    def _f(self, x):
        return torch.log(x) - torch.log1p(-x)

    def _f_inv(self, z):
        return torch.sigmoid(z)

    def _log_df(self, x):
        xc = torch.clamp(x, self._EPS, 1 - self._EPS)
        return -torch.log(xc) - torch.log1p(-xc)


class TanhBijection(_ElementwiseBijection):
    _EPS = 1e-7
    _LOG2 = float(np.log(2.0))

    def _f(self, x):
        return torch.tanh(x)

    def _f_inv(self, z):
        return torch.atanh(torch.clamp(z, -1 + self._EPS, 1 - self._EPS))

    def _log_df(self, x):
        return 2.0 * (self._LOG2 - x - F.softplus(-2.0 * x))


class ScalarMultiplicationBijection(_ElementwiseBijection):
    def __init__(self, x_shape, value):
        assert np.isscalar(value) and value != 0.0
        super().__init__(x_shape=x_shape)
        self.value = float(value)

    def _f(self, x):
        return self.value * x

    def _f_inv(self, z):
        return z / self.value

    def _log_df(self, x):
        return torch.full_like(x, float(np.log(abs(self.value))))


class ScalarAdditionBijection(_ElementwiseBijection):
    def __init__(self, x_shape, value):
        assert np.isscalar(value)
        super().__init__(x_shape=x_shape)
        self.value = float(value)

    def _f(self, x):
        return x + self.value

    def _f_inv(self, z):
        return z - self.value

    def _log_df(self, x):
        return torch.zeros_like(x)
