"""Linear bijections (``cmf_tpu/bijections/linear.py`` in torch): glow's
invertible 1×1 convolutions, free and LU-parameterised (``invconv``,
linear.py:16-115), and the LU-parameterised linear bijection over flat
inputs (linear.py:117-164), the ``linear`` layer of the NSF schemas.

An invertible 1×1 conv applies one C×C matrix W across the channels of
(B, C) or (B, C, H, W) inputs, z = W·x (+ V·u for a layer with
u-channels); its log-jacobian is log|det W| times the H·W positions, and
its inverse applies inv(W) in fp32, as ``jnp.linalg.inv`` does.

The flat LU linear is z = (L·U)x + b with unit-diagonal L (``lower`` below
the diagonal) and U with ``upper`` above it and exp(``log_diag``) on it;
the log-jacobian is Σ log_diag. The inverse is two triangular solves.
``l_mask`` (the strict lower triangle) is state, as in the JAX package.
"""

import numpy as np
import torch
from torch import nn

from .base import Bijection


class _Invertible1x1ConvBase(Bijection):
    """W across the channels, plus V·u where the layer has u-channels
    (linear.py:25-62); V (``u_weights``) starts at zero."""

    def __init__(self, x_shape, num_u_channels=0):
        assert len(x_shape) in (1, 3)
        super().__init__(x_shape=x_shape, z_shape=x_shape)
        self.num_channels = x_shape[0]
        self.num_u_channels = num_u_channels
        self.num_non_channel_elements = float(np.prod(x_shape[1:]))
        if num_u_channels > 0:
            self.u_weights = nn.Parameter(torch.zeros(self.num_channels, num_u_channels))

    def _apply_channel_matrix(self, inputs, w):
        if len(self.x_shape) == 1:
            return inputs @ w.T
        return torch.einsum("oc,bchw->bohw", w, inputs)

    def _vu(self, u):
        if u is None:
            assert self.num_u_channels == 0
            return 0.0
        return self._apply_channel_matrix(u, self.u_weights)

    def _weights(self):
        raise NotImplementedError

    def _log_jac_single(self):
        raise NotImplementedError

    def forward(self, x, u=None):
        z = self._apply_channel_matrix(x, self._weights()) + self._vu(u)
        return z, self._log_jac_single().expand(x.shape[0])

    def inverse(self, z, u=None):
        w_inv = torch.linalg.inv(self._weights())
        x = self._apply_channel_matrix(z - self._vu(u), w_inv)
        return x, -self._log_jac_single().expand(z.shape[0])


def _random_rotation(n, generator):
    """Q of the QR factors of an n×n standard normal draw (linear.py:68,84)."""
    return torch.linalg.qr(torch.randn(n, n, generator=generator))[0]


class BruteForceInvertible1x1ConvBijection(_Invertible1x1ConvBase):
    """A free W; the log-jacobian by ``slogdet`` (linear.py:65-74)."""

    def __init__(self, x_shape, num_u_channels=0, generator=None):
        super().__init__(x_shape, num_u_channels)
        self.weights = nn.Parameter(_random_rotation(self.num_channels, generator))

    def _weights(self):
        return self.weights

    def _log_jac_single(self):
        return torch.linalg.slogdet(self.weights)[1] * self.num_non_channel_elements


class LUInvertible1x1ConvBijection(_Invertible1x1ConvBase):
    """W = P·L·U with P and sign(diag U) fixed (linear.py:77-115): ``lower``
    and ``upper`` masked to their strict triangles, exp(``log_s``) on U's
    diagonal. ``P``, ``sign_s`` and ``l_mask`` are state. ``bias``, of the
    input's shape, is a parameter that the forward never adds, as in the
    JAX package: it counts among the parameters and the optimizer holds it
    (weight decay included) with a zero gradient."""

    def __init__(self, x_shape, num_u_channels=0, generator=None):
        super().__init__(x_shape, num_u_channels)
        n = self.num_channels
        p, lower, upper = torch.linalg.lu(_random_rotation(n, generator))
        s = torch.diagonal(upper)
        self.lower = nn.Parameter(lower)
        self.log_s = nn.Parameter(torch.log(torch.abs(s)))
        self.upper = nn.Parameter(torch.triu(upper, 1))
        self.bias = nn.Parameter(torch.zeros(self.x_shape))
        self.register_buffer("P", p)
        self.register_buffer("sign_s", torch.sign(s))
        self.register_buffer("l_mask", torch.tril(torch.ones(n, n), -1))

    def _weights(self):
        eye = torch.eye(self.num_channels, dtype=self.lower.dtype, device=self.lower.device)
        lower = self.lower * self.l_mask + eye
        upper = self.upper * self.l_mask.T + torch.diag(self.sign_s * torch.exp(self.log_s))
        return self.P @ lower @ upper

    def _log_jac_single(self):
        return self.log_s.sum() * self.num_non_channel_elements


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
