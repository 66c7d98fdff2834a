"""The affine bijections (``cmf_tpu/bijections/affine.py`` in torch).

``AffineBijection`` (affine.py:9-40), the low-dimensional prior of the 2-D
zoo's non-square models: z = x·exp(s) + t with learned s (``log_scale``)
and t (``shift``), zero at init; per channel (one value a channel, the
log-jacobian counted over the other axes) or over the whole shape.

``ConditionalAffineBijection`` (affine.py:49-79), the CIF layer:
z = (x + t(u))·exp(s(u)), its coupler mapping the index u to (t, s).
"""

import numpy as np
import torch
from torch import nn

from .base import Bijection


class AffineBijection(Bijection):
    def __init__(self, x_shape, per_channel):
        super().__init__(x_shape=x_shape, z_shape=x_shape)
        if per_channel:
            param_shape = (self.x_shape[0],) + (1,) * (len(self.x_shape) - 1)
            self.log_jac_factor = float(np.prod(self.x_shape[1:]))
        else:
            param_shape = self.x_shape
            self.log_jac_factor = 1.0
        self.shift = nn.Parameter(torch.zeros(param_shape))
        self.log_scale = nn.Parameter(torch.zeros(param_shape))

    def _log_jac(self, batch_size):
        return (self.log_jac_factor * self.log_scale.sum()).expand(batch_size)

    def forward(self, x):
        return x * torch.exp(self.log_scale) + self.shift, self._log_jac(x.shape[0])

    def inverse(self, z):
        return (z - self.shift) * torch.exp(-self.log_scale), -self._log_jac(z.shape[0])


class ConditionalAffineBijection(Bijection):
    def __init__(self, x_shape, coupler):
        super().__init__(x_shape=x_shape, z_shape=x_shape)
        self.coupler = coupler

    @staticmethod
    def _sum_log_jac(log_scale):
        return log_scale.reshape(log_scale.shape[0], -1).sum(dim=1)

    def forward(self, x, u=None):
        shift, log_scale = self.coupler(u)
        return (x + shift) * torch.exp(log_scale), self._sum_log_jac(log_scale)

    def inverse(self, z, u=None):
        shift, log_scale = self.coupler(u)
        return z * torch.exp(-log_scale) - shift, -self._sum_log_jac(log_scale)
