"""The affine bijection (``cmf_tpu/bijections/affine.py:9-40`` in torch),
the low-dimensional prior of the 2-D zoo's non-square models.

z = x·exp(s) + t with learned s (``log_scale``) and t (``shift``), zero at
init; per channel (one value a channel, the log-jacobian counted over the
other axes) or over the whole shape. The conditional (CIF) form waits for
the u-channel densities.
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
