"""The batch-norm bijection (``cmf_tpu/bijections/batchnorm.py:25-115`` in
torch).

z = (x − mean)·rsqrt(var + eps), then with ``apply_affine``
z·exp(log_scale) + shift. Per channel (one statistic a channel, averaged
over the batch and the spatial axes, the log-jacobian counted over the
spatial axes: ``log_jac_factor``) or per element (averaged over the batch).

Inside ``nets.batch_statistics`` (the JAX package's ``train=True``) the
forward normalises by the batch's mean and *biased* variance (with
``detach``, no gradient through them), stores them as ``batch_mean`` /
``batch_var`` for the inverse of the same step, and moves the running
statistics: momentum 1 overwrites them with the batch's (the snapshot mode
of the passthrough wrapper), a momentum in (0, 1) averages, 0 leaves them.
Outside it, both directions use the running statistics. The four are
persistent buffers under the JAX state's keys, four distinct tensors, moved
by in-place copies so that a captured step keeps writing the same ones.

The buffers hold values only. A non-square model's decode differentiates
through the statistics its encoder's forward just took
(``cmf_tpu/densities/nonsquare.py:104-114``), so the forward also keeps the
live ``mean`` and ``var``, with their autograd graph (none with ``detach``),
as ``live_stats``; the inverse and the dense decode program read them
(``inverse_statistics``) inside ``batch_statistics``.

Under a mesh the batch's statistics are the global batch's
(``parallel.mesh.batch_mean``: sums over the data group, differentiable),
as GSPMD makes ``cmf_tpu``'s means global.
"""

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import batch_mean
from .base import Bijection


class BatchNormBijection(Bijection):
    def __init__(self, x_shape, per_channel, apply_affine, momentum, eps=1e-5, detach=False):
        super().__init__(x_shape=x_shape, z_shape=x_shape)
        assert 0 <= momentum <= 1
        assert eps > 0
        self.momentum = momentum
        self.eps = eps
        self.detach = detach
        self.apply_affine = apply_affine
        # The switch of nets.batch_statistics.
        self.batch_stats = False
        if per_channel:
            param_shape = (self.x_shape[0],) + (1,) * (len(self.x_shape) - 1)
            self.average_axes = (0,) + tuple(range(2, len(self.x_shape) + 1))
            self.log_jac_factor = float(np.prod(self.x_shape[1:]))
        else:
            param_shape = self.x_shape
            self.average_axes = (0,)
            self.log_jac_factor = 1.0
        if apply_affine:
            self.shift = nn.Parameter(torch.zeros(param_shape))
            self.log_scale = nn.Parameter(torch.zeros(param_shape))
        self.register_buffer("running_mean", torch.zeros(param_shape))
        self.register_buffer("running_var", torch.ones(param_shape))
        # The statistics of the last training forward, for its inverse.
        self.register_buffer("batch_mean", torch.zeros(param_shape))
        self.register_buffer("batch_var", torch.ones(param_shape))
        # (mean, var) of the last training forward, graph and all.
        self.live_stats = None

    def _average(self, data):
        return batch_mean(data, self.average_axes, keepdim=True)[0]

    def _log_jac(self, var, batch_size):
        summands = -0.5 * torch.log(var + self.eps)
        if self.apply_affine:
            summands = self.log_scale + summands
        return (self.log_jac_factor * summands.sum()).expand(batch_size)

    def forward(self, x):
        if self.batch_stats:
            mean = self._average(x)
            var = self._average((x - mean) ** 2)
            if self.detach:
                mean, var = mean.detach(), var.detach()
            self.live_stats = (mean, var)
            with torch.no_grad():
                m = self.momentum
                if m == 1:
                    self.running_mean.copy_(mean)
                    self.running_var.copy_(var)
                elif m > 0:
                    self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                    self.running_var.copy_((1 - m) * self.running_var + m * var)
                self.batch_mean.copy_(mean)
                self.batch_var.copy_(var)
        else:
            mean, var = self.running_mean, self.running_var
        z = (x - mean) * torch.rsqrt(var + self.eps)
        if self.apply_affine:
            z = z * torch.exp(self.log_scale) + self.shift
        return z, self._log_jac(var, x.shape[0])

    def inverse_statistics(self):
        """(mean, var) the inverse denormalises by: inside
        ``batch_statistics`` those of the last training forward, live where
        it kept them; else the running ones."""
        if not self.batch_stats:
            return self.running_mean, self.running_var
        if self.live_stats is not None:
            return self.live_stats
        return self.batch_mean, self.batch_var

    def inverse(self, z):
        if self.apply_affine:
            z = (z - self.shift) * torch.exp(-self.log_scale)
        mean, var = self.inverse_statistics()
        x = z * torch.sqrt(var + self.eps) + mean
        return x, -self._log_jac(var, z.shape[0])
