"""Bijection protocol (``cmf_tpu/bijections/base.py`` in torch).

A bijection is an ``nn.Module`` holding its parameters; constant buffers
(masks, index vectors) are non-persistent buffers that move with ``.to``.

* ``forward(x) -> (z, log_jac)``, log_jac shaped (B,);
* ``inverse(z) -> (x, log_jac)``; a conditional (CIF) bijection takes the
  index as well, ``forward(x, u)`` and ``inverse(z, u)``;
* ``inverse_point(z) -> x``, the decode path without the log-jacobian.

Shapes are the static attributes ``x_shape`` / ``z_shape`` (no batch dim).
No method returns an updated state: the running statistics of the coupler
nets' batch-norm are buffers that a training step moves in place
(``nets.batch_statistics``).
"""

from torch import nn


class Bijection(nn.Module):
    def __init__(self, x_shape, z_shape):
        super().__init__()
        self.x_shape = tuple(x_shape)
        self.z_shape = tuple(z_shape)

    def forward(self, x):
        raise NotImplementedError

    def inverse(self, z):
        raise NotImplementedError

    def inverse_point(self, z):
        """z → x without the log-jacobian (base.py:47-53)."""
        x, _ = self.inverse(z)
        return x
