"""Bijection protocol (``cmf_tpu/bijections/base.py`` in torch).

A bijection is an ``nn.Module`` holding its parameters; constant buffers
(masks, index vectors) are non-persistent buffers that move with ``.to``.

* ``forward(x) -> (z, log_jac)``, log_jac shaped (B,);
* ``inverse(z) -> (x, log_jac)``; a conditional (CIF) bijection takes the
  index as well, ``forward(x, u)`` and ``inverse(z, u)``;
* ``inverse_point(z) -> x``, the decode path without the log-jacobian
  (``inverse_point(z, u)`` for a conditional one).

Shapes are the static attributes ``x_shape`` / ``z_shape`` (no batch dim).
No method returns an updated state: the running statistics of the coupler
nets' batch-norm are buffers that a training step moves in place
(``nets.batch_statistics``).
"""

import torch
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

    def inverse_point(self, z, *cond):
        """z → x without the log-jacobian (base.py:47-53)."""
        x, _ = self.inverse(z, *cond)
        return x

    def inverse_bijection(self):
        return InverseBijection(self)


class InverseBijection(Bijection):
    """Forward and inverse swapped (base.py:60-78). The bijection is the
    submodule ``bijection``, where the JAX package keeps its variables at the
    top level: its own tree loads into ``.bijection``."""

    def __init__(self, bijection):
        super().__init__(x_shape=bijection.z_shape, z_shape=bijection.x_shape)
        self.bijection = bijection

    def forward(self, x, *cond):
        return self.bijection.inverse(x, *cond)

    def inverse(self, z, *cond):
        return self.bijection(z, *cond)


class IdentityBijection(Bijection):
    """(base.py:81-89)"""

    def __init__(self, x_shape):
        super().__init__(x_shape=x_shape, z_shape=x_shape)

    def forward(self, x, *cond):
        return x, x.new_zeros(x.shape[0])

    def inverse(self, z, *cond):
        return z, z.new_zeros(z.shape[0])


class CompositeBijection(Bijection):
    """A chain of bijections, log-jacobians summed (base.py:92-134):
    ``direction="x-to-z"`` means the list maps x to z in order, ``"z-to-x"``
    that it maps z to x (each is inverted and the order reversed). The
    layers are ``layers.<i>``, as the JAX tree's ``layers`` list; the index
    of a conditional chain goes to every layer."""

    def __init__(self, bijections, direction="x-to-z"):
        assert direction in ("x-to-z", "z-to-x")
        if direction == "z-to-x":
            bijections = [b.inverse_bijection() for b in reversed(bijections)]
        super().__init__(x_shape=bijections[0].x_shape, z_shape=bijections[-1].z_shape)
        for a, b in zip(bijections[:-1], bijections[1:]):
            assert a.z_shape == b.x_shape, f"shape mismatch {a.z_shape} vs {b.x_shape}"
        self.layers = nn.ModuleList(bijections)

    def forward(self, x, *cond):
        log_jac = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for layer in self.layers:
            x, lj = layer(x, *cond)
            log_jac = log_jac + lj
        return x, log_jac

    def inverse(self, z, *cond):
        log_jac = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        for layer in reversed(self.layers):
            z, lj = layer.inverse(z, *cond)
            log_jac = log_jac + lj
        return z, log_jac
