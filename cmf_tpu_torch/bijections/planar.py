"""Planar flows (Rezende & Mohamed 2015) and the CIF-conditional variant
(``cmf_tpu/bijections/planar.py`` in torch).

Forward-only bijections: the û reparameterisation keeps the map
invertible, but it has no analytic inverse, and ``inverse`` raises as the
JAX package's does.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nets import MLP
from .base import Bijection


def _batch_dot(a, b):
    return (a * b).sum(dim=-1, keepdim=True)


def planar_map(z, u, w, b):
    """f(z) = z + û·tanh(wᵀz + b) with û = u + (m(wᵀu) − wᵀu)·w/|w|²,
    m(a) = −1 + softplus(a); returns (f, log|1 + ψᵀû|) with
    ψ = (1 − tanh²(wᵀz + b))·w (planar.py:19-31)."""
    wT_u = _batch_dot(u, w)
    m = -1.0 + F.softplus(wT_u)
    u_hat = u + (m - wT_u) / (w**2).sum(dim=1, keepdim=True) * w
    inner = _batch_dot(z, w) + b
    f = z + u_hat * torch.tanh(inner)
    psi = (1.0 - torch.tanh(inner) ** 2) * w
    log_jac = torch.log(torch.abs(1.0 + _batch_dot(psi, u_hat)))
    return f, log_jac[:, 0]


class PlanarBijection(Bijection):
    """Learned ``u``, ``w`` (d,) and ``b`` (1,); u and w drawn from
    U(−a, a), a = sqrt(6/(d+1)), b zero (planar.py:34-60)."""

    def __init__(self, num_input_channels, generator=None):
        shape = (num_input_channels,)
        super().__init__(x_shape=shape, z_shape=shape)
        self.d = num_input_channels
        a = np.sqrt(6.0 / (self.d + 1))
        self.u = nn.Parameter((torch.rand(self.d, generator=generator) * 2.0 - 1.0) * a)
        self.w = nn.Parameter((torch.rand(self.d, generator=generator) * 2.0 - 1.0) * a)
        self.b = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        bsz = x.shape[0]
        return planar_map(x, self.u.expand(bsz, self.d), self.w.expand(bsz, self.d), self.b.expand(bsz, 1))

    def inverse(self, z):
        raise NotImplementedError("Planar flows have no analytic inverse")


class ConditionalPlanarBijection(Bijection):
    """(û's u, w, b) from an MLP of the CIF index u to 2d + 1 outputs
    (planar.py:69-96); the index comes as ``forward(x, u)``."""

    def __init__(self, num_input_channels, num_u_channels, cond_hidden_channels, cond_activation,
                 generator=None):
        shape = (num_input_channels,)
        super().__init__(x_shape=shape, z_shape=shape)
        self.d = num_input_channels
        self.net = MLP(n_in=num_u_channels, hidden=cond_hidden_channels, n_out=2 * num_input_channels + 1,
                       activation=cond_activation, generator=generator)

    def forward(self, x, u=None):
        params = self.net(u)
        d = self.d
        return planar_map(x, params[:, :d], params[:, d : 2 * d], params[:, 2 * d : 2 * d + 1])

    def inverse(self, z, u=None):
        raise NotImplementedError("Planar flows have no analytic inverse")
