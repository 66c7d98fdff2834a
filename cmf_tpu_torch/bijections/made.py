"""The MADE autoregressive bijection (``cmf_tpu/bijections/made.py`` in
torch).

Forward (x → z, the cheap direction) is one pass of the masked net:
z_i = (x_i − μ_i(x_<i))·exp(−s_i(x_<i)). The inverse is D sequential
passes, each fixing one more coordinate (made.py:44-50).
"""

import torch

from ..couplers import IndexedSharedCoupler
from ..nets import AutoregressiveMLP
from .base import Bijection


class MADEBijection(Bijection):
    def __init__(self, num_input_channels, hidden_channels, activation, generator=None):
        shape = (num_input_channels,)
        super().__init__(x_shape=shape, z_shape=shape)
        self.d = num_input_channels
        self.coupler = IndexedSharedCoupler(
            AutoregressiveMLP(
                n_in=num_input_channels,
                hidden=hidden_channels,
                num_output_heads=2,
                activation=activation,
                generator=generator,
            )
        )

    def forward(self, x):
        means, log_stds = self.coupler(x)
        return (x - means) * torch.exp(-log_stds), -log_stds.sum(dim=-1)

    def inverse(self, z):
        x = torch.zeros_like(z)
        log_stds = torch.zeros_like(z)
        for dim in range(self.d):
            means, log_stds = self.coupler(x)
            x = x.clone()
            x[:, dim] = z[:, dim] * torch.exp(log_stds[:, dim]) + means[:, dim]
        return x, log_stds.sum(dim=-1)
