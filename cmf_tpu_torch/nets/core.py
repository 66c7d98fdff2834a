"""Coupler networks (``cmf_tpu/nets/core.py`` in torch): the flat MLP.

Dense weights keep the JAX package's layout, ``w`` of shape (in, out) applied
as ``x @ w + b``, so JAX weights load with no transposes (``interop.py``).
Conv nets wait for the image slice.
"""

import numpy as np
import torch
from torch import nn


def get_activation(name):
    if name == "tanh":
        return torch.tanh
    if name == "relu":
        return torch.relu
    raise ValueError(f"Invalid activation {name}")


class Dense(nn.Module):
    """``x @ w + b`` with torch nn.Linear's default init, as
    ``cmf_tpu.nets.core._dense_init``: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    for both w and b."""

    def __init__(self, n_in, n_out, generator=None):
        super().__init__()
        bound = 1.0 / np.sqrt(n_in)

        def uniform(*shape):
            return (torch.rand(*shape, generator=generator) * 2.0 - 1.0) * bound

        self.w = nn.Parameter(uniform(n_in, n_out))
        self.b = nn.Parameter(uniform(n_out))

    def forward(self, x):
        return x @ self.w + self.b


class MLP(nn.Module):
    """Dense stack with an activation between layers (networks.py:206-224)."""

    def __init__(self, n_in, hidden, n_out, activation, generator=None):
        super().__init__()
        self.sizes = [n_in] + list(hidden) + [n_out]
        self.activation = activation
        self.layers = nn.ModuleList(
            Dense(a, b, generator) for a, b in zip(self.sizes[:-1], self.sizes[1:])
        )

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.activation(x)
        return x
