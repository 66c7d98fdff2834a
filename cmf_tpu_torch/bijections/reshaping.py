"""Volume-preserving reshaping bijections
(``cmf_tpu/bijections/reshaping.py`` in torch): the flatten view, and the
flat channel flip and permutation that the dense decode program steps over."""

import numpy as np
import torch

from .base import Bijection


class RandomChannelwisePermutationBijection(Bijection):
    """Fixed random channel permutation drawn at construction
    (reshaping.py:32-43); the permutation is state, loaded by interop."""

    def __init__(self, x_shape, generator=None):
        super().__init__(x_shape=x_shape, z_shape=x_shape)
        perm = torch.randperm(self.x_shape[0], generator=generator)
        self.register_buffer("permutation", perm)
        self.register_buffer("inverse_permutation", torch.argsort(perm))

    def forward(self, x):
        return x[:, self.permutation], x.new_zeros(x.shape[0])

    def inverse(self, z):
        return z[:, self.inverse_permutation], z.new_zeros(z.shape[0])


class FlipBijection(Bijection):
    """Reverse along the channel dim (reshaping.py:46-57)."""

    def __init__(self, x_shape, axis=1):
        super().__init__(x_shape=x_shape, z_shape=x_shape)
        self.axis = axis

    def forward(self, x):
        return torch.flip(x, dims=(self.axis,)), x.new_zeros(x.shape[0])

    def inverse(self, z):
        return torch.flip(z, dims=(self.axis,)), z.new_zeros(z.shape[0])


class ViewBijection(Bijection):
    """Reshape, typically flatten (reshaping.py:60-66)."""

    def __init__(self, x_shape, z_shape):
        assert int(np.prod(x_shape)) == int(np.prod(z_shape))
        super().__init__(x_shape=x_shape, z_shape=z_shape)

    def forward(self, x):
        return x.reshape(x.shape[0], *self.z_shape), x.new_zeros(x.shape[0])

    def inverse(self, z):
        return z.reshape(z.shape[0], *self.x_shape), z.new_zeros(z.shape[0])
