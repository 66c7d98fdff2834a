"""Volume-preserving reshaping bijections
(``cmf_tpu/bijections/reshaping.py`` in torch): the flatten view, the flat
channel flip and permutation that the dense decode program steps over, and
the image squeeze."""

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


class Squeeze2dBijection(Bijection):
    """Glow space-to-depth squeeze (reshaping.py:77-104): (C, H, W) →
    (C·f², H/f, W/f) with the (c, fh, fw) channel ordering."""

    def __init__(self, x_shape, factor):
        assert len(x_shape) == 3
        c, h, w = x_shape
        assert h % factor == 0 and w % factor == 0
        super().__init__(x_shape=x_shape, z_shape=(c * factor**2, h // factor, w // factor))
        self.factor = factor

    def forward(self, x):
        b = x.shape[0]
        c, h, w = self.x_shape
        f = self.factor
        z = x.reshape(b, c, h // f, f, w // f, f).permute(0, 1, 3, 5, 2, 4)
        return z.reshape(b, *self.z_shape), x.new_zeros(b)

    def inverse(self, z):
        b = z.shape[0]
        zc, zh, zw = self.z_shape
        f = self.factor
        x = z.reshape(b, zc // f**2, f, f, zh, zw).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(b, *self.x_shape), z.new_zeros(b)
