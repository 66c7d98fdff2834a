"""Affine coupling layers (``cmf_tpu/bijections/coupling.py`` in torch).

Transform convention (reference acl.py:43-46): on the modified half,
z = (x + t)·exp(s); inverse x = z·exp(−s) − t. Log-jac is Σ s over the
modified elements. Four masks: a generic channel mask, the
alternating-channel mask of the flat tabular schemas, and the checkerboard
and split-channel masks of the multiscale image schemas.

In a CIF layer ``forward(x, u)`` and ``inverse(z, u)`` take the index u:
the coupler sees the passthrough part and then u on the channel axis
(``cmf_tpu/bijections/coupling.py:33-35``).
"""

import numpy as np
import torch

from .base import Bijection


def _with_u(inputs, u):
    return inputs if u is None else torch.cat([inputs, u], dim=1)


class MaskedChannelwiseCouplingBijection(Bijection):
    """A boolean channel mask, True passing through (acl.py:218-243;
    ``cmf_tpu/bijections/coupling.py:140-160``); the coupler sees the
    passthrough channels and returns the other channels' shift and
    log-scale."""

    def __init__(self, x_shape, coupler_factory, mask):
        super().__init__(x_shape=x_shape, z_shape=x_shape)
        mask = np.asarray(mask, dtype=bool)
        assert mask.shape == (x_shape[0],)
        assert mask.any(), "Not a bijection without passthrough"
        pass_idx, mod_idx = np.nonzero(mask)[0], np.nonzero(~mask)[0]
        self.coupler = coupler_factory(int(pass_idx.size))
        inv = np.argsort(np.concatenate([pass_idx, mod_idx]))
        self.register_buffer("pass_idx", torch.as_tensor(pass_idx), persistent=False)
        self.register_buffer("mod_idx", torch.as_tensor(mod_idx), persistent=False)
        self.register_buffer("inv_perm", torch.as_tensor(inv), persistent=False)

    def _split(self, x):
        return x[:, self.pass_idx], x[:, self.mod_idx]

    def _combine(self, passthrough, modified):
        return torch.cat([passthrough, modified], dim=1)[:, self.inv_perm]

    def forward(self, x, u=None):
        passthrough, modified = self._split(x)
        shift, log_scale = self.coupler(_with_u(passthrough, u))
        z = self._combine(passthrough, (modified + shift) * torch.exp(log_scale))
        return z, log_scale.reshape(x.shape[0], -1).sum(dim=1)

    def inverse(self, z, u=None):
        passthrough, modified = self._split(z)
        shift, log_scale = self.coupler(_with_u(passthrough, u))
        x = self._combine(passthrough, modified * torch.exp(-log_scale) - shift)
        return x, -log_scale.reshape(z.shape[0], -1).sum(dim=1)


class AlternatingChannelwiseCouplingBijection(MaskedChannelwiseCouplingBijection):
    """Even channels pass through (odd when reverse_mask) — acl.py:192-214.
    With 43 channels the even mask passes 22 and modifies 21; the reversed
    mask passes 21 and modifies 22."""

    def __init__(self, x_shape, coupler_factory, reverse_mask):
        mask = np.zeros(x_shape[0], dtype=bool)
        mask[(1 if reverse_mask else 0) :: 2] = True
        super().__init__(x_shape, coupler_factory, mask)
        self.reverse_mask = reverse_mask


class Checkerboard2dCouplingBijection(Bijection):
    """Spatial checkerboard mask over NCHW images (acl.py:29-78): mask 1
    passes through. The coupler sees ``mask·x`` with every channel (then u)
    and returns a shift and log-scale for every element."""

    def __init__(self, x_shape, coupler, reverse_mask):
        super().__init__(x_shape=x_shape, z_shape=x_shape)
        assert len(x_shape) == 3
        _, h, w = x_shape
        ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        mask = ((ii + jj) % 2 == 1).astype(np.float32)
        if reverse_mask:
            mask = 1.0 - mask
        self.coupler = coupler
        self.reverse_mask = reverse_mask
        self.register_buffer("mask", torch.as_tensor(mask)[None, None], persistent=False)

    def forward(self, x, u=None):
        m = self.mask
        shift, log_scale = self.coupler(_with_u(m * x, u))
        z = m * x + (1 - m) * ((x + shift) * torch.exp(log_scale))
        return z, ((1 - m) * log_scale).reshape(x.shape[0], -1).sum(dim=1)

    def inverse(self, z, u=None):
        m = self.mask
        shift, log_scale = self.coupler(_with_u(m * z, u))
        x = m * z + (1 - m) * (z * torch.exp(-log_scale) - shift)
        return x, -((1 - m) * log_scale).reshape(z.shape[0], -1).sum(dim=1)


class SplitChannelwiseCouplingBijection(Bijection):
    """The first half of the channels passes through, the last half when
    ``reverse_mask`` (acl.py:169-189); an odd count gives the larger part to
    the reversed passthrough."""

    def __init__(self, x_shape, coupler_factory, reverse_mask):
        super().__init__(x_shape=x_shape, z_shape=x_shape)
        num_channels = x_shape[0]
        num_passthrough = num_channels // 2
        if reverse_mask:
            num_passthrough = num_channels - num_passthrough
        assert num_passthrough > 0, "Not a bijection without passthrough"
        self.coupler = coupler_factory(num_passthrough)
        self.num_passthrough = num_passthrough
        self.reverse_mask = reverse_mask

    def _split(self, x):
        cut = x.shape[1] - self.num_passthrough if self.reverse_mask else self.num_passthrough
        first, second = x[:, :cut], x[:, cut:]
        return (second, first) if self.reverse_mask else (first, second)

    def _combine(self, passthrough, modified):
        parts = (modified, passthrough) if self.reverse_mask else (passthrough, modified)
        return torch.cat(parts, dim=1)

    def forward(self, x, u=None):
        passthrough, modified = self._split(x)
        shift, log_scale = self.coupler(_with_u(passthrough, u))
        z = self._combine(passthrough, (modified + shift) * torch.exp(log_scale))
        return z, log_scale.reshape(x.shape[0], -1).sum(dim=1)

    def inverse(self, z, u=None):
        passthrough, modified = self._split(z)
        shift, log_scale = self.coupler(_with_u(passthrough, u))
        x = self._combine(passthrough, modified * torch.exp(-log_scale) - shift)
        return x, -log_scale.reshape(z.shape[0], -1).sum(dim=1)
