"""SplitDensity, the multiscale factor-out (``cmf_tpu/densities/split.py`` in
torch).

elbo: split the channels in two and sum the two halves' elbos; the
non-square chain keys come from the first half. With ``non_square`` the
second half is dropped on the way down: decode, sample and fixed_sample
zero-pad it (split.py:40-62).
"""

import torch

from .base import Density

_CHAIN_KEYS = ("low_dim_x", "low_dim_elbo")


class SplitDensity(Density):
    def __init__(self, density_1, density_2, axis=1, non_square=False):
        super().__init__()
        self.density_1 = density_1
        self.density_2 = density_2
        self.axis = axis
        self.non_square = non_square

    def elbo(self, x, **kw):
        assert x.shape[self.axis] % 2 == 0
        x1, x2 = torch.chunk(x, 2, dim=self.axis)
        info1 = self.density_1.elbo(x1, **kw)
        info2 = self.density_2.elbo(x2, **kw)
        info = {"elbo": info1["elbo"] + info2["elbo"]}
        for k in _CHAIN_KEYS:
            if k in info1:
                info[k] = info1[k]
        return info

    def extract_latent(self, x, earliest=False):
        x1, _ = torch.chunk(x, 2, dim=self.axis)
        return self.density_1.extract_latent(x1, earliest=earliest)

    def pad_inputs(self, x1):
        return torch.cat([x1, torch.zeros_like(x1)], dim=self.axis)

    def decode(self, u):
        return self.pad_inputs(self.density_1.decode(u))

    def _sample(self, num_samples, generator=None):
        x1 = self.density_1._sample(num_samples, generator)
        if self.non_square:
            return self.pad_inputs(x1)
        return torch.cat([x1, self.density_2._sample(num_samples, generator)], dim=self.axis)

    def _fixed_sample(self, noise=None):
        x1 = self.density_1._fixed_sample(noise)
        if self.non_square:
            return self.pad_inputs(x1)
        return torch.cat([x1, self.density_2._fixed_sample(noise)], dim=self.axis)
