"""Rational-quadratic spline bijections (neural spline flows,
``cmf_tpu/bijections/spline.py`` in torch): the spline with linear tails,
the coupled spline of the ``nsf-c`` layer and the masked autoregressive
spline of the ``nsf-ar`` layer.

The spline (Durkan et al. 2019, eqs. 4-8) runs through K+1 knots with K−1
free interior derivatives and is the identity outside [−B, B]. The
constants are the JAX package's: minimum bin width, height and derivative
1e-3, widths and heights softmaxed, derivatives softplus'd. The bin is the
JAX package's count of the knots ≤ x, less one, clipped to [0, K−1]
(spline.py:80-83), so the edges fall in the same bin.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nets import AutoregressiveMLP, Dense
from .base import Bijection

_MIN_BIN_WIDTH = 1e-3
_MIN_BIN_HEIGHT = 1e-3
_MIN_DERIVATIVE = 1e-3


def _knots(unnormalized, min_size, tail_bound):
    """Cumulative knot positions (..., K+1) and bin sizes (..., K). The
    running sum over the K bins is a product with a triangle of ones:
    ``torch.cumsum``'s scan over a last dim of 4 took 1.2 ms a call at
    (5000, 43, 4) on the H100, 0.9 of a sample's device time (PERF.md)."""
    k = unnormalized.shape[-1]
    sizes = min_size + (1 - min_size * k) * torch.softmax(unnormalized, dim=-1)
    triangle = torch.ones(k, k, dtype=sizes.dtype, device=sizes.device).triu()
    cum = F.pad(sizes @ triangle, (1, 0))
    cum = (2 * tail_bound) * cum - tail_bound
    cum = torch.cat([torch.full_like(cum[..., :1], -tail_bound), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], tail_bound)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def _compute_knots(unnormalized_widths, unnormalized_heights, unnormalized_derivs, tail_bound):
    """Raw spline parameters → (cumwidths, widths, cumheights, heights,
    derivs) (spline.py:31-65); the boundary derivatives are pinned to 1, so
    the spline continues the identity tails."""
    cumwidths, widths = _knots(unnormalized_widths, _MIN_BIN_WIDTH, tail_bound)
    cumheights, heights = _knots(unnormalized_heights, _MIN_BIN_HEIGHT, tail_bound)
    const = float(np.log(np.expm1(1 - _MIN_DERIVATIVE)))
    pad = torch.full_like(unnormalized_derivs[..., :1], const)
    derivs = _MIN_DERIVATIVE + F.softplus(torch.cat([pad, unnormalized_derivs, pad], dim=-1))
    return cumwidths, widths, cumheights, heights, derivs


def rational_quadratic_spline(inputs, uw, uh, ud, tail_bound, inverse=False):
    """Elementwise RQ spline with linear tails (spline.py:68-121).

    inputs (...,); uw, uh (..., K); ud (..., K−1). Returns (outputs,
    log_abs_det), elementwise."""
    cumwidths, widths, cumheights, heights, derivs = _compute_knots(uw, uh, ud, tail_bound)

    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    # Clamped for a safe gather; outside values are replaced at the end.
    x_safe = torch.clamp(inputs, -tail_bound, tail_bound)

    locate_in = cumheights if inverse else cumwidths
    idx = (locate_in[..., :-1] <= x_safe[..., None]).sum(dim=-1, keepdim=True) - 1
    idx = idx.clamp(0, widths.shape[-1] - 1)

    def take(a):
        return torch.gather(a, -1, idx)[..., 0]

    in_cw = take(cumwidths[..., :-1])
    in_w = take(widths)
    in_ch = take(cumheights[..., :-1])
    in_h = take(heights)
    d_k = take(derivs[..., :-1])
    d_k1 = take(derivs[..., 1:])
    s = in_h / in_w  # the bin's slope

    if not inverse:
        theta = (x_safe - in_cw) / in_w
        theta_1m = theta * (1 - theta)
        numerator = in_h * (s * theta**2 + d_k * theta_1m)
        denominator = s + (d_k1 + d_k - 2 * s) * theta_1m
        outputs = in_ch + numerator / denominator
        dnum = s**2 * (d_k1 * theta**2 + 2 * s * theta_1m + d_k * (1 - theta) ** 2)
        log_det = torch.log(dnum) - 2 * torch.log(denominator)
    else:
        y_rel = x_safe - in_ch
        a = in_h * (s - d_k) + y_rel * (d_k1 + d_k - 2 * s)
        b = in_h * d_k - y_rel * (d_k1 + d_k - 2 * s)
        c = -s * y_rel
        disc = torch.clamp(b**2 - 4 * a * c, min=0.0)
        root = (2 * c) / (-b - torch.sqrt(disc))
        outputs = root * in_w + in_cw
        theta_1m = root * (1 - root)
        denominator = s + (d_k1 + d_k - 2 * s) * theta_1m
        dnum = s**2 * (d_k1 * root**2 + 2 * s * theta_1m + d_k * (1 - root) ** 2)
        log_det = -(torch.log(dnum) - 2 * torch.log(denominator))

    outputs = torch.where(inside, outputs, inputs)
    log_det = torch.where(inside, log_det, torch.zeros_like(log_det))
    return outputs, log_det


class _ResidualBlock(nn.Module):
    def __init__(self, n_hidden, generator):
        super().__init__()
        self.l1 = Dense(n_hidden, n_hidden, generator)
        self.l2 = Dense(n_hidden, n_hidden, generator)


class _ResidualMLP(nn.Module):
    """Pre-activation residual MLP (spline.py:123-160): dense ``in``, then
    blocks h + l2(act(l1(act(h)))), then dense ``out``. The JAX tree's key
    ``in`` is a Python keyword: the layer is registered under that name
    (``add_module``), so its path stays ``net.in.w``."""

    def __init__(self, n_in, n_hidden, n_blocks, n_out, activation, generator=None):
        super().__init__()
        self.activation = activation
        self.add_module("in", Dense(n_in, n_hidden, generator))
        self.out = Dense(n_hidden, n_out, generator)
        self.blocks = nn.ModuleList(_ResidualBlock(n_hidden, generator) for _ in range(n_blocks))

    def forward(self, x):
        h = getattr(self, "in")(x)
        for block in self.blocks:
            h = h + block.l2(self.activation(block.l1(self.activation(h))))
        return self.out(h)


class CoupledRationalQuadraticSplineBijection(Bijection):
    """RQ-spline coupling over flat inputs with an alternating mask
    (spline.py:162-227): the even channels pass through (the odd ones with
    ``reverse_mask``) and a residual MLP of them gives the other half's
    spline parameters. The inverse is one pass, as the forward is.
    ``dropout_probability`` is accepted and unused, as in the JAX
    package."""

    def __init__(self, num_input_channels, num_hidden_layers, num_hidden_channels, num_bins, tail_bound,
                 activation, dropout_probability=0.0, reverse_mask=False, generator=None):
        shape = (num_input_channels,)
        super().__init__(x_shape=shape, z_shape=shape)
        self.num_bins = num_bins
        self.tail_bound = float(tail_bound)
        mask = np.zeros(num_input_channels, dtype=bool)
        mask[(1 if reverse_mask else 0) :: 2] = True  # the passthrough half
        pass_idx, mod_idx = np.nonzero(mask)[0], np.nonzero(~mask)[0]
        self.register_buffer("pass_idx", torch.as_tensor(pass_idx), persistent=False)
        self.register_buffer("mod_idx", torch.as_tensor(mod_idx), persistent=False)
        inv = np.argsort(np.concatenate([pass_idx, mod_idx]))
        self.register_buffer("inv_perm", torch.as_tensor(inv), persistent=False)
        self.n_mod = int(mod_idx.size)
        self.params_per_dim = 3 * num_bins - 1
        self.net = _ResidualMLP(n_in=int(pass_idx.size), n_hidden=num_hidden_channels, n_blocks=num_hidden_layers,
                                n_out=self.n_mod * self.params_per_dim, activation=activation, generator=generator)

    def _transform(self, x, inverse):
        passthrough, modified = x[:, self.pass_idx], x[:, self.mod_idx]
        raw = self.net(passthrough).reshape(x.shape[0], self.n_mod, self.params_per_dim)
        k = self.num_bins
        out, log_det = rational_quadratic_spline(modified, raw[..., :k], raw[..., k : 2 * k], raw[..., 2 * k :],
                                                 self.tail_bound, inverse=inverse)
        return torch.cat([passthrough, out], dim=1)[:, self.inv_perm], log_det.sum(dim=1)

    def forward(self, x):
        return self._transform(x, inverse=False)

    def inverse(self, z):
        return self._transform(z, inverse=True)


class AutoregressiveRationalQuadraticSplineBijection(Bijection):
    """Masked autoregressive RQ-spline transform (spline.py:230-283).
    Forward (x → z) is one pass of the masked net; the inverse is d
    sequential passes. ``dropout_probability`` is accepted and unused, as in
    the JAX package (its ``AutoregressiveMLP`` has no dropout)."""

    def __init__(self, num_input_channels, num_hidden_layers, num_hidden_channels, num_bins,
                 tail_bound, activation, dropout_probability=0.0, generator=None):
        shape = (num_input_channels,)
        super().__init__(x_shape=shape, z_shape=shape)
        self.d = num_input_channels
        self.num_bins = num_bins
        self.tail_bound = float(tail_bound)
        self.params_per_dim = 3 * num_bins - 1
        self.net = AutoregressiveMLP(
            n_in=num_input_channels,
            hidden=[num_hidden_channels] * max(1, num_hidden_layers),
            num_output_heads=self.params_per_dim,
            activation=activation,
            generator=generator,
        )

    def _spline_params(self, x):
        raw = self.net(x).transpose(1, 2)  # (B, d, P)
        k = self.num_bins
        return raw[..., :k], raw[..., k : 2 * k], raw[..., 2 * k :]

    def forward(self, x):
        z, log_det = rational_quadratic_spline(x, *self._spline_params(x), self.tail_bound)
        return z, log_det.sum(dim=1)

    def inverse(self, z):
        x = torch.zeros_like(z)
        log_det = torch.zeros_like(z)
        for _ in range(self.d):
            x, log_det = rational_quadratic_spline(z, *self._spline_params(x), self.tail_bound, inverse=True)
        return x, log_det.sum(dim=1)
