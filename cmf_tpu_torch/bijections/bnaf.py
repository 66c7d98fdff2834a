"""Block neural autoregressive flow (De Cao et al. 2019,
``cmf_tpu/bijections/bnaf.py`` in torch). Forward-only.

Each masked layer maps d·a_in → d·a_out with block-lower-triangular
weights: the diagonal blocks are exp-reparameterised (strictly positive) and
every row is weight-normalised. The log-jacobian of the whole map is
accumulated in log space, the layers' log diagonal blocks chained by
log-matmul-exp with the activations' log-derivatives added between layers;
after the last layer every block is 1×1 and log|det| = Σ_i (log J)_ii.

As in the JAX package (bnaf.py:115-118), a bool ``residual`` means no
residual: the reference passes ``res=True`` into a BNAF package that only
recognises the strings "normal" and "gated", so the flag does nothing
there. The strings select the real residual modes.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .base import Bijection


def _logmatmulexp(a, b):
    """log(exp(a) @ exp(b)) over the last two axes, stably (bnaf.py:31-42):
    a (..., m, k), b (..., k, n) → (..., m, n). The ``1e-38`` the JAX
    package adds inside the log is subnormal in fp32: it changes a value
    only where a row's exp-sum underflows to zero."""
    a_max = torch.amax(a, dim=-1, keepdim=True)
    b_max = torch.amax(b, dim=-2, keepdim=True)
    out = torch.log(torch.exp(a - a_max) @ torch.exp(b - b_max) + 1e-38)
    return out + a_max + b_max.transpose(-1, -2)


class _MaskedBlockWeight(nn.Module):
    """One masked layer, d·a_in → d·a_out (bnaf.py:45-87): params
    ``weight`` (d·a_out, d·a_in), ``diag_weight`` (d·a_out, 1) and ``bias``;
    the block-diagonal and strictly-lower block masks are non-persistent
    buffers (static in the JAX package, not in its state)."""

    def __init__(self, in_features, out_features, dim, generator=None):
        super().__init__()
        assert in_features % dim == 0 and out_features % dim == 0
        self.n_in, self.n_out, self.dim = in_features, out_features, dim
        self.a_in = in_features // dim
        self.a_out = out_features // dim
        mask_d = np.zeros((out_features, in_features), np.float32)
        mask_o = np.zeros((out_features, in_features), np.float32)
        for i in range(dim):
            mask_d[i * self.a_out : (i + 1) * self.a_out, i * self.a_in : (i + 1) * self.a_in] = 1
            mask_o[i * self.a_out : (i + 1) * self.a_out, : i * self.a_in] = 1
        self.register_buffer("mask_d", torch.as_tensor(mask_d), persistent=False)
        self.register_buffer("mask_o", torch.as_tensor(mask_o), persistent=False)
        bound = 1.0 / np.sqrt(in_features)

        def uniform(shape, low, high):
            return low + (high - low) * torch.rand(*shape, generator=generator)

        self.weight = nn.Parameter(uniform((out_features, in_features), -bound, bound))
        self.diag_weight = nn.Parameter(torch.log(uniform((out_features, 1), 0.5, 1.0)))
        self.bias = nn.Parameter(uniform((out_features,), -bound, bound))

    def forward(self, x):
        """(y, log diagonal blocks (d, a_out, a_in))."""
        w_tilde = torch.exp(self.weight) * self.mask_d + self.weight * self.mask_o
        sq_norm = (w_tilde**2).sum(dim=-1, keepdim=True)
        w = torch.exp(self.diag_weight) * w_tilde / torch.sqrt(sq_norm)
        # The log of the diagonal blocks' entries, positive by construction.
        wpl = self.diag_weight + self.weight - 0.5 * torch.log(sq_norm)
        y = x @ w.T + self.bias
        # Block i's rows against its own columns: the diagonal of the
        # (d, a_out, d, a_in) view over the two d axes, one strided view
        # where the JAX package stacks d slices.
        blocks = wpl.reshape(self.dim, self.a_out, self.dim, self.a_in)
        return y, torch.diagonal(blocks, dim1=0, dim2=2).permute(2, 0, 1)


_LOG2 = float(np.log(2.0))


def _soft_leaky_relu(x, eps=0.01):
    return eps * x + (1 - eps) * F.softplus(x), torch.log(eps + (1 - eps) * torch.sigmoid(x))


def _tanh_act(x):
    return torch.tanh(x), 2.0 * (_LOG2 - x - F.softplus(-2.0 * x))


def _leaky_relu(x, eps=0.01):
    return F.leaky_relu(x, eps), (x < 0).to(x.dtype) * float(np.log(eps))


_ACTIVATIONS = {
    "soft-leaky-relu": _soft_leaky_relu,
    "tanh": _tanh_act,
    "leaky-relu": _leaky_relu,
}


class BlockNeuralAutoregressiveBijection(Bijection):
    """Params ``layers.<i>.weight|diag_weight|bias``, and ``gate`` (0-d,
    zero at init) only for ``residual="gated"`` (bnaf.py:110-132)."""

    def __init__(self, num_input_channels, num_hidden_layers, hidden_channels_factor, activation, residual,
                 generator=None):
        shape = (num_input_channels,)
        super().__init__(x_shape=shape, z_shape=shape)
        self.d = num_input_channels
        self.activation = _ACTIVATIONS[activation]
        self.res = residual if isinstance(residual, str) else None
        d = num_input_channels
        h = d * hidden_channels_factor
        sizes = [d] + [h] * (num_hidden_layers + 1) + [d]
        self.layers = nn.ModuleList(
            _MaskedBlockWeight(a, b, d, generator) for a, b in zip(sizes[:-1], sizes[1:])
        )
        if self.res == "gated":
            self.gate = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        bsz = x.shape[0]
        out = x
        grad = None  # (B, d, a_out, 1): log of the chained diagonal blocks
        for i, layer in enumerate(self.layers):
            out, log_diag = layer(out)
            # The blocks are the same for every row of the batch: chained to
            # the batched product by broadcasting, not copied B times.
            grad = log_diag.expand(bsz, *log_diag.shape) if grad is None else _logmatmulexp(log_diag, grad)
            if i < len(self.layers) - 1:
                out, act_lj = self.activation(out)
                # The activation's derivative is diagonal: in log space it is
                # added to every row of the chained block.
                grad = grad + act_lj.reshape(bsz, self.d, layer.a_out, 1)
        log_j = grad.reshape(bsz, self.d)
        if self.res == "normal":
            return x + out, F.softplus(log_j).sum(dim=-1)
        if self.res == "gated":
            gate = torch.sigmoid(self.gate)
            log_jac = torch.logaddexp(log_j + torch.log(gate), torch.log(1 - gate)).sum(dim=-1)
            return gate * out + (1 - gate) * x, log_jac
        return out, log_j.sum(dim=-1)

    def inverse(self, z):
        raise NotImplementedError("BNAF has no analytic inverse")
