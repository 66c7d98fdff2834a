"""Coupler networks (``cmf_tpu/nets/core.py`` in torch): the flat MLP, the
masked autoregressive MLP of MADE and the AR spline, and the batchnorm-free
conv ResNet.

Weights keep the JAX package's layouts, so JAX weights load with no
transposes (``interop.py``): dense ``w`` of shape (in, out) applied as
``x @ w + b``; conv ``w`` of shape (O, I, kh, kw) (OIHW) over NCHW images.

``ResNet.forward`` routes the whole coupler through the fused coupler-stack
kernel (``ops/coupler_stack.py``) under ``torch.inference_mode()`` — the
sampling path — where the kernel takes the shape
(``coupler_kernel_available``), and through ``F.conv2d`` otherwise.
Inference mode, and not ``torch.is_grad_enabled()``, is the gate: the
Hutchinson solve's matvecs run without a graph but inside ``torch.func.jvp``
/ ``vjp``, which need the conv module's derivative rules, and ``torch.func``
transforms turn inference mode off inside them.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.coupler_stack import coupler_kernel_available, fused_resnet_coupler


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


class _Buffers(nn.Module):
    """A list of persistent buffers named ``0``, ``1``, ..., so a state
    list of the JAX package (``masks``) keeps its dotted paths."""

    def __init__(self, tensors):
        super().__init__()
        for i, t in enumerate(tensors):
            self.register_buffer(str(i), t)

    def __getitem__(self, i):
        return getattr(self, str(i))

    def __len__(self):
        return len(self._buffers)


class AutoregressiveMLP(nn.Module):
    """MADE-style masked MLP with ``num_output_heads`` stacked output heads
    (nets/core.py:335-374). Output shape (B, heads, D). The degrees and
    masks are exactly the JAX package's; the masks are persistent buffers
    (its ``state``), applied to the weights at every pass."""

    def __init__(self, n_in, hidden, num_output_heads, activation, generator=None):
        super().__init__()
        assert n_in >= 2
        assert all(n_in <= h for h in hidden), "Random degree init not implemented"
        self.n_in = n_in
        self.hidden = list(hidden)
        self.heads = num_output_heads
        self.activation = activation
        degrees = [np.arange(1, n_in + 1)]
        for h in self.hidden:
            degrees.append(np.arange(h) % (n_in - 1) + 1)
        degrees.append(np.tile(np.arange(n_in), num_output_heads))
        masks = [
            (degrees[i + 1][:, None] >= degrees[i][None, :]).astype(np.float32).T
            for i in range(len(degrees) - 1)
        ]  # (n_in_i, n_out_i), input-major to match x @ w
        self.layers = nn.ModuleList(Dense(m.shape[0], m.shape[1], generator) for m in masks)
        self.masks = _Buffers([torch.as_tensor(m) for m in masks])

    def forward(self, x):
        out = x
        for i, layer in enumerate(self.layers):
            out = out @ (layer.w * self.masks[i]) + layer.b
            if i < len(self.layers) - 1:
                out = self.activation(out)
        return out.reshape(x.shape[0], self.heads, self.n_in)


def _uniform(shape, bound, generator):
    return (torch.rand(*shape, generator=generator) * 2.0 - 1.0) * bound


class Conv(nn.Module):
    """``F.conv2d`` with SAME padding, weights as ``conv_init`` of the JAX
    package draws them: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for ``w``
    (O, I, k, k) and, where there is one, ``b`` (nets/core.py:75-84)."""

    def __init__(self, c_in, c_out, ksize, bias=True, generator=None):
        super().__init__()
        bound = 1.0 / np.sqrt(c_in * ksize * ksize)
        self.w = nn.Parameter(_uniform((c_out, c_in, ksize, ksize), bound, generator))
        self.b = nn.Parameter(_uniform((c_out,), bound, generator)) if bias else None

    def forward(self, x):
        return F.conv2d(x, self.w, self.b, padding=self.w.shape[-1] // 2)


class _ResidualBlock(nn.Module):
    """relu → conv3x3 → relu → conv3x3, plus the skip (nets/core.py:198-233),
    batchnorm-free."""

    def __init__(self, num_channels, generator=None):
        super().__init__()
        self.conv1 = Conv(num_channels, num_channels, 3, generator=generator)
        self.conv2 = Conv(num_channels, num_channels, 3, generator=generator)

    def forward(self, x):
        return x + self.conv2(torch.relu(self.conv1(torch.relu(x))))


class ResNet(nn.Module):
    """conv3x3 (bias-free) → residual blocks → relu → conv1x1, with the
    scaled-tanh head ``head_w·tanh(·) + head_b`` (nets/core.py:236-293).
    Batch-norm (``use_batchnorm=True``) waits for a later slice."""

    def __init__(self, c_in, hidden_channels, c_out, use_batchnorm=False, generator=None):
        super().__init__()
        if use_batchnorm:
            raise NotImplementedError(
                "the ResNet coupler with batch-norm waits for a later slice of the port (ROADMAP module 6)"
            )
        hidden = list(hidden_channels)
        self.c_hidden = hidden[0] if hidden else c_out
        assert all(c == self.c_hidden for c in hidden), "blocks of one width only"
        self.use_batchnorm = use_batchnorm
        self.conv_in = Conv(c_in, self.c_hidden, 3, bias=False, generator=generator)
        self.blocks = nn.ModuleList(_ResidualBlock(c, generator) for c in hidden)
        self.conv_out = Conv(self.c_hidden, c_out, 1, generator=generator)
        self.head_w = nn.Parameter(torch.ones(c_out, 1, 1))
        self.head_b = nn.Parameter(torch.zeros(c_out, 1, 1))

    def kernel_params(self):
        """The parameters as the JAX ``ResNet`` params tree, the layout
        ``fused_resnet_coupler`` takes."""
        return {
            "conv_in": {"w": self.conv_in.w},
            "blocks": [
                {"conv1": {"w": b.conv1.w, "b": b.conv1.b}, "conv2": {"w": b.conv2.w, "b": b.conv2.b}}
                for b in self.blocks
            ],
            "conv_out": {"w": self.conv_out.w, "b": self.conv_out.b},
            "head_w": self.head_w,
            "head_b": self.head_b,
        }

    def forward(self, x):
        if (
            torch.is_inference_mode_enabled()
            and not self.use_batchnorm
            and x.dtype == torch.float32
            and x.dim() == 4
            and coupler_kernel_available(x.shape[1], self.c_hidden, *x.shape[2:])
        ):
            return fused_resnet_coupler(x, self.kernel_params())
        out = self.conv_in(x)
        for block in self.blocks:
            out = block(out)
        out = self.conv_out(torch.relu(out))
        return self.head_w[None] * torch.tanh(out) + self.head_b[None]
