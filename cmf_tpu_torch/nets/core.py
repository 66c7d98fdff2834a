"""Coupler networks (``cmf_tpu/nets/core.py`` in torch): the constant and
identity nets, the flat MLP, the masked autoregressive MLP of MADE, sos and
the AR spline, the conv ResNet with or without batch-norm, and GlowCNN.

Weights keep the JAX package's layouts, so JAX weights load with no
transposes (``interop.py``): dense ``w`` of shape (in, out) applied as
``x @ w + b``; conv ``w`` of shape (O, I, kh, kw) (OIHW) over NCHW images.

``ResNet.forward`` routes the whole coupler through the fused coupler-stack
kernel (``ops/coupler_stack.py``) under ``torch.inference_mode()`` — the
sampling path — where the net has no batch-norm and the kernel takes the
shape (``coupler_kernel_available``), and through ``F.conv2d`` otherwise.
Inference mode, and not ``torch.is_grad_enabled()``, is the gate: the
Hutchinson solve's matvecs run without a graph but inside ``torch.func.jvp``
/ ``vjp``, which need the conv module's derivative rules, and ``torch.func``
transforms turn inference mode off inside them.

Batch-norm (``BatchNorm2d``) follows the JAX package's per-call ``train``
flag through one switch: inside ``batch_statistics(module)`` every
batch-norm layer of ``module`` normalises by the batch's statistics and
moves its running ones; everywhere else it normalises by the running ones.
The trainer's step is the one caller that turns it on, as the JAX trainer's
step is the one that passes ``train=True`` (trainer.py:141-146).
"""

import contextlib

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


class ConstantNetwork(nn.Module):
    """A constant output of ``shape`` a row, whatever the input
    (nets/core.py:110-126): ``value`` is a parameter, or with ``fixed`` a
    persistent buffer (the JAX net's state)."""

    def __init__(self, shape, value=0.0, fixed=False):
        super().__init__()
        self.shape = tuple(shape)
        self.fixed = fixed
        v = torch.full(self.shape, float(value))
        if fixed:
            self.register_buffer("value", v)
        else:
            self.value = nn.Parameter(v)

    def forward(self, x):
        return self.value.expand(x.shape[0], *self.shape)


class IdentityNetwork(nn.Module):
    """The input itself (nets/core.py:129-134)."""

    def forward(self, x):
        return x


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


class BatchNorm2d(nn.Module):
    """NCHW batch-norm with running statistics (nets/core.py:161-195):
    ``scale`` and ``bias`` parameters, ``mean`` and ``var`` persistent
    buffers (the JAX layer's state), momentum 0.1, eps 1e-5.

    Inside ``batch_statistics`` it normalises by the batch's mean and
    *biased* variance, as ``jnp.var`` gives them, and moves the running
    statistics by the same biased variance (``F.batch_norm`` would move
    ``running_var`` by the unbiased one, n/(n−1) larger). With ``detach``
    no gradient flows through the batch statistics. A layer whose
    ``updates_running`` is off normalises by the batch all the same but
    leaves its running statistics where they were: the conditional
    Gaussians of a CIF layer, whose state the JAX package's ``ELBODensity``
    hands back unchanged (elbo.py:36-41). Outside the switch it normalises
    by the running statistics."""

    def __init__(self, num_channels, momentum=0.1, eps=1e-5, detach=False):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.detach = detach
        self.batch_stats = False
        self.updates_running = True
        self.scale = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.register_buffer("mean", torch.zeros(num_channels))
        self.register_buffer("var", torch.ones(num_channels))

    def forward(self, x):
        if self.batch_stats:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            if self.detach:
                mean, var = mean.detach(), var.detach()
            if self.updates_running:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_((1 - m) * self.mean + m * mean.detach())
                    self.var.copy_((1 - m) * self.var + m * var.detach())
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps)[None, :, None, None]
        out = (x - mean[None, :, None, None]) * inv
        return out * self.scale[None, :, None, None] + self.bias[None, :, None, None]


@contextlib.contextmanager
def batch_statistics(module):
    """Every batch-norm layer of ``module`` (``BatchNorm2d`` and
    ``bijections.BatchNormBijection``: each module with a ``batch_stats``
    switch) normalises by the batch for the length of the block: the JAX
    package's ``train=True``."""
    layers = [m for m in module.modules() if hasattr(m, "batch_stats")]
    before = [m.batch_stats for m in layers]
    for m in layers:
        m.batch_stats = True
    try:
        yield
    finally:
        for m, b in zip(layers, before):
            m.batch_stats = b


class _ResidualBlock(nn.Module):
    """[BN] → relu → conv3x3 → [BN] → relu → conv3x3, plus the skip
    (nets/core.py:198-233); with batch-norm the convs have no bias."""

    def __init__(self, num_channels, use_batchnorm=False, detach_bn=False, generator=None):
        super().__init__()
        bias = not use_batchnorm
        self.conv1 = Conv(num_channels, num_channels, 3, bias=bias, generator=generator)
        self.conv2 = Conv(num_channels, num_channels, 3, bias=bias, generator=generator)
        self.use_batchnorm = use_batchnorm
        if use_batchnorm:
            self.bn1 = BatchNorm2d(num_channels, detach=detach_bn)
            self.bn2 = BatchNorm2d(num_channels, detach=detach_bn)

    def forward(self, x):
        if not self.use_batchnorm:
            return x + self.conv2(torch.relu(self.conv1(torch.relu(x))))
        out = self.conv1(torch.relu(self.bn1(x)))
        return x + self.conv2(torch.relu(self.bn2(out)))


class ResNet(nn.Module):
    """conv3x3 (bias-free) → residual blocks → [BN] → relu → conv1x1, with
    the scaled-tanh head ``head_w·tanh(·) + head_b`` (nets/core.py:236-293).
    With ``use_batchnorm`` every block and the output carry a
    ``BatchNorm2d`` (``detach_bn``: no gradient through the batch
    statistics); such a net never takes the coupler kernel, which is
    batch-norm-free as the JAX package's is."""

    def __init__(self, c_in, hidden_channels, c_out, use_batchnorm=False, detach_bn=False, generator=None):
        super().__init__()
        hidden = list(hidden_channels)
        self.c_hidden = hidden[0] if hidden else c_out
        assert all(c == self.c_hidden for c in hidden), "blocks of one width only"
        self.use_batchnorm = use_batchnorm
        self.conv_in = Conv(c_in, self.c_hidden, 3, bias=False, generator=generator)
        self.blocks = nn.ModuleList(
            _ResidualBlock(c, use_batchnorm, detach_bn, generator) for c in hidden
        )
        if use_batchnorm:
            self.out_bn = BatchNorm2d(self.c_hidden, detach=detach_bn)
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
        if self.use_batchnorm:
            out = self.out_bn(out)
        out = self.conv_out(torch.relu(out))
        return self.head_w[None] * torch.tanh(out) + self.head_b[None]


class GlowCNN(nn.Module):
    """conv3x3 → BN → relu → conv1x1 → BN → relu → conv3x3 (nets/core.py:
    296-333): the first two convs bias-free, the last with a bias, both of
    its tensors zero at init under ``zero_init_output``. Batch-norm is
    always on."""

    def __init__(self, c_in, c_hidden, c_out, zero_init_output=True, generator=None):
        super().__init__()
        self.conv1 = Conv(c_in, c_hidden, 3, bias=False, generator=generator)
        self.conv2 = Conv(c_hidden, c_hidden, 1, bias=False, generator=generator)
        self.conv3 = Conv(c_hidden, c_out, 3, generator=generator)
        if zero_init_output:
            with torch.no_grad():
                self.conv3.w.zero_()
                self.conv3.b.zero_()
        self.bn1 = BatchNorm2d(c_hidden)
        self.bn2 = BatchNorm2d(c_hidden)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        return self.conv3(out)
