"""Plain PyTorch reference of the canonical manifold flow (CMF; Flouris and
Konukoglu, arXiv:2310.12743) as the benchmark's configurations state it.

Written from the published description, with nothing of the program under
test: a non-square flow encodes x through a chain of affine couplings
(on the modified part, z = (x + t)·exp(s); the inverse x = z·exp(−s) − t),
keeps d coordinates of the result (a fixed permutation, then the first d),
and models them with a low-dimensional RealNVP over a standard Gaussian. The
decoder zero-pads the d coordinates, undoes the permutation and inverts the
chain. Its loss is −mean(w·(log p(z) − ½·log|JᵀJ|) − λ·‖decode(z) − x‖²),
J the decoder's D×d Jacobian at z.

Each configuration file's ``architecture`` lists the layers in the order
they act on x; the widths are the configuration's own keys. Couplers are a
tanh MLP (flat data) or a ResNet (images: 3×3 conv, residual blocks of
relu → 3×3 conv → relu → 3×3 conv, relu → 1×1 conv, the head
``head_w·tanh(·) + head_b``); the first half of a coupler's output channels
is the shift t, the second the log-scale s.

``Arith`` holds the two operations whose precision the comparison is about:
``FP32`` computes in float32 (TF32 off), ``TF32`` rounds both operands of
every matrix product and convolution to TF32 (10 mantissa bits, nearest
even) first, and its gradients likewise: the tensor cores' TF32 arithmetic,
the same on any device.
"""

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


def pin_fp32():
    """float32 matmuls and convolutions, with no TF32 substituted."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(t):
    """``t`` rounded to TF32: 10 mantissa bits, to nearest, ties to even."""
    i = t.detach().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & -8192).view(torch.float32).view(t.shape)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        ga = rg @ rb.mT
        gb = ra.mT @ rg
        if gb.dim() > rb.dim():
            gb = gb.sum(dim=tuple(range(gb.dim() - rb.dim())))
        return ga, gb


@dataclass(frozen=True)
class Arith:
    name: str

    def mm(self, a, b):
        if self.name == "tf32":
            return _TF32MatMul.apply(a, b)
        return a @ b

    def conv(self, x, w, b, padding):
        if self.name == "tf32":
            x, w = round_tf32(x), round_tf32(w)
        out = F.conv2d(x, w, None, padding=padding)
        return out if b is None else out + b[None, :, None, None]


FP32 = Arith("fp32")
TF32 = Arith("tf32")


# ------------------------------------------------------------ parameters
def alternating_halves(n, reverse):
    """(passthrough, modified) indices: even positions pass (odd when
    ``reverse``)."""
    passed = list(range(1 if reverse else 0, n, 2))
    modified = [i for i in range(n) if i not in set(passed)]
    return passed, modified


def split_channel_sizes(c, reverse):
    """(passthrough, modified) channel counts: the first half passes (the
    last, and the larger of an odd count, when ``reverse``)."""
    n_pass = c // 2 if not reverse else c - c // 2
    return n_pass, c - n_pass


def mlp_specs(sizes):
    """(leaf, shape, offset, scale) of a dense stack, layer by layer: w of
    (in, out) and b, both U(−1/√in, 1/√in)."""
    out = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        bound = 1.0 / math.sqrt(a)
        out += [("w", (a, b), 0.0, bound), ("b", (b,), 0.0, bound)]
    return out


def resnet_specs(c_in, c_out, hidden, blocks):
    """The ResNet coupler's leaves in the order it holds them: the head,
    the input conv (no bias), each block's two convs, the output conv. Conv
    weights and biases U(−1/√fan_in, 1/√fan_in); the head near identity
    (head_w 1 ± 0.1, head_b ± 0.1), so every coupling moves its input by an
    O(1) factor."""
    b3 = 1.0 / math.sqrt(9 * hidden)
    out = [("head_w", (c_out, 1, 1), 1.0, 0.1), ("head_b", (c_out, 1, 1), 0.0, 0.1),
           ("w", (hidden, c_in, 3, 3), 0.0, 1.0 / math.sqrt(9 * c_in))]
    for _ in range(blocks):
        out += [("w", (hidden, hidden, 3, 3), 0.0, b3), ("b", (hidden,), 0.0, b3)] * 2
    bo = 1.0 / math.sqrt(hidden)
    return out + [("w", (c_out, hidden, 1, 1), 0.0, bo), ("b", (c_out,), 0.0, bo)]


def couplers(cfgfile):
    """Each coupling of the configuration, x-space chain first, then the
    latent prior, in the order the layers act on x: (layer, net, spec list,
    shape the layer sees)."""
    arch, cfg = cfgfile["architecture"], cfgfile["config"]
    shape = tuple(arch["x_shape"])
    out = []
    for layer in arch["x_layers"]:
        kind = layer["type"]
        if kind == "squeeze":
            c, h, w = shape
            shape = (4 * c, h // 2, w // 2)
        elif kind == "split":
            shape = (shape[0] // 2, *shape[1:])
        elif kind == "alternating":
            passed, modified = alternating_halves(shape[0], layer["reverse"])
            sizes = [len(passed), *cfg[arch["x_hidden_key"]], 2 * len(modified)]
            out.append((layer, "mlp", mlp_specs(sizes), shape))
        else:
            c = shape[0]
            if kind == "checkerboard":
                c_in, c_out = c, 2 * c
            else:
                n_pass, n_mod = split_channel_sizes(c, layer["reverse"])
                c_in, c_out = n_pass, 2 * n_mod
            hidden = cfg[arch["x_hidden_key"]]
            out.append((layer, "resnet", resnet_specs(c_in, c_out, hidden[0], len(hidden)), shape))
    d = cfg["latent_dimension"]
    for i in range(cfg["prior_num_density_layers"]):
        layer = {"type": "alternating", "reverse": i % 2 == 1}
        passed, modified = alternating_halves(d, layer["reverse"])
        sizes = [len(passed), *cfg["prior_hidden_channels"], 2 * len(modified)]
        out.append((layer, "mlp", mlp_specs(sizes), (d,)))
    return out


def tail_shape(cfgfile):
    """The shape the chain hands the tail, whose d coordinates it keeps."""
    arch = cfgfile["architecture"]
    shape = tuple(arch["x_shape"])
    for layer in arch["x_layers"]:
        if layer["type"] == "squeeze":
            c, h, w = shape
            shape = (4 * c, h // 2, w // 2)
        elif layer["type"] == "split":
            shape = (shape[0] // 2, *shape[1:])
    return shape


def param_specs(cfgfile):
    """Every leaf, (leaf, shape, offset, scale), in the order the
    configuration's layers act on x."""
    return [s for _, _, specs, _ in couplers(cfgfile) for s in specs]


def permutation_size(cfgfile):
    return math.prod(tail_shape(cfgfile))


class Params:
    """The flat list of leaves, handed out coupling by coupling."""

    def __init__(self, cfgfile, tensors):
        self.layers = []
        i = 0
        for layer, net, specs, shape in couplers(cfgfile):
            leaves = tensors[i : i + len(specs)]
            i += len(specs)
            self.layers.append((layer, net, leaves, shape))
        assert i == len(tensors), (i, len(tensors))
        n_x = sum(1 for layer in cfgfile["architecture"]["x_layers"]
                  if layer["type"] not in ("squeeze", "split"))
        self.x = self.layers[:n_x]
        self.prior = self.layers[n_x:]


# ------------------------------------------------------------ couplers
def mlp(leaves, x, arith):
    n = len(leaves) // 2
    for i in range(n):
        x = arith.mm(x, leaves[2 * i]) + leaves[2 * i + 1]
        if i < n - 1:
            x = torch.tanh(x)
    return x


def mlp_jvp(leaves, x, dx, arith):
    """The MLP's output at x (B, n) and its pushforward of the tangents
    dx (B, k, n)."""
    n = len(leaves) // 2
    batch, k = dx.shape[:2]
    for i in range(n):
        w, b = leaves[2 * i], leaves[2 * i + 1]
        x = arith.mm(x, w) + b
        dx = arith.mm(dx.reshape(batch * k, -1), w).reshape(batch, k, -1)
        if i < n - 1:
            x = torch.tanh(x)
            dx = dx * (1 - x * x)[:, None, :]
    return x, dx


def resnet(leaves, x, arith):
    head_w, head_b, w_in = leaves[:3]
    blocks = leaves[3:-2]
    out = arith.conv(x, w_in, None, 1)
    for j in range(0, len(blocks), 4):
        w1, b1, w2, b2 = blocks[j : j + 4]
        out = out + arith.conv(torch.relu(arith.conv(torch.relu(out), w1, b1, 1)), w2, b2, 1)
    out = arith.conv(torch.relu(out), leaves[-2], leaves[-1], 0)
    return head_w[None] * torch.tanh(out) + head_b[None]


def _halves(out):
    c = out.shape[1] // 2
    return out[:, :c], out[:, c:]


# ------------------------------------------------------------ flat chain
def flat_forward(layer, leaves, x, arith):
    """An alternating coupling on flat rows: (z, Σ s)."""
    passed, modified = alternating_halves(x.shape[1], layer["reverse"])
    t, s = _halves(mlp(leaves, x[:, passed], arith))
    z = torch.empty_like(x)
    z[:, passed] = x[:, passed]
    z[:, modified] = (x[:, modified] + t) * torch.exp(s)
    return z, s.sum(dim=1)


def flat_inverse(layer, leaves, z, arith, dz=None):
    """The coupling's inverse on flat rows and, with tangents dz (B, k, n),
    their pushforward."""
    passed, modified = alternating_halves(z.shape[1], layer["reverse"])
    x = torch.empty_like(z)
    x[:, passed] = z[:, passed]
    if dz is None:
        t, s = _halves(mlp(leaves, z[:, passed], arith))
        x[:, modified] = z[:, modified] * torch.exp(-s) - t
        return x, None
    out, dout = mlp_jvp(leaves, z[:, passed], dz[:, :, passed], arith)
    n_mod = len(modified)
    t, s = out[:, :n_mod], out[:, n_mod:]
    dt, ds = dout[:, :, :n_mod], dout[:, :, n_mod:]
    e = torch.exp(-s)
    x[:, modified] = z[:, modified] * e - t
    dx = torch.empty_like(dz)
    dx[:, :, passed] = dz[:, :, passed]
    dx[:, :, modified] = (dz[:, :, modified] - z[:, None, modified] * ds) * e[:, None, :] - dt
    return x, dx


def gaussian_log_prob(u):
    return -0.5 * u.shape[1] * math.log(2 * math.pi) - 0.5 * (u * u).sum(dim=1)


def prior_log_prob(params, low, arith):
    """log p(low) under the latent RealNVP over a standard Gaussian."""
    log_jac = torch.zeros(low.shape[0], dtype=low.dtype, device=low.device)
    u = low
    for layer, _, leaves, _ in params.prior:
        u, lj = flat_forward(layer, leaves, u, arith)
        log_jac = log_jac + lj
    return gaussian_log_prob(u) + log_jac


def prior_sample(params, eps, arith):
    u = eps
    for layer, _, leaves, _ in reversed(params.prior):
        u, _ = flat_inverse(layer, leaves, u, arith)
    return u


# ------------------------------------------------------------ image chain
def checkerboard_mask(h, w, reverse, like):
    i = torch.arange(h, device=like.device)[:, None]
    j = torch.arange(w, device=like.device)[None, :]
    m = ((i + j) % 2 == 1).to(like.dtype)
    return (1 - m if reverse else m)[None, None]


def image_inverse(layer, leaves, z, arith):
    kind, reverse = layer["type"], layer.get("reverse", False)
    if kind == "checkerboard":
        m = checkerboard_mask(z.shape[2], z.shape[3], reverse, z)
        t, s = _halves(resnet(leaves, m * z, arith))
        return m * z + (1 - m) * (z * torch.exp(-s) - t)
    n_pass, _ = split_channel_sizes(z.shape[1], reverse)
    cut = z.shape[1] - n_pass if reverse else n_pass
    first, second = z[:, :cut], z[:, cut:]
    passed, modified = (second, first) if reverse else (first, second)
    t, s = _halves(resnet(leaves, passed, arith))
    modified = modified * torch.exp(-s) - t
    return torch.cat([modified, passed] if reverse else [passed, modified], dim=1)


def unsqueeze(z):
    b, c, h, w = z.shape
    x = z.reshape(b, c // 4, 2, 2, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, c // 4, 2 * h, 2 * w)


def tail_decode(low, perm, shape):
    """Zero-pad the d coordinates, undo the permutation, reshape."""
    batch, d = low.shape
    padded = torch.cat([low, low.new_zeros(batch, perm.numel() - d)], dim=1)
    return padded[:, torch.argsort(perm)].reshape(batch, *shape)


def image_decode(cfgfile, params, low, perm, arith):
    """The decoder of an image chain: tail, then each layer's inverse from
    the last to the first, then the inverse of the input's preprocessing."""
    y = tail_decode(low, perm, tail_shape(cfgfile))
    couplings = iter(reversed(params.x))
    for layer in reversed(cfgfile["architecture"]["x_layers"]):
        if layer["type"] == "split":
            y = torch.cat([y, torch.zeros_like(y)], dim=1)
        elif layer["type"] == "squeeze":
            y = unsqueeze(y)
        else:
            _, _, leaves, _ = next(couplings)
            y = image_inverse(layer, leaves, y, arith)
    for step in reversed(cfgfile["architecture"]["preprocessing"]):
        if step["type"] == "logit":
            y = torch.sigmoid(y)
        elif step["type"] == "scalar-add":
            y = y - step["value"]
        elif step["type"] == "scalar-mult":
            y = y / step["value"]
        else:
            raise ValueError(f"unknown preprocessing step {step['type']}")
    return y
