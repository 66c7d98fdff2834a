"""The FID InceptionV3 (pool3, 2048 features) as an ``nn.Module``
(``cmf_tpu/eval/inception_jax.py`` in torch).

The pytorch-fid variant of the network: ``BasicConv2d`` is a bias-free conv,
batch-norm with eps 1e-3 from frozen statistics, and a relu
(inception_jax.py:19-34); the average pools of blocks A, C and E leave the
padding out of their counts, and the last E block max-pools 3×3 at stride 1
(``FIDInceptionE_2``, :118-123); the features are the global mean of the
last block (:128-148). Stride-1 convolutions pad as XLA's SAME does for odd
kernels (half the kernel on each side); the strided ones pad nothing.

The weights are buffers named as the torch state_dict keys
(``state_dict_spec``), so a state_dict of numpy arrays loads as it is.
``load_feature_fn`` adds the JAX package's pre-processing (:158-174): /255,
a 1→3 channel tile, a bilinear resize to 299×299 (half-pixel centres, no
antialiasing: ``jax.image.resize`` upsampling) and 2x − 1. Its stamp is
``inception-jax``, the JAX package's name for the same weights through the
same graph.

Numpy copies of ``convert_torch_weights``, ``state_dict_spec``,
``validate_params`` and ``random_state_dict`` (:177-312) sit beside it.
"""

from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


class _Conv(nn.Module):
    def __init__(self, c_out, c_in, kh, kw):
        super().__init__()
        self.register_buffer("weight", torch.empty(c_out, c_in, kh, kw))


class _BatchNorm(nn.Module):
    def __init__(self, c):
        super().__init__()
        for name in ("weight", "bias", "running_mean", "running_var"):
            self.register_buffer(name, torch.empty(c))


class BasicConv2d(nn.Module):
    """conv (no bias) → batch-norm (eps 1e-3, frozen statistics) → relu."""

    def __init__(self, c_in, c_out, kernel, stride=1, padding="same"):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.conv = _Conv(c_out, c_in, kh, kw)
        self.bn = _BatchNorm(c_out)
        self.stride = stride
        self.padding = (kh // 2, kw // 2) if padding == "same" else (0, 0)

    def forward(self, x):
        out = F.conv2d(x, self.conv.weight, stride=self.stride, padding=self.padding)
        bn = self.bn
        out = F.batch_norm(out, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                           training=False, eps=BN_EPS)
        return torch.relu(out)


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)


def _avg_pool_same(x):
    """3×3 stride-1 average pool, padding left out of the counts."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, c_in, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 64, 1)
        self.branch5x5_1 = BasicConv2d(c_in, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3)
        self.branch_pool = BasicConv2d(c_in, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, c_in):
        super().__init__()
        self.branch3x3 = BasicConv2d(c_in, 384, 3, stride=2, padding="valid")
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2, padding="valid")

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, c_in, c7):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1))
        self.branch7x7dbl_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                      self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, c_in):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2, padding="valid")
        self.branch7x7x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2, padding="valid")

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, c_in, last=False):
        super().__init__()
        self.last = last
        self.branch1x1 = BasicConv2d(c_in, 320, 1)
        self.branch3x3_1 = BasicConv2d(c_in, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1))
        self.branch3x3dbl_1 = BasicConv2d(c_in, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        # FIDInceptionE_2: the last block max-pools (padding is -inf).
        pooled = F.max_pool2d(x, 3, 1, 1) if self.last else _avg_pool_same(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], dim=1)


class InceptionV3(nn.Module):
    """(B, 3, 299, 299) in [-1, 1] → (B, 2048) pool3 features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2, padding="valid")
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, padding="valid")
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, padding="valid")
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, last=True)

    @classmethod
    def from_state_dict(cls, arrays):
        """The network with ``arrays`` ({key: numpy array}, every key of
        ``state_dict_spec``) as its weights, on the CPU."""
        validate_params(arrays)
        model = cls()
        model.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in arrays.items()})
        return model.eval()

    def forward(self, x):
        out = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        out = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(out)))
        out = _max_pool(out)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                      self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                      self.Mixed_7c):
            out = block(out)
        return out.mean(dim=(2, 3))


class InceptionFeatures(nn.Module):
    """The JAX package's pipeline around the network: (B, C, H, W) in
    [0, 256) → (B, 2048)."""

    extractor_kind = "inception-jax"

    def __init__(self, network):
        super().__init__()
        self.network = network

    def forward(self, x):
        x = x / 255.0
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False, antialias=False)
        return self.network(2.0 * x - 1.0)


def load_feature_fn(npz_path, device="cpu"):
    """The feature function of the weights at ``npz_path`` (the JAX
    package's ``.npz`` layout), on ``device``."""
    from ..interop import inception_from_npz

    return InceptionFeatures(inception_from_npz(npz_path)).to(device)


def convert_torch_weights(state_dict_path, out_npz):
    """A pytorch-fid InceptionV3 state_dict (.pth) → the ``.npz`` layout."""
    sd = torch.load(state_dict_path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    arrays = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked") or k.startswith(("AuxLogits", "fc")):
            continue
        arrays[k] = v.numpy()
    validate_params(arrays)
    np.savez(out_npz, **arrays)
    return out_npz


def state_dict_spec():
    """Every state_dict key of the feature path → its shape (torchvision's
    channel plan; AuxLogits and fc left out)."""
    spec = OrderedDict()

    def cb(name, o, i, kh, kw):
        spec[f"{name}.conv.weight"] = (o, i, kh, kw)
        for suf in ("weight", "bias", "running_mean", "running_var"):
            spec[f"{name}.bn.{suf}"] = (o,)

    cb("Conv2d_1a_3x3", 32, 3, 3, 3)
    cb("Conv2d_2a_3x3", 32, 32, 3, 3)
    cb("Conv2d_2b_3x3", 64, 32, 3, 3)
    cb("Conv2d_3b_1x1", 80, 64, 1, 1)
    cb("Conv2d_4a_3x3", 192, 80, 3, 3)

    for name, in_ch, pool in (("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64),
                              ("Mixed_5d", 288, 64)):
        cb(f"{name}.branch1x1", 64, in_ch, 1, 1)
        cb(f"{name}.branch5x5_1", 48, in_ch, 1, 1)
        cb(f"{name}.branch5x5_2", 64, 48, 5, 5)
        cb(f"{name}.branch3x3dbl_1", 64, in_ch, 1, 1)
        cb(f"{name}.branch3x3dbl_2", 96, 64, 3, 3)
        cb(f"{name}.branch3x3dbl_3", 96, 96, 3, 3)
        cb(f"{name}.branch_pool", pool, in_ch, 1, 1)

    cb("Mixed_6a.branch3x3", 384, 288, 3, 3)
    cb("Mixed_6a.branch3x3dbl_1", 64, 288, 1, 1)
    cb("Mixed_6a.branch3x3dbl_2", 96, 64, 3, 3)
    cb("Mixed_6a.branch3x3dbl_3", 96, 96, 3, 3)

    for name, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
                     ("Mixed_6e", 192)):
        cb(f"{name}.branch1x1", 192, 768, 1, 1)
        cb(f"{name}.branch7x7_1", c7, 768, 1, 1)
        cb(f"{name}.branch7x7_2", c7, c7, 1, 7)
        cb(f"{name}.branch7x7_3", 192, c7, 7, 1)
        cb(f"{name}.branch7x7dbl_1", c7, 768, 1, 1)
        cb(f"{name}.branch7x7dbl_2", c7, c7, 7, 1)
        cb(f"{name}.branch7x7dbl_3", c7, c7, 1, 7)
        cb(f"{name}.branch7x7dbl_4", c7, c7, 7, 1)
        cb(f"{name}.branch7x7dbl_5", 192, c7, 1, 7)
        cb(f"{name}.branch_pool", 192, 768, 1, 1)

    cb("Mixed_7a.branch3x3_1", 192, 768, 1, 1)
    cb("Mixed_7a.branch3x3_2", 320, 192, 3, 3)
    cb("Mixed_7a.branch7x7x3_1", 192, 768, 1, 1)
    cb("Mixed_7a.branch7x7x3_2", 192, 192, 1, 7)
    cb("Mixed_7a.branch7x7x3_3", 192, 192, 7, 1)
    cb("Mixed_7a.branch7x7x3_4", 192, 192, 3, 3)

    for name, in_ch in (("Mixed_7b", 1280), ("Mixed_7c", 2048)):
        cb(f"{name}.branch1x1", 320, in_ch, 1, 1)
        cb(f"{name}.branch3x3_1", 384, in_ch, 1, 1)
        cb(f"{name}.branch3x3_2a", 384, 384, 1, 3)
        cb(f"{name}.branch3x3_2b", 384, 384, 3, 1)
        cb(f"{name}.branch3x3dbl_1", 448, in_ch, 1, 1)
        cb(f"{name}.branch3x3dbl_2", 384, 448, 3, 3)
        cb(f"{name}.branch3x3dbl_3a", 384, 384, 1, 3)
        cb(f"{name}.branch3x3dbl_3b", 384, 384, 3, 1)
        cb(f"{name}.branch_pool", 192, in_ch, 1, 1)

    return spec


def validate_params(arrays):
    """Raise, naming the keys, unless ``arrays`` covers the feature path
    exactly and in shape."""
    spec = state_dict_spec()
    missing = [k for k in spec if k not in arrays]
    extra = [k for k in arrays if k not in spec]
    if missing or extra:
        raise ValueError(
            "InceptionV3 weight mismatch: "
            f"missing {missing[:5]}{'...' if len(missing) > 5 else ''} "
            f"({len(missing)} total), unexpected "
            f"{extra[:5]}{'...' if len(extra) > 5 else ''} ({len(extra)} total)"
        )
    bad = [
        (k, tuple(np.shape(arrays[k])), spec[k])
        for k in spec
        if tuple(np.shape(arrays[k])) != spec[k]
    ]
    if bad:
        raise ValueError(f"InceptionV3 weight shape mismatches: {bad[:5]}")


def random_state_dict(seed=0):
    """A deterministic full-architecture state_dict (numpy, torch naming):
    He-scaled conv weights and moderate batch-norm statistics, which keep
    the activations finite through all 94 layers."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in state_dict_spec().items():
        if k.endswith(".conv.weight"):
            fan_in = shape[1] * shape[2] * shape[3]
            sd[k] = rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)
        elif k.endswith(".bn.weight"):
            sd[k] = rng.uniform(0.8, 1.2, shape).astype(np.float32)
        elif k.endswith(".bn.bias"):
            sd[k] = rng.normal(0, 0.05, shape).astype(np.float32)
        elif k.endswith(".bn.running_mean"):
            sd[k] = rng.normal(0, 0.1, shape).astype(np.float32)
        else:  # running_var
            sd[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    return sd
