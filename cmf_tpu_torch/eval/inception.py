"""Image feature extractors for FID (``cmf_tpu/eval/inception.py`` in torch).

The feature function is resolved in the JAX package's order
(inception.py:91-108):

1. ``CMF_TPU_INCEPTION_WEIGHTS``: a local ``.npz`` of InceptionV3
   parameters in the JAX package's layout, run through the port's
   InceptionV3 (``eval/inception_v3.py``), stamped ``inception-jax``;
2. torchvision's ``inception_v3`` with its weights already in the local
   torch hub cache (stamped ``torchvision``); nothing is downloaded;
3. a deterministic random-conv extractor, the "proxy" (stamped ``proxy``),
   with a warning printed once: a relative tracking signal, never
   comparable to published FID numbers.

Every extractor runs on the device it is given, under whatever grad mode
the caller is in.

The proxy (inception.py:26-59): three 3×3/5×5 convolutions at stride 2 with
XLA's SAME padding, each followed by a relu, then the mean over a 2×2 grid
of cells, the rows and columns that do not fill a cell dropped. It returns
``fid_dims // 16`` channels × 4 cells: 512 features at the default 2048, for
28×28, 32×32 and 64×64 inputs alike. Its weights are drawn at the JAX
package's shapes and 0.2 scale from a CPU ``torch.Generator`` seeded with
``seed``: the JAX package draws them with its own PRNG, which the port does
not reproduce, so a port run's proxy is another random projection than the
JAX package's (ROADMAP, "Deliberate differences").
``interop.proxy_weights_from_jax`` takes the JAX package's draws instead.
"""

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

PROXY_SCALE = 0.2
_WARNED = False


def proxy_weights(fid_dims=2048, seed=0):
    """The proxy's three conv weights (OIHW), N(0, 0.2²), from a CPU
    generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    shapes = [(32, 3, 5, 5), (64, 32, 3, 3), (fid_dims // 16, 64, 3, 3)]
    return [torch.randn(shape, generator=gen) * PROXY_SCALE for shape in shapes]


def same_padding(n, k, stride):
    """XLA's SAME padding of one spatial axis: (before, after), the smaller
    half first."""
    total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv_same(h, w, stride):
    (top, bottom), (left, right) = (
        same_padding(h.shape[2], w.shape[2], stride),
        same_padding(h.shape[3], w.shape[3], stride),
    )
    return F.conv2d(F.pad(h, (left, right, top, bottom)), w, stride=stride)


class ProxyFeatures(nn.Module):
    """The random-conv proxy: (B, C, H, W) in [0, 256) → (B, 4·fid_dims/16)."""

    extractor_kind = "proxy"

    def __init__(self, w1, w2, w3):
        super().__init__()
        self.register_buffer("w1", torch.as_tensor(w1, dtype=torch.float32).clone())
        self.register_buffer("w2", torch.as_tensor(w2, dtype=torch.float32).clone())
        self.register_buffer("w3", torch.as_tensor(w3, dtype=torch.float32).clone())

    def forward(self, x):
        h = x / 128.0 - 1.0
        if h.shape[1] == 1:
            h = h.repeat(1, 3, 1, 1)
        for w in (self.w1, self.w2, self.w3):
            h = torch.relu(_conv_same(h, w, 2))
        b, c, hh, ww = h.shape
        gh, gw = max(hh // 2, 1), max(ww // 2, 1)
        h = h[:, :, : gh * 2, : gw * 2].reshape(b, c, 2, gh, 2, gw).mean(dim=(3, 5))
        return h.reshape(b, -1)


def _torchvision_feature_fn(device):
    """pool3 features of torchvision's InceptionV3 (inception.py:62-88),
    from the weights in the local torch hub cache; raises where torchvision
    or those weights are absent, before anything could be downloaded."""
    import torchvision

    weights = torchvision.models.Inception_V3_Weights.IMAGENET1K_V1
    cached = os.path.join(torch.hub.get_dir(), "checkpoints", os.path.basename(weights.url))
    if not os.path.exists(cached):
        raise FileNotFoundError(cached)
    model = torchvision.models.inception_v3(weights=weights, aux_logits=True)
    model.fc = nn.Identity()
    model.eval().to(device)

    def features(x):
        t = x.to(torch.float32) / 255.0
        if t.shape[1] == 1:
            t = t.repeat(1, 3, 1, 1)
        t = F.interpolate(t, size=(299, 299), mode="bilinear", align_corners=False)
        with torch.no_grad():
            return model((t - 0.5) / 0.5)

    features.extractor_kind = "torchvision"
    return features


def get_feature_fn(config, device="cpu"):
    """The image feature function of a FID, on ``device``."""
    global _WARNED
    weights_path = os.environ.get("CMF_TPU_INCEPTION_WEIGHTS")
    if weights_path and os.path.exists(weights_path):
        from .inception_v3 import load_feature_fn

        return load_feature_fn(weights_path, device)
    try:
        return _torchvision_feature_fn(device)
    except Exception:
        if not _WARNED:
            print(
                "WARNING: InceptionV3 weights unavailable — falling back to a "
                "deterministic random-conv proxy. FID values are relative "
                "tracking signals, not comparable to published numbers."
            )
            _WARNED = True
        return ProxyFeatures(*proxy_weights(config.get("fid_dims", 2048))).to(device)
