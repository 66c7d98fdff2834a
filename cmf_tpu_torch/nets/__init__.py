from .core import (
    MLP,
    AutoregressiveMLP,
    BatchNorm2d,
    Conv,
    Dense,
    GlowCNN,
    ResNet,
    batch_statistics,
    get_activation,
)

__all__ = [
    "MLP",
    "AutoregressiveMLP",
    "BatchNorm2d",
    "Conv",
    "Dense",
    "GlowCNN",
    "ResNet",
    "batch_statistics",
    "get_activation",
]
