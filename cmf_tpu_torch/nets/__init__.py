from .core import (
    MLP,
    AutoregressiveMLP,
    BatchNorm2d,
    ConstantNetwork,
    Conv,
    Dense,
    GlowCNN,
    IdentityNetwork,
    ResNet,
    batch_statistics,
    get_activation,
    running_statistics_held,
)

__all__ = [
    "MLP",
    "AutoregressiveMLP",
    "BatchNorm2d",
    "ConstantNetwork",
    "Conv",
    "Dense",
    "GlowCNN",
    "IdentityNetwork",
    "ResNet",
    "batch_statistics",
    "get_activation",
    "running_statistics_held",
]
