from .core import MLP, AutoregressiveMLP, Conv, Dense, ResNet, get_activation

__all__ = ["MLP", "AutoregressiveMLP", "Conv", "Dense", "ResNet", "get_activation"]
