from .core import MLP, Conv, Dense, ResNet, get_activation

__all__ = ["MLP", "Conv", "Dense", "ResNet", "get_activation"]
