from .core import MLP, Dense, get_activation

__all__ = ["MLP", "Dense", "get_activation"]
