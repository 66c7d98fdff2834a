from .factory import get_density

__all__ = ["get_density"]
