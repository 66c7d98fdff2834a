from .image import get_image_datasets
from .loaders import ArrayLoader, get_loaders
from .tabular import DATASET_SHAPES, get_synthetic_tabular, get_tabular_datasets
from .two_d import get_2d_data, get_2d_datasets

__all__ = [
    "ArrayLoader",
    "DATASET_SHAPES",
    "get_2d_data",
    "get_2d_datasets",
    "get_image_datasets",
    "get_loaders",
    "get_synthetic_tabular",
    "get_tabular_datasets",
]
