from .image import get_image_datasets
from .loaders import ArrayLoader, get_loaders
from .tabular import DATASET_SHAPES, get_synthetic_tabular, get_tabular_datasets

__all__ = [
    "ArrayLoader",
    "DATASET_SHAPES",
    "get_image_datasets",
    "get_loaders",
    "get_synthetic_tabular",
    "get_tabular_datasets",
]
