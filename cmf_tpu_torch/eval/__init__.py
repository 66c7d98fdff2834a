"""Evaluation: ``cmf_tpu/eval`` in torch: the Fréchet distance and the image
feature extractors (the random-conv proxy and InceptionV3)."""

from .fid import activation_statistics, frechet_distance, get_fid_function, sample_batches
from .inception import ProxyFeatures, get_feature_fn, proxy_weights
from .inception_v3 import InceptionFeatures, InceptionV3, load_feature_fn

__all__ = [
    "activation_statistics",
    "frechet_distance",
    "get_fid_function",
    "sample_batches",
    "ProxyFeatures",
    "get_feature_fn",
    "proxy_weights",
    "InceptionFeatures",
    "InceptionV3",
    "load_feature_fn",
]
