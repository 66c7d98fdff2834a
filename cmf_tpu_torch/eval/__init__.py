"""Evaluation: ``cmf_tpu/eval`` in torch, the Fréchet distance so far."""

from .fid import activation_statistics, frechet_distance, get_fid_function, sample_batches

__all__ = ["activation_statistics", "frechet_distance", "get_fid_function", "sample_batches"]
