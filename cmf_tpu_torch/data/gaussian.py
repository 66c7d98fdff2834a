"""Synthetic Gaussian datasets: the port's copy of ``cmf_tpu/data/gaussian.py``
(reference cmf/datasets/gaussian.py; experimental, not wired into the loaders).

Copied as it stands: each role seeds from ``hash(role) % 2**31``, Python's
string hash, which changes per process unless ``PYTHONHASHSEED`` is set, so
two packages give the same arrays only within one process.
"""

import numpy as np


def get_gaussian_dataset(role, size, dim, std, seed=0):
    rng = np.random.default_rng((seed, hash(role) % 2**31))
    return (std * rng.standard_normal((size, dim))).astype(np.float32)


def get_well_conditioned_gaussian_datasets(dim, std, oos_std, seed=0):
    train = get_gaussian_dataset("train", 50000, dim, std, seed)
    valid = get_gaussian_dataset("valid", 5000, dim, std, seed)
    tests = [
        get_gaussian_dataset("test", 10000, dim, std, seed),
        get_gaussian_dataset("test-oos", 10000, dim, oos_std, seed),
    ]
    return train, valid, tests
