"""Tabular datasets: the port's copy of ``cmf_tpu/data/tabular.py``.

Carried over: the dataset shapes, the split helpers, the synthetic
correlated-mixture stand-in (same numpy draws, so the same seed gives the same
arrays) and the MiniBooNE raw loader, which needs numpy only. The other raw
loaders need pandas / h5py and wait for a later slice. Nothing is downloaded.
"""

import os

import numpy as np

# (num features after preprocessing, train rows) for synthetic shaping
DATASET_SHAPES = {
    "power": (6, 1_615_917),
    "gas": (8, 852_174),
    "hepmass": (21, 315_123),
    "miniboone": (43, 29_556),
    "bsds300": (63, 1_000_000),
}


def normalize_raw_data(data, mu, s):
    return (data - mu) / s


def make_tabular_train_valid_split(data, frac):
    n_valid = int(frac * data.shape[0])
    return data[:-n_valid], data[-n_valid:]


def make_tabular_train_valid_test_split(data, frac):
    n_test = int(frac * data.shape[0])
    test_data = data[-n_test:]
    data = data[:-n_test]
    train_data, valid_data = make_tabular_train_valid_split(data, frac)
    return train_data, valid_data, test_data


def get_miniboone_raw(data_root):
    data = np.load(os.path.join(data_root, "miniboone/data.npy"))
    train_raw, valid_raw, test_raw = make_tabular_train_valid_test_split(data, 0.1)
    stack = np.vstack((train_raw, valid_raw))
    mu, s = stack.mean(axis=0), stack.std(axis=0)
    return tuple(normalize_raw_data(d, mu, s) for d in (train_raw, valid_raw, test_raw))


def get_synthetic_tabular(name, seed=0, train_rows=None):
    """Deterministic correlated-mixture stand-in with the real dims/splits."""
    dim, n_train_full = DATASET_SHAPES[name]
    n = train_rows if train_rows is not None else min(n_train_full, 100_000)
    rng = np.random.default_rng(seed)
    k = 4
    means = rng.standard_normal((k, dim)) * 2
    mix_chol = rng.standard_normal((k, dim, dim)) * 0.3 / np.sqrt(dim)
    total = int(n * 1.25)
    comp = rng.integers(0, k, total)
    eps = rng.standard_normal((total, dim))
    data = means[comp] + np.einsum("nij,nj->ni", mix_chol[comp], eps)
    mu, s = data.mean(0), data.std(0)
    data = (data - mu) / s
    train, valid, test = make_tabular_train_valid_test_split(data, 0.1)
    return train, valid, test


def get_tabular_datasets(name, data_root=None, synthetic=None, seed=0):
    """Returns float32 (train, valid, test) numpy arrays."""
    if synthetic is None:
        synthetic = os.environ.get("CMF_TPU_SYNTHETIC_DATA", "") == "1"
    if not synthetic:
        if name != "miniboone":
            raise NotImplementedError(
                f"raw `{name}' loading needs pandas/h5py and waits for a later "
                "slice of the port; pass synthetic=True (CLI: --synthetic-data)"
            )
        root = data_root or os.environ.get("CMF_TPU_DATA_ROOT", "data")
        try:
            arrays = get_miniboone_raw(root)
        except (FileNotFoundError, OSError) as e:
            raise FileNotFoundError(
                f"Raw files for `{name}' not found under `{root}'. Download the "
                "MAF-preprocessed UCI archives there, or pass synthetic=True / "
                "set CMF_TPU_SYNTHETIC_DATA=1 for a shape-compatible stand-in."
            ) from e
    else:
        arrays = get_synthetic_tabular(name, seed=seed)
    return tuple(np.ascontiguousarray(a, dtype=np.float32) for a in arrays)
