"""Tabular datasets: the port's copy of ``cmf_tpu/data/tabular.py``.

Carried over: the dataset shapes, the split helpers, the synthetic
correlated-mixture stand-in (same numpy draws, so the same seed gives the same
arrays) and the five raw loaders with their preprocessing as it stands.
MiniBooNE and power need numpy only; gas and hepmass import pandas and BSDS300
imports h5py, inside the loader. Nothing is downloaded.
"""

import os
from collections import Counter

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


def get_gas_raw(data_root):
    """(tabular.py:54-75) correlation-pruning loop at threshold 0.98."""
    import pandas

    data = pandas.read_pickle(os.path.join(data_root, "gas/ethylene_CO.pickle"))
    for col in ("Meth", "Eth", "Time"):
        data.drop(col, axis=1, inplace=True)

    def correlation_numbers(d):
        C = d.corr()
        return (C > 0.98).to_numpy().sum(axis=1)

    B = correlation_numbers(data)
    while np.any(B > 1):
        col_to_remove = np.where(B > 1)[0][0]
        data.drop(data.columns[col_to_remove], axis=1, inplace=True)
        B = correlation_numbers(data)

    data = normalize_raw_data(data, data.mean(), data.std()).to_numpy()
    return make_tabular_train_valid_test_split(data, 0.1)


def get_hepmass_raw(data_root):
    """(tabular.py:78-109) class-1 filter + constant-ish feature removal."""
    import pandas

    train_raw = pandas.read_csv(os.path.join(data_root, "hepmass/1000_train.csv"), index_col=False)
    test_raw = pandas.read_csv(os.path.join(data_root, "hepmass/1000_test.csv"), index_col=False)

    train_raw = train_raw[train_raw[train_raw.columns[0]] == 1]
    train_raw = train_raw.drop(train_raw.columns[0], axis=1)
    test_raw = test_raw[test_raw[test_raw.columns[0]] == 1]
    test_raw = test_raw.drop(test_raw.columns[0], axis=1)
    test_raw = test_raw.drop(test_raw.columns[-1], axis=1)

    mu, s = train_raw.mean(), train_raw.std()
    train_raw = normalize_raw_data(train_raw, mu, s).to_numpy()
    test_raw = normalize_raw_data(test_raw, mu, s).to_numpy()

    features_to_remove = []
    for i, feature in enumerate(train_raw.T):
        c = Counter(feature)
        max_count = np.array([v for k, v in sorted(c.items())])[0]
        if max_count > 5:
            features_to_remove.append(i)
    keep = [i for i in range(train_raw.shape[1]) if i not in features_to_remove]
    train_raw = train_raw[:, keep]
    test_raw = test_raw[:, keep]

    train_raw, valid_raw = make_tabular_train_valid_split(train_raw, 0.1)
    return train_raw, valid_raw, test_raw


def get_power_raw(data_root, seed=0):
    """(tabular.py:112-138) column drops + per-column noise injection."""
    data = np.load(os.path.join(data_root, "power/data.npy"))
    rng = np.random.default_rng(seed)
    rng.shuffle(data)
    n = data.shape[0]
    data = np.delete(data, 3, axis=1)
    data = np.delete(data, 1, axis=1)
    noise = np.hstack(
        (
            0.001 * rng.random((n, 1)),
            0.01 * rng.random((n, 1)),
            rng.random((n, 3)),
            np.zeros((n, 1)),
        )
    )
    data = data + noise
    train_raw, valid_raw, test_raw = make_tabular_train_valid_test_split(data, 0.1)
    stack = np.vstack((train_raw, valid_raw))
    mu, s = stack.mean(axis=0), stack.std(axis=0)
    return tuple(normalize_raw_data(d, mu, s) for d in (train_raw, valid_raw, test_raw))


def get_bsds300_raw(data_root):
    import h5py

    with h5py.File(os.path.join(data_root, "BSDS300", "BSDS300.hdf5"), "r") as f:
        return f["train"][()], f["validation"][()], f["test"][()]


_RAW_FNS = {
    "miniboone": get_miniboone_raw,
    "gas": get_gas_raw,
    "hepmass": get_hepmass_raw,
    "power": get_power_raw,
    "bsds300": get_bsds300_raw,
}


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
        root = data_root or os.environ.get("CMF_TPU_DATA_ROOT", "data")
        try:
            arrays = _RAW_FNS[name](root)
        except (FileNotFoundError, OSError) as e:
            raise FileNotFoundError(
                f"Raw files for `{name}' not found under `{root}'. Download the "
                "MAF-preprocessed UCI archives there, or pass synthetic=True / "
                "set CMF_TPU_SYNTHETIC_DATA=1 for a shape-compatible stand-in."
            ) from e
    else:
        arrays = get_synthetic_tabular(name, seed=seed)
    return tuple(np.ascontiguousarray(a, dtype=np.float32) for a in arrays)
