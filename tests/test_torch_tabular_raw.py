"""The raw tabular loaders of the port against the JAX package's, on small
files in each dataset's real format written under ``tmp_path`` in the layout
the loaders read: gas's pandas pickle (with a column pair correlated above
0.98, so the pruning loop drops a column), hepmass's two CSVs (with a
feature whose smallest value repeats more than 5 times, which the loader
removes), power's ``.npy`` (8 columns) and BSDS300's HDF5 file. Both
packages' ``get_tabular_datasets`` must give byte-equal float32 arrays.
Also ``data/gaussian.py`` (equal within one process: it seeds from
``hash(role)``) and the missing-file message."""

import numpy as np
import pandas
import pytest

from cmf_tpu.data import gaussian as jax_gaussian
from cmf_tpu.data.tabular import get_tabular_datasets as jax_get_tabular_datasets
from cmf_tpu_torch.data import gaussian
from cmf_tpu_torch.data.tabular import get_tabular_datasets


def _write_gas(root, rng):
    n = 300
    base = rng.normal(size=(n, 6))
    columns = {"Meth": rng.normal(size=n), "Eth": rng.normal(size=n), "Time": np.arange(n, dtype=float)}
    for i in range(6):
        columns[f"s{i}"] = base[:, i]
    # s6 follows s2 within noise: correlation above 0.98.
    columns["s6"] = base[:, 2] + 0.01 * rng.normal(size=n)
    columns["s7"] = 0.5 * base[:, 0] + rng.normal(size=n)
    frame = pandas.DataFrame(columns)
    (root / "gas").mkdir()
    frame.to_pickle(root / "gas" / "ethylene_CO.pickle")
    return 8 - 1  # the eight sensors less the one pruned


def _write_hepmass(root, rng):
    (root / "hepmass").mkdir()
    for split, n in (("train", 400), ("test", 200)):
        label = rng.integers(0, 2, size=n)
        features = rng.normal(size=(n, 6))
        # f5 takes its smallest value on many rows (as hepmass's discrete
        # features do): the loader removes it.
        features[:, 5] = np.where(rng.random(n) < 0.3, -1.5, rng.uniform(0.0, 1.0, size=n))
        frame = pandas.DataFrame(features, columns=[f"f{i}" for i in range(6)])
        frame.insert(0, "# label", label.astype(float))
        if split == "test":
            frame["mass"] = rng.uniform(500, 1500, size=n)  # the test file's extra last column
        frame.to_csv(root / "hepmass" / f"1000_{split}.csv", index=False)
    return 6 - 1


def _write_power(root, rng):
    (root / "power").mkdir()
    np.save(root / "power" / "data.npy", rng.normal(size=(500, 8)) * [1, 2, 3, 4, 5, 6, 7, 8])
    return 6


def _write_bsds300(root, rng):
    import h5py

    (root / "BSDS300").mkdir()
    with h5py.File(root / "BSDS300" / "BSDS300.hdf5", "w") as f:
        for name, n in (("train", 120), ("validation", 30), ("test", 40)):
            f.create_dataset(name, data=rng.normal(size=(n, 63)))
    return 63


WRITERS = {"gas": _write_gas, "hepmass": _write_hepmass, "power": _write_power, "bsds300": _write_bsds300,
           "miniboone": None}


@pytest.mark.parametrize("name", ["gas", "hepmass", "power", "bsds300", "miniboone"])
def test_raw_loader_is_byte_equal_to_cmf_tpus(name, tmp_path):
    rng = np.random.default_rng(sorted(WRITERS).index(name))
    if name == "miniboone":
        (tmp_path / "miniboone").mkdir()
        np.save(tmp_path / "miniboone" / "data.npy", rng.normal(size=(300, 43)))
        width = 43
    else:
        width = WRITERS[name](tmp_path, rng)
    got = get_tabular_datasets(name, data_root=str(tmp_path), synthetic=False)
    want = jax_get_tabular_datasets(name, data_root=str(tmp_path), synthetic=False)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.flags["C_CONTIGUOUS"]
        assert g.shape[1] == width and len(g) > 0
        assert np.array_equal(g, w)


def test_gaussian_datasets_match_within_one_process():
    got = gaussian.get_well_conditioned_gaussian_datasets(dim=3, std=1.0, oos_std=2.5, seed=4)
    want = jax_gaussian.get_well_conditioned_gaussian_datasets(dim=3, std=1.0, oos_std=2.5, seed=4)
    for g, w in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        assert g.dtype == np.float32 and np.array_equal(g, w)
    assert [len(a) for a in (got[0], got[1], *got[2])] == [50000, 5000, 10000, 10000]


@pytest.mark.parametrize("name", ["gas", "hepmass", "power", "bsds300", "miniboone"])
def test_missing_files_raise_cmf_tpus_message(name, tmp_path):
    with pytest.raises(FileNotFoundError) as got:
        get_tabular_datasets(name, data_root=str(tmp_path), synthetic=False)
    with pytest.raises(FileNotFoundError) as want:
        jax_get_tabular_datasets(name, data_root=str(tmp_path), synthetic=False)
    assert str(got.value) == str(want.value)
    assert str(tmp_path) in str(got.value)
