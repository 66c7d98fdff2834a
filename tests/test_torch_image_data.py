"""The port's image readers (``cmf_tpu_torch/data/image.py``) against the JAX
package's (``cmf_tpu/data/image.py``), on small files each test writes: IDX,
raw and gzipped, in torchvision's three directory layouts; cifar10's pickle
batches in both layouts; svhn's ``.mat`` files. Both packages must give
byte-equal splits, find the root the same way and fail with the same
``FileNotFoundError``."""

import gzip
import os
import pickle

import numpy as np
import pytest
import scipy.io
import torch

from cmf_tpu.data.image import get_image_datasets as jax_get_image_datasets
from cmf_tpu_torch.data import get_image_datasets, get_loaders

N_TRAIN, N_TEST = 20, 10


def _idx_bytes(array):
    header = bytes([0, 0, 0x08, array.ndim]) + b"".join(d.to_bytes(4, "big") for d in array.shape)
    return header + array.astype(np.uint8).tobytes()


def _write_idx(directory, gz, seed=0):
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    for prefix, n in (("train", N_TRAIN), ("t10k", N_TEST)):
        arrays = {
            f"{prefix}-images-idx3-ubyte": rng.integers(0, 256, (n, 28, 28)),
            f"{prefix}-labels-idx1-ubyte": rng.integers(0, 10, n),
        }
        for name, array in arrays.items():
            path = os.path.join(directory, name + (".gz" if gz else ""))
            with (gzip.open if gz else open)(path, "wb") as f:
                f.write(_idx_bytes(array))


def _assert_equal_splits(dataset, root, **kw):
    got = get_image_datasets(dataset, data_root=root, synthetic=False, **kw)
    want = jax_get_image_datasets(dataset, data_root=root, synthetic=False, **kw)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == np.uint8 and gy.dtype == wy.dtype == np.int64
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    return got


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gz"])
@pytest.mark.parametrize("layout", ["torchvision", "raw", "flat"])
def test_idx_readers_match_cmf_tpu(tmp_path, layout, gz):
    directory = {
        "torchvision": tmp_path / "mnist" / "MNIST" / "raw",
        "raw": tmp_path / "mnist" / "raw",
        "flat": tmp_path / "mnist",
    }[layout]
    _write_idx(str(directory), gz)
    (train, _), (valid, _), (test, _) = _assert_equal_splits("mnist", str(tmp_path))
    assert train.shape == (18, 1, 28, 28) and valid.shape == (2, 1, 28, 28)
    assert test.shape == (N_TEST, 1, 28, 28)


def test_fashion_mnist_idx_reader_matches_cmf_tpu(tmp_path):
    _write_idx(str(tmp_path / "fashion-mnist" / "FashionMNIST" / "raw"), True, seed=1)
    _assert_equal_splits("fashion-mnist", str(tmp_path), seed=3)


@pytest.mark.parametrize("nested", [True, False], ids=["batches-py", "flat"])
def test_cifar10_reader_matches_cmf_tpu(tmp_path, nested):
    base = tmp_path / "cifar10" / ("cifar-10-batches-py" if nested else "")
    os.makedirs(base, exist_ok=True)
    rng = np.random.default_rng(2)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rng.integers(0, 256, (4, 3072)).astype(np.uint8),
                 b"labels": rng.integers(0, 10, 4).tolist()}
        with open(base / name, "wb") as f:
            pickle.dump(batch, f)
    (train, _), (valid, _), (test, _) = _assert_equal_splits("cifar10", str(tmp_path))
    assert train.shape == (18, 3, 32, 32) and valid.shape == (2, 3, 32, 32)
    assert test.shape == (4, 3, 32, 32)


def test_svhn_reader_matches_cmf_tpu(tmp_path):
    os.makedirs(tmp_path / "svhn")
    rng = np.random.default_rng(4)
    for split, n in (("train", N_TRAIN), ("test", N_TEST)):
        scipy.io.savemat(str(tmp_path / "svhn" / f"{split}_32x32.mat"), {
            "X": rng.integers(0, 256, (32, 32, 3, n)).astype(np.uint8),
            "y": rng.integers(1, 11, (n, 1)).astype(np.uint8),  # the digit 0 is stored as 10
        })
    (train, train_y), _, (test, test_y) = _assert_equal_splits("svhn", str(tmp_path))
    assert train.shape == (18, 3, 32, 32) and test.shape == (N_TEST, 3, 32, 32)
    assert set(np.concatenate([train_y, test_y])) <= set(range(10))


def test_data_root_from_the_environment(tmp_path, monkeypatch):
    _write_idx(str(tmp_path / "mnist"), False)
    monkeypatch.setenv("CMF_TPU_DATA_ROOT", str(tmp_path))
    _assert_equal_splits("mnist", None)


def test_loaders_read_the_config_s_data_root(tmp_path):
    _write_idx(str(tmp_path / "mnist" / "raw"), True)
    config = {"train_batch_size": 6, "valid_batch_size": 6, "test_batch_size": 6}
    train, valid, test = get_loaders("mnist", config, "cpu", synthetic=False, data_root=str(tmp_path))
    (want, _), _, _ = jax_get_image_datasets("mnist", data_root=str(tmp_path), synthetic=False)
    assert train.num_examples == 18 and valid.num_examples == 2 and test.num_examples == N_TEST
    np.testing.assert_array_equal(train.x, want.astype(np.float32))
    assert next(iter(test)).dtype == torch.float32


@pytest.mark.parametrize("dataset", ["mnist", "cifar10", "svhn", "omniglot", "celeba"])
def test_missing_files_raise_cmf_tpu_s_error(tmp_path, dataset):
    """Where the files are absent (for omniglot and celeba, whether or not
    torchvision imports), both packages raise the same ``FileNotFoundError``."""
    with pytest.raises(FileNotFoundError) as want:
        jax_get_image_datasets(dataset, data_root=str(tmp_path), synthetic=False)
    with pytest.raises(FileNotFoundError) as got:
        get_image_datasets(dataset, data_root=str(tmp_path), synthetic=False)
    assert str(got.value) == str(want.value)
    assert f"`{dataset}' not found under `{tmp_path}'" in str(got.value)
