"""The port's 2-D zoo (``cmf_tpu_torch/data/two_d.py``, a numpy copy)
against the JAX package's: every registered name gives the same bytes at two
seeds in each split, and the loaders give the same splits, truncation and
batches."""

import numpy as np
import pytest

from cmf_tpu.data.loaders import get_loaders as jax_get_loaders
from cmf_tpu.data.two_d import _GENERATORS as JAX_GENERATORS
from cmf_tpu.data.two_d import get_2d_datasets as jax_get_2d_datasets
from cmf_tpu_torch.data import get_2d_datasets, get_loaders
from cmf_tpu_torch.data.two_d import _GENERATORS, data_width

SEEDS = (0, 7)


def test_registries_match():
    assert sorted(_GENERATORS) == sorted(JAX_GENERATORS)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(JAX_GENERATORS))
def test_dataset_bytes_match_cmf_tpu(name, seed):
    ours, theirs = get_2d_datasets(name, seed=seed), jax_get_2d_datasets(name, seed=seed)
    assert [a.shape[0] for a in ours] == [10000, 1000, 5000]
    assert all(a.shape[1:] == (data_width(name),) for a in ours)
    for got, want in zip(ours, theirs):
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("max_size", [None, 3000])
def test_loaders_match_cmf_tpu(max_size):
    config = {"train_batch_size": 1000, "valid_batch_size": 1000, "test_batch_size": 10000,
              "max_dataset_size": max_size}
    ours = get_loaders("hemisphere-2-6", config, "cpu", seed=3)
    theirs = jax_get_loaders("hemisphere-2-6", config, seed=3)
    for o, w in zip(ours, theirs):
        np.testing.assert_array_equal(o.x, w.x)
        assert len(o) == len(w)
    train = ours[0]
    assert train.num_examples == (max_size or 10000) and train.x_shape == (6,)
    for got, want in zip(train, theirs[0]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The test split is one batch of its 5000 rows (test_batch_size 10,000).
    assert [b.shape[0] for b in ours[2]] == [min(5000, max_size or 5000)]


def test_unknown_dataset_raises():
    with pytest.raises(AssertionError, match="Unknown dataset"):
        get_loaders("no-such-dataset", {"train_batch_size": 1}, "cpu")
