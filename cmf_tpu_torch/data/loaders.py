"""Device-resident batch loaders (``cmf_tpu/data/loaders.py`` in torch).

The dataset is copied to the device once; each epoch's shuffle is the same
numpy permutation as the JAX ``ArrayLoader`` (``default_rng((seed, epoch))``),
so one seed gives the same batches in both packages. The train loader drops
the last partial batch.
"""

import numpy as np
import torch

from ..tracing import span
from .image import DATASET_SHAPES as IMAGE_SHAPES, get_image_datasets
from .tabular import DATASET_SHAPES as TABULAR_SHAPES, get_tabular_datasets
from .two_d import _GENERATORS as _TWO_D_GENERATORS, get_2d_datasets


class ArrayLoader:
    def __init__(self, x, batch_size, device, shuffle=False, drop_last=False, seed=0):
        self.x = x
        self.batch_size = int(batch_size)
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._epoch = 0
        self._seed = seed
        self._x_dev = None

    @property
    def num_examples(self):
        return self.x.shape[0]

    @property
    def x_shape(self):
        return self.x.shape[1:]

    def __len__(self):
        n = self.num_examples
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _device_x(self):
        if self._x_dev is None:
            self._x_dev = torch.as_tensor(self.x, device=self.device)
        return self._x_dev

    def __iter__(self):
        n = self.num_examples
        if self.shuffle:
            rng = np.random.default_rng((self._seed, self._epoch))
            order = rng.permutation(n)
            self._epoch += 1
        else:
            order = np.arange(n)
        x_dev = self._device_x()
        order = torch.as_tensor(order[: len(self) * self.batch_size], device=self.device)
        for b in range(len(self)):
            with span("loader/batch"):
                batch = x_dev.index_select(0, order[b * self.batch_size : (b + 1) * self.batch_size])
            yield batch


def get_loaders(dataset, config, device, seed=0, synthetic=None, data_root=None):
    """name → (train_loader, valid_loader, test_loader) (loaders.py:132-167):
    the 2-D zoo, tabular and image datasets; images are cast from uint8 to
    float32."""
    if dataset in _TWO_D_GENERATORS:
        train_x, valid_x, test_x = get_2d_datasets(dataset, seed=seed)
    elif dataset in TABULAR_SHAPES:
        train_x, valid_x, test_x = get_tabular_datasets(
            dataset, data_root=data_root, synthetic=synthetic, seed=seed
        )
    elif dataset in IMAGE_SHAPES:
        (train_x, _), (valid_x, _), (test_x, _) = get_image_datasets(
            dataset, data_root=data_root, synthetic=synthetic, seed=seed
        )
        train_x, valid_x, test_x = (a.astype(np.float32) for a in (train_x, valid_x, test_x))
    else:
        raise AssertionError(f"Unknown dataset `{dataset}'")
    # Optional split truncation (loaders.py:152-159): caps every split so
    # short runs control steps-per-epoch explicitly.
    max_size = config.get("max_dataset_size")
    if max_size:
        train_x = train_x[: int(max_size)]
        valid_x = valid_x[: int(max_size)]
        test_x = test_x[: int(max_size)]

    train_loader = ArrayLoader(
        train_x, config["train_batch_size"], device, shuffle=True, drop_last=True, seed=seed
    )
    valid_loader = ArrayLoader(valid_x, config["valid_batch_size"], device)
    test_loader = ArrayLoader(test_x, config["test_batch_size"], device)
    return train_loader, valid_loader, test_loader
