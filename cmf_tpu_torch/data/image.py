"""Image datasets: the port's copy of ``cmf_tpu/data/image.py`` (uint8 NCHW,
values in {0..255}).

Carried over: the dataset shapes, the synthetic stand-in ``_synthetic_raw``
(the same numpy draws, so one seed gives byte-equal arrays) and
``get_image_datasets`` with its 10% shuffled validation split. Reading the
raw files on disk (idx, pickle batches, .mat, image folders) waits for a
later slice and raises. Dequantization and the logit transform are model
layers (the schema's preprocessing), not done here.
"""

import os

import numpy as np

DATASET_SHAPES = {
    # name: (channels, H, W, n_train, n_test)
    "mnist": (1, 28, 28, 60_000, 10_000),
    "fashion-mnist": (1, 28, 28, 60_000, 10_000),
    "cifar10": (3, 32, 32, 50_000, 10_000),
    "svhn": (3, 32, 32, 73_257, 26_032),
    "celeba": (3, 64, 64, 162_770, 19_962),
    "omniglot": (1, 28, 28, 25_968, 6_492),
}


def _synthetic_raw(dataset_name, train, seed=0, max_n=10_000):
    """Structured deterministic uint8 stand-in with the real dataset's shape
    (image.py:162-208): gaussian blobs for mnist, striped silhouettes for
    fashion-mnist, and a per-name offset into the stream for the others."""
    c, h, w, n_train, n_test = DATASET_SHAPES[dataset_name]
    n = min(n_train if train else n_test, max_n)
    name_offset = (
        0 if dataset_name == "mnist"
        else int.from_bytes(dataset_name.encode()[-4:], "little") % 1_000_003
    )
    rng = np.random.default_rng(seed + (0 if train else 1) + name_offset)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    images = np.empty((n, c, h, w), np.uint8)
    labels = rng.integers(0, 10, n)
    striped = dataset_name == "fashion-mnist"
    for i in range(n):
        if striped:
            x0, y0 = rng.uniform(0.1, 0.4, 2) * (w, h)
            x1, y1 = rng.uniform(0.6, 0.9, 2) * (w, h)
            box = ((xx >= x0) & (xx <= x1) & (yy >= y0) & (yy <= y1)).astype(np.float32)
            period = rng.uniform(2.0, 6.0)
            phase = rng.uniform(0, 2 * np.pi)
            stripes = 0.5 + 0.5 * np.sin(2 * np.pi * yy / period + phase)
            base = rng.uniform(0, 0.2) + 0.15 * (yy / h) * rng.uniform(0, 1)
            img = np.clip(base + box * stripes * rng.uniform(0.5, 1.0), 0, 1)
        else:
            cx, cy = rng.uniform(0.2, 0.8, 2) * (w, h)
            sig = rng.uniform(0.08, 0.25) * h
            blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sig**2)))
            base = rng.uniform(0, 0.3) + 0.2 * (xx / w) * rng.uniform(0, 1)
            img = np.clip(base + blob * rng.uniform(0.5, 1.0), 0, 1)
        for ch in range(c):
            scale = rng.uniform(0.6, 1.0)
            images[i, ch] = (img * scale * 255).astype(np.uint8)
    return images, labels.astype(np.int64)


def get_image_datasets(dataset_name, data_root=None, make_valid_dset=True, synthetic=None, seed=0):
    """((train_x, train_y), (valid_x, valid_y), (test_x, test_y)) as uint8 /
    int64 arrays; the valid split is 10% of the shuffled train set
    (image.py:211-247)."""
    if synthetic is None:
        synthetic = os.environ.get("CMF_TPU_SYNTHETIC_DATA", "") == "1"
    if not synthetic:
        raise NotImplementedError(
            f"reading `{dataset_name}' from disk waits for a later slice of the port; "
            "pass synthetic=True (CLI: --synthetic-data)"
        )
    train_images, train_labels = _synthetic_raw(dataset_name, True, seed)
    test_images, test_labels = _synthetic_raw(dataset_name, False, seed)

    valid_fraction = 0.1 if make_valid_dset else 0.0
    rng = np.random.default_rng(seed)
    perm = rng.permutation(train_images.shape[0])
    train_images, train_labels = train_images[perm], train_labels[perm]
    valid_size = int(valid_fraction * train_images.shape[0])
    valid_images, valid_labels = train_images[:valid_size], train_labels[:valid_size]
    train_images, train_labels = train_images[valid_size:], train_labels[valid_size:]

    return (
        (train_images, train_labels),
        (valid_images, valid_labels),
        (test_images, test_labels),
    )
