"""Image datasets: the port's copy of ``cmf_tpu/data/image.py`` (uint8 NCHW,
values in {0..255}).

Carried over: the dataset shapes; the torchvision-free readers of the files
on disk (image.py:29-103): IDX, raw or gzipped, for mnist and fashion-mnist
in torchvision's three directory layouts, cifar10's pickle batches and
svhn's ``.mat`` files (scipy); torchvision's own datasets for omniglot and
celeba (image.py:110-160), imported inside the call and never downloading;
the synthetic stand-in ``_synthetic_raw`` (the same numpy draws, so one seed
gives byte-equal arrays); and ``get_image_datasets`` with its 10% shuffled
validation split. Every read failure is re-raised as the JAX package's
``FileNotFoundError``. The data root is ``data_root``, else
``CMF_TPU_DATA_ROOT``, else ``data``. Dequantization and the logit transform
are model layers (the schema's preprocessing), not done here.
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


def _idx_read(path):
    """An IDX file (the MNIST format), gzipped or raw: magic [0, 0, 0x08
    (uint8), ndim], ndim big-endian uint32 dims, then the data."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        buf = f.read()
    assert buf[0] == 0 and buf[1] == 0 and buf[2] == 0x08, f"bad idx magic in {path}"
    ndim = buf[3]
    dims = [int.from_bytes(buf[4 + 4 * i : 8 + 4 * i], "big") for i in range(ndim)]
    data = np.frombuffer(buf, np.uint8, offset=4 + 4 * ndim)
    return data.reshape(dims)


def _find_idx(candidates):
    for p in candidates:
        for path in (p, p + ".gz"):
            if os.path.exists(path):
                return path
    raise FileNotFoundError(candidates[0])


def _mnist_native(dataset_name, train, data_root):
    """mnist / fashion-mnist from IDX files under
    ``<root>/<name>/<TVClass>/raw/``, ``<root>/<name>/raw/`` or
    ``<root>/<name>/``."""
    tv_class = {"mnist": "MNIST", "fashion-mnist": "FashionMNIST"}[dataset_name]
    prefix = "train" if train else "t10k"
    dirs = [
        os.path.join(data_root, dataset_name, tv_class, "raw"),
        os.path.join(data_root, dataset_name, "raw"),
        os.path.join(data_root, dataset_name),
    ]
    images = _idx_read(
        _find_idx([os.path.join(d, f"{prefix}-images-idx3-ubyte") for d in dirs])
    )[:, None]
    labels = _idx_read(
        _find_idx([os.path.join(d, f"{prefix}-labels-idx1-ubyte") for d in dirs])
    )
    return images, labels.astype(np.int64)


def _cifar10_native(train, data_root):
    """cifar10 from the python pickle batches (cifar-10-batches-py)."""
    import pickle

    base = os.path.join(data_root, "cifar10", "cifar-10-batches-py")
    if not os.path.isdir(base):
        base = os.path.join(data_root, "cifar10")
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    xs, ys = [], []
    for name in names:
        with open(os.path.join(base, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32))
        ys.append(np.asarray(d[b"labels"], np.int64))
    return np.concatenate(xs), np.concatenate(ys)


def _svhn_native(train, data_root):
    """svhn from the cropped-digit ``.mat`` files."""
    from scipy.io import loadmat

    split = "train" if train else "test"
    mat = loadmat(os.path.join(data_root, "svhn", f"{split}_32x32.mat"))
    images = np.transpose(mat["X"], (3, 2, 0, 1)).astype(np.uint8)
    labels = mat["y"].astype(np.int64).squeeze()
    labels[labels == 10] = 0  # torchvision's convention: the digit 0 is stored as 10
    return images, labels


_NATIVE_READERS = {
    "mnist": lambda train, root: _mnist_native("mnist", train, root),
    "fashion-mnist": lambda train, root: _mnist_native("fashion-mnist", train, root),
    "cifar10": _cifar10_native,
    "svhn": _svhn_native,
}


def _torchvision_raw(dataset_name, train, data_root):
    """uint8 (N, C, H, W) images and labels from torchvision's datasets over
    local copies (``download=False``): omniglot and celeba."""
    import torchvision
    import torchvision.transforms as transforms

    data_dir = os.path.join(data_root, dataset_name)
    if dataset_name == "omniglot":
        transform = transforms.Compose([transforms.Resize((28, 28)), transforms.ToTensor()])
        ds = torchvision.datasets.Omniglot(root=data_dir, download=False, transform=transform)
        n = len(ds)
        idx = range(0, int(n * 0.8)) if train else range(int(n * 0.8), n)
    elif dataset_name == "celeba":
        transform = transforms.Compose(
            [transforms.CenterCrop(178), transforms.Resize((64, 64)), transforms.ToTensor()]
        )
        ds = torchvision.datasets.ImageFolder(root=data_dir, transform=transform)
        n = len(ds)
        split = int(0.8 * n)
        idx = range(0, split) if train else range(split, n)
    else:
        raise ValueError(f"Unknown dataset {dataset_name}")
    images = np.stack([(np.asarray(ds[i][0]) * 255).astype(np.uint8) for i in idx])
    labels = np.asarray([ds[i][1] for i in idx])
    return images.astype(np.uint8), labels.astype(np.int64)


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
    root = data_root or os.environ.get("CMF_TPU_DATA_ROOT", "data")

    if synthetic:
        train_images, train_labels = _synthetic_raw(dataset_name, True, seed)
        test_images, test_labels = _synthetic_raw(dataset_name, False, seed)
    else:
        try:
            if dataset_name in _NATIVE_READERS:
                train_images, train_labels = _NATIVE_READERS[dataset_name](True, root)
                test_images, test_labels = _NATIVE_READERS[dataset_name](False, root)
            else:  # omniglot / celeba: image folders, through torchvision
                train_images, train_labels = _torchvision_raw(dataset_name, True, root)
                test_images, test_labels = _torchvision_raw(dataset_name, False, root)
        except Exception as e:  # torchvision raises RuntimeError where files are absent
            raise FileNotFoundError(
                f"Local copy of `{dataset_name}' not found under `{root}'. "
                "Place the torchvision-format files there, or pass "
                "synthetic=True / set CMF_TPU_SYNTHETIC_DATA=1."
            ) from e

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
