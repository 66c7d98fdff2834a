"""Load the JAX package's variables into the port's modules.

``variables_from_jax(density, tree)`` takes a ``{"params", "state"}`` tree of
numpy arrays (nested dicts and lists, as ``cmf_tpu``'s ``init`` returns it,
converted leaf by leaf with ``np.asarray``) and copies every leaf into the
matching parameter (``params``) or persistent buffer (``state``) of
``density``. The port's module attributes carry the JAX tree's keys, so the
dotted paths agree, with one exception: ``ChunkedSharedCoupler`` keeps its
net as ``.net`` while the JAX coupler's params are the net's own.

The state comes across too: the tail's ``permutation`` /
``inverse_permutation`` above all, since a permutation drawn anew would
silently give another model. Every leaf on both sides must be matched, in
shape, or this raises.

The FID's feature extractors come across too: ``proxy_weights_from_jax``
gives the port's random-conv proxy the JAX package's three conv weights, and
``inception_from_npz`` loads the JAX package's InceptionV3 ``.npz`` into the
port's network, validated first.
"""

import numpy as np
import torch


def flatten_tree(tree, prefix=""):
    """Nested dicts / lists → {dotted path: numpy leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}."))
    return out


def jax_path(torch_name):
    """The JAX tree path of a port parameter or buffer name."""
    return torch_name.replace("coupler.net.", "coupler.")


def variables_from_jax(density, tree):
    """Copy ``tree`` into ``density`` in place; returns ``density``."""
    param_names = {name for name, _ in density.named_parameters()}
    targets = {"params": {}, "state": {}}
    for name, tensor in density.state_dict(keep_vars=True).items():
        kind = "params" if name in param_names else "state"
        targets[kind][jax_path(name)] = tensor
    with torch.no_grad():
        for kind in ("params", "state"):
            leaves = flatten_tree(tree[kind])
            missing = sorted(set(targets[kind]) - set(leaves))
            unexpected = sorted(set(leaves) - set(targets[kind]))
            if missing or unexpected:
                raise KeyError(
                    f"{kind} trees differ: missing from the JAX tree {missing}, "
                    f"not in the port {unexpected}"
                )
            for path, value in leaves.items():
                t = targets[kind][path]
                if tuple(value.shape) != tuple(t.shape):
                    raise ValueError(f"{kind} `{path}': shape {value.shape} vs {tuple(t.shape)}")
                t.copy_(torch.tensor(value, dtype=t.dtype))
    return density


def proxy_weights_from_jax(w1, w2, w3):
    """The port's random-conv proxy over the JAX package's weights (numpy
    arrays, OIHW, as ``cmf_tpu/eval/inception.py`` draws them)."""
    from .eval.inception import ProxyFeatures

    return ProxyFeatures(*(np.array(w, np.float32) for w in (w1, w2, w3)))


def inception_from_npz(path):
    """The port's InceptionV3 (on the CPU, in eval mode) over the weights of
    a ``.npz`` in the JAX package's layout; ``validate_params`` first."""
    from .eval.inception_v3 import InceptionV3

    with np.load(path) as raw:
        arrays = {k: raw[k] for k in raw.files}
    return InceptionV3.from_state_dict(arrays)
