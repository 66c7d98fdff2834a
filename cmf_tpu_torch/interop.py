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
