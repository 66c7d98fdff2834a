"""Weights and the tail's permutation, drawn from the seed on the device and
loaded into the program's modules. The reference gets the same tensors."""

import torch


def draw(specs, generator, device):
    """One tensor a (leaf, shape, offset, scale) spec, offset + scale·U(−1, 1),
    from one uniform draw for all of them."""
    numels = [int(torch.Size(shape).numel()) for _, shape, _, _ in specs]
    u = torch.empty(sum(numels), device=device).uniform_(-1.0, 1.0, generator=generator)
    counts = torch.tensor(numels, device=device)
    offset = torch.repeat_interleave(torch.tensor([s[2] for s in specs], device=device), counts)
    scale = torch.repeat_interleave(torch.tensor([s[3] for s in specs], device=device), counts)
    flat = offset + scale * u
    return [t.view(shape) for t, (_, shape, _, _) in zip(torch.split(flat, numels), specs)]


def load(module, specs, tensors):
    """Copy ``tensors`` into ``module``'s parameters, which it holds in the
    order the specs list them: each leaf's name and shape must agree."""
    named = list(module.named_parameters())
    if len(named) != len(specs):
        raise ValueError(f"the program holds {len(named)} parameters, the reference {len(specs)}")
    for (name, p), (leaf, shape, _, _) in zip(named, specs):
        if name.rsplit(".", 1)[-1] != leaf or tuple(p.shape) != tuple(shape):
            raise ValueError(f"{name} {tuple(p.shape)} is not the reference's {leaf} {tuple(shape)}")
    with torch.no_grad():
        torch._foreach_copy_([p for _, p in named], list(tensors))


def set_permutation(module, perm):
    """The non-square tail's permutation and its inverse."""
    buffers = dict(module.named_buffers())
    names = [n for n in buffers if n.endswith(".permutation") or n == "permutation"]
    if len(names) != 1:
        raise ValueError(f"expected one tail permutation, found {names}")
    prefix = names[0][: -len("permutation")]
    with torch.no_grad():
        buffers[names[0]].copy_(perm)
        buffers[prefix + "inverse_permutation"].copy_(torch.argsort(perm))
