"""Training rows drawn on the device from the seed."""

import torch


def tabular_mixture(rows, dim, generator, device, components=4):
    """The port's synthetic tabular stand-in (a mixture of ``components``
    correlated Gaussians: means N(0, 4), factors N(0, 0.09/dim)), at
    ``rows`` rows, standardised per feature."""
    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=device)

    means = normal(components, dim) * 2
    factors = normal(components, dim, dim) * (0.3 / dim**0.5)
    comp = torch.randint(0, components, (rows,), generator=generator, device=device)
    eps = normal(rows, dim)
    x = means[comp]
    for k in range(components):
        x = x + (comp == k)[:, None] * (eps @ factors[k].T)
    return (x - x.mean(0)) / x.std(0, correction=0)
