"""Importance-sampled evaluation metrics (``cmf_tpu/eval/metrics.py`` in
torch).

log p(x) ≈ logsumexp_K(elbo samples) − log K, bits per dimension and the
elbo gap. The K samples run one after another with a streaming logsumexp,
so peak memory is one batch whatever K is. They draw from ``generator`` (a
``torch.Generator`` on the data's device, the dequantization noise and the
Hutchinson probes), as the JAX package folds one key a sample.
"""

import math

import torch


def metrics(density, x, num_elbo_samples, generator=None, train=False, draws=None):
    """{"elbo", "log-prob", "bpd", "elbo-gap"}, each (B,). With K = 1, or
    no generator and no ``draws`` (the elbo is then deterministic, so all K
    samples coincide), the single elbo. ``draws``, where given, holds one
    dict of the elbo's draws a sample (``u_noise``, ``dequantization_noise``),
    as the parity tests pass the JAX package's."""
    dim = math.prod(x.shape[1:])
    k = int(num_elbo_samples)

    def one_sample(i):
        kw = {} if draws is None else draws[i]
        return density.elbo(x, train=train, generator=generator, **kw)["elbo"]

    if k == 1 or (generator is None and draws is None):
        elbo = log_prob = one_sample(0)
    else:
        running_max = torch.full((x.shape[0],), -math.inf, dtype=x.dtype, device=x.device)
        sum_exp = torch.zeros_like(running_max)
        sum_elbo = torch.zeros_like(running_max)
        for i in range(k):
            e = one_sample(i)
            new_max = torch.maximum(running_max, e)
            sum_exp = sum_exp * torch.exp(running_max - new_max) + torch.exp(e - new_max)
            running_max = new_max
            sum_elbo = sum_elbo + e
        elbo = sum_elbo / k
        log_prob = running_max + torch.log(sum_exp) - math.log(k)

    return {
        "elbo": elbo,
        "log-prob": log_prob,
        "bpd": -log_prob / dim / math.log(2.0),
        "elbo-gap": log_prob - elbo,
    }
