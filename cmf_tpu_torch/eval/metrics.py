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


def metrics(density, x, num_elbo_samples, generator=None, train=False):
    """{"elbo", "log-prob", "bpd", "elbo-gap"}, each (B,). With K = 1, or
    no generator (the elbo is then deterministic, so all K samples
    coincide), the single elbo."""
    dim = math.prod(x.shape[1:])
    k = int(num_elbo_samples)

    def one_sample():
        return density.elbo(x, train=train, generator=generator)["elbo"]

    if generator is None or k == 1:
        elbo = log_prob = one_sample()
    else:
        running_max = torch.full((x.shape[0],), -math.inf, dtype=x.dtype, device=x.device)
        sum_exp = torch.zeros_like(running_max)
        sum_elbo = torch.zeros_like(running_max)
        for _ in range(k):
            e = one_sample()
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
