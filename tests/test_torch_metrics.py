"""The port's importance-sampled metrics (``cmf_tpu_torch/eval/metrics.py``)
against the JAX package's ``metrics``: on the sphere model (its published
schema at full width, with the JAX weights perturbed and carried across), at
K = 1 and K > 1, where its deterministic exact elbo makes every sample the
same; and the streaming logsumexp at K > 1 against a direct logsumexp of the
same draws, on a density whose elbo is random."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.eval.metrics import metrics as jax_metrics
from cmf_tpu_torch.densities import Density
from cmf_tpu_torch.eval.metrics import metrics

from _torch_parity import t
from _sphere_pair import sphere_pair

TOL = 1e-5  # fp32 both sides, sums in another order


@pytest.mark.parametrize("k", [1, 4])
def test_sphere_metrics_match_cmf_tpu(k):
    jd, jv, td, x = sphere_pair("sphere", seed=1, n=64)
    want = jax_metrics(jd, jv, jnp.asarray(x), k, rng=jax.random.PRNGKey(0))
    got = metrics(td, t(x), k, generator=torch.Generator().manual_seed(0))
    for key in ("elbo", "log-prob", "bpd", "elbo-gap"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].detach().numpy(), w, rtol=TOL, atol=TOL * max(1.0, np.abs(w).max()),
                                   err_msg=key)


class _NoisyElbo(Density):
    """elbo = -|x|² + 3·N(0, 1) a row, drawn from the caller's generator."""

    def elbo(self, x, train=False, generator=None, **kw):
        noise = torch.randn(x.shape[0], generator=generator, dtype=x.dtype)
        return {"elbo": -(x ** 2).sum(dim=1) + 3.0 * noise}


def test_streaming_logsumexp_matches_a_direct_one():
    x = t(np.random.default_rng(2).normal(size=(16, 3)).astype(np.float32))
    density, k = _NoisyElbo(), 7
    got = metrics(density, x, k, generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    samples = torch.stack([density.elbo(x, generator=gen)["elbo"] for _ in range(k)])
    log_prob = torch.logsumexp(samples, dim=0) - math.log(k)
    torch.testing.assert_close(got["log-prob"], log_prob, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(got["elbo"], samples.mean(dim=0), rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(got["elbo-gap"], log_prob - samples.mean(dim=0), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got["bpd"], -log_prob / 3 / math.log(2.0), rtol=1e-6, atol=1e-5)
    assert bool((got["elbo-gap"] >= -1e-5).all())  # Jensen


def test_one_sample_without_a_generator():
    """K > 1 with no generator gives the single elbo, as the JAX package
    does with no key."""
    x = t(np.ones((4, 3), np.float32))
    density = _NoisyElbo()
    torch.manual_seed(0)
    got = metrics(density, x, 5)
    torch.manual_seed(0)
    want = density.elbo(x)["elbo"]
    torch.testing.assert_close(got["log-prob"], want)
    torch.testing.assert_close(got["elbo-gap"], torch.zeros(4))
