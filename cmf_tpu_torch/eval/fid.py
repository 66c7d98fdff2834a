"""Fréchet distance ("FID", the FID-like metric on raw features for tabular
data): ``cmf_tpu/eval/fid.py`` in torch.

The reference statistics come from the train loader (the test loader with
``--test-fid``). Model samples are drawn in chunks of ``test_batch_size``,
and the sums s1 = Σx and s2 = Σxxᵀ are accumulated on the device in fp32;
μ and the unbiased covariance (s2 − n·μμᵀ)/(n − 1) are read to the host in
one transfer, where scipy's ``sqrtm`` takes the d×d root. The formula and
the precision are the JAX package's, so the numbers are too: fp32 with TF32
off (``device.pin_fp32``), not fp64 and not a two-pass covariance.

Image datasets map each chunk to features first (``eval/inception.py``: the
InceptionV3, or the random-conv proxy), on the same device, and the sums are
of the features; ``fid.feature_extractor`` stamps which extractor it was.
"""

import warnings

import numpy as np
import torch


def _accumulate(batches, feature_fn=None):
    """(s1, s2, n) of the rows of ``batches`` (their features, with a
    ``feature_fn``) in fp32, on their device."""
    n, s1, s2 = 0, None, None
    for batch in batches:
        feats = batch if feature_fn is None else feature_fn(batch)
        feats = feats.reshape(feats.shape[0], -1).to(torch.float32)
        b1 = feats.sum(dim=0)
        b2 = feats.T @ feats
        s1 = b1 if s1 is None else s1 + b1
        s2 = b2 if s2 is None else s2 + b2
        n += feats.shape[0]
    return s1, s2, n


def _mean_cov(s1, s2, n):
    """μ and the unbiased covariance (``np.cov``'s ddof=1), as numpy, read
    from the device in one transfer."""
    mu = s1 / n
    cov = (s2 - n * torch.outer(mu, mu)) / (n - 1)
    host = torch.cat([mu, cov.reshape(-1)]).cpu().numpy()
    dim = mu.shape[0]
    return host[:dim], host[dim:].reshape(dim, dim)


def activation_statistics(batches_iter, feature_fn=None):
    """Streaming mean and covariance over batches: of their rows, or of
    ``feature_fn``'s (B, d) features of them."""
    return _mean_cov(*_accumulate(batches_iter, feature_fn))


def _sqrtm_real(sigma1, sigma2):
    """sqrtm(Σ₁Σ₂) if it comes out finite and (near-)real, else None."""
    from scipy import linalg

    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        return None
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            return None
        covmean = covmean.real
    return covmean


def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """d² = |μ₁−μ₂|² + tr(Σ₁+Σ₂−2(Σ₁Σ₂)^½).

    Where sqrtm goes non-finite, or drifts complex past the 1e-3 imaginary
    tolerance, the product is retried with jitter·I on both covariances at
    eps, 1e-4 and 1e-2. The level used is kept in
    ``frechet_distance.last_jitter`` (0.0: none), with a warning above eps.
    """
    diff = mu1 - mu2
    covmean = _sqrtm_real(sigma1, sigma2)
    used_jitter = 0.0
    for jitter in (eps, 1e-4, 1e-2):
        if covmean is not None:
            break
        offset = np.eye(sigma1.shape[0]) * jitter
        covmean = _sqrtm_real(sigma1 + offset, sigma2 + offset)
        used_jitter = jitter
    if covmean is None:
        raise ValueError("sqrtm(sigma1 @ sigma2) unstable even at jitter 1e-2")
    frechet_distance.last_jitter = used_jitter
    if used_jitter > eps:
        warnings.warn(
            f"frechet_distance needed jitter {used_jitter:g} (> eps {eps:g}) to "
            f"stabilize sqrtm on a {sigma1.shape[0]}-dim covariance; the score "
            "is perturbed by O(jitter*d) — treat near-floor comparisons made "
            "at different jitter levels with care.",
            stacklevel=2,
        )
    return float(
        diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)
    )


def sample_batches(density, generator, num_samples, batch_size):
    """Model samples in chunks of ``batch_size``."""
    remaining = num_samples
    while remaining > 0:
        n = min(batch_size, remaining)
        yield density.sample(n, generator=generator)
        remaining -= n


def get_fid_function(config, reference_loader, feature_fn=None):
    """The reference statistics, computed now; returns
    ``fid(density, generator) -> float``.

    The reference pass iterates ``reference_loader``: the train loader's
    shuffle counter moves on by one, as in the JAX package, so the first
    training epoch takes permutation (seed, 1). It runs under
    ``torch.no_grad()``, not inference mode: the loader caches its device
    copy of the data on first use, and an inference tensor there would fail
    the first training step. A FID draws ``num_fid_samples // test_batch_size``
    chunks (at least one) of ``test_batch_size`` samples, as the JAX
    package's scan does, under inference mode (the ResNet couplers take the
    coupler kernel), maps each chunk to its features on the device where
    there is a ``feature_fn``, and reads the host once.
    """
    with torch.no_grad():
        ref_mu, ref_cov = activation_statistics(iter(reference_loader), feature_fn)
    batch_size = config["test_batch_size"]
    n_batches = max(config["num_fid_samples"] // batch_size, 1)

    def fid(density, generator):
        with torch.inference_mode():
            samples = sample_batches(density, generator, n_batches * batch_size, batch_size)
            mu, cov = _mean_cov(*_accumulate(samples, feature_fn))
        score = frechet_distance(ref_mu, ref_cov, mu, cov)
        fid.last_jitter = frechet_distance.last_jitter
        return score

    fid.feature_extractor = (
        "raw-features" if feature_fn is None else getattr(feature_fn, "extractor_kind", "unknown")
    )
    return fid
