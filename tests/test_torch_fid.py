"""The port's Fréchet distance (``cmf_tpu_torch/eval/fid.py``) against the
JAX package's (``cmf_tpu/eval/fid.py``): the streaming statistics, the
distance with its jitter ladder, and the FID of one model's converted
weights on the same latent noise. Inputs come from numpy seeds."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.eval import fid as jax_fid
from cmf_tpu_torch.data import ArrayLoader
from cmf_tpu_torch.densities import DiagonalGaussianDensity
from cmf_tpu_torch.eval import fid

from _torch_parity import DIM, build_pair, small_config, small_schema


def _correlated(n, d, seed):
    """Rows of a correlated Gaussian with a nonzero mean: no covariance
    entry is near zero, so each one is held to the relative tolerance."""
    r = np.random.default_rng(seed)
    mix = r.normal(size=(d, d)) / np.sqrt(d) + np.eye(d)
    return (r.normal(size=(n, d)) @ mix + r.normal(size=d)).astype(np.float32)


def test_activation_statistics_match_cmf_tpu():
    data = _correlated(350, 7, seed=0)
    chunks = [data[i : i + 100] for i in range(0, 350, 100)]  # a short last chunk
    mu_j, cov_j = jax_fid.activation_statistics(iter([jnp.asarray(c) for c in chunks]))
    mu_t, cov_t = fid.activation_statistics(iter([torch.tensor(c) for c in chunks]))
    assert mu_t.dtype == cov_t.dtype == np.float32
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-5)
    np.testing.assert_allclose(cov_t, cov_j, rtol=1e-5)


def _rank_deficient(scale, d=128, n=40, seed=0):
    """tests/test_eval.py:74's construction: fewer samples than features, so
    sqrtm drifts complex without going non-finite. At its own arguments
    (scale 30) the ladder's first step mends it; larger scales need more."""
    r = np.random.default_rng(seed)
    a = r.normal(size=(n, d)) * scale
    b = r.normal(size=(n, d)) * scale * 1.2 + scale * 0.05
    return a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False)


def _full_rank():
    a, b = _correlated(400, 9, seed=1), _correlated(400, 9, seed=2)
    return a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False)


# (case, the jitter both packages must settle on)
LADDER = {
    "full-rank": (_full_rank, 0.0),
    "near-singular": (lambda: _rank_deficient(30.0), 1e-6),
    "jitter-1e-4": (lambda: _rank_deficient(100.0, seed=3), 1e-4),
    "jitter-1e-2": (lambda: _rank_deficient(300.0, d=64, n=8, seed=1), 1e-2),
}


@pytest.mark.parametrize("name", list(LADDER))
def test_frechet_distance_matches_cmf_tpu(name):
    case, jitter = LADDER[name]
    args = case()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = jax_fid.frechet_distance(*args)
        want_jitter = jax_fid.frechet_distance.last_jitter
        n_jax = len(caught)
        got = fid.frechet_distance(*args)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert fid.frechet_distance.last_jitter == want_jitter == jitter
    # The warning above eps, from both packages alike.
    assert len(caught) == 2 * n_jax == (2 if jitter > 1e-6 else 0)


def test_frechet_distance_unstable_raises_in_both():
    args = _rank_deficient(1000.0, d=64, n=8, seed=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="unstable even at jitter 1e-2"):
            jax_fid.frechet_distance(*args)
        with pytest.raises(ValueError, match="unstable even at jitter 1e-2"):
            fid.frechet_distance(*args)


def _jax_fid_noise(key, n_batches, batch_size, latent):
    """The latent noise the JAX FID's scan draws: one split a chunk, the
    chunk's key passed unsplit down to the Gaussian."""
    noise = []
    for _ in range(n_batches):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sub, (batch_size, latent))))
    return noise


def test_fid_matches_cmf_tpu_on_same_noise(monkeypatch):
    schema = small_schema()
    jd, jv, td = build_pair(schema, seed=4)
    config = {"num_fid_samples": 130, "test_batch_size": 40}  # 3 chunks: 10 samples dropped, as in the scan
    ref = _correlated(90, DIM, seed=5)
    ref_chunks = [ref[i : i + 40] for i in range(0, 90, 40)]

    fid_j = jax_fid.get_fid_function(config, [jnp.asarray(c) for c in ref_chunks])
    key = jax.random.PRNGKey(11)
    want = fid_j(jd, jv, key)

    noise = _jax_fid_noise(key, 3, 40, small_config()["latent_dimension"])
    drawn = []

    def replay(self, num_samples, generator=None):
        z = torch.tensor(noise[len(drawn)])
        assert z.shape[0] == num_samples
        drawn.append(num_samples)
        return z

    monkeypatch.setattr(DiagonalGaussianDensity, "_sample", replay)
    fid_t = fid.get_fid_function(config, [torch.tensor(c) for c in ref_chunks])
    got = fid_t(td, torch.Generator())
    assert drawn == [40, 40, 40]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert fid_t.feature_extractor == fid_j.feature_extractor == "raw-features"
    assert fid_t.last_jitter == fid_j.last_jitter


def test_reference_pass_leaves_the_train_loader_trainable():
    """The reference statistics fill the loader's device copy outside
    inference mode, and move its shuffle counter on by one."""
    x = _correlated(30, 4, seed=6)
    loader = ArrayLoader(x, 10, "cpu", shuffle=True, drop_last=True, seed=2)
    fid.get_fid_function({"num_fid_samples": 10, "test_batch_size": 10}, loader)
    assert not loader._x_dev.is_inference()
    assert loader._epoch == 1
    w = torch.ones(4, requires_grad=True)
    (next(iter(loader)) * w).sum().backward()  # autograd may save the batch
    assert w.grad is not None
