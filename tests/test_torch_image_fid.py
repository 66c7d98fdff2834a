"""FID on image features in the port (``cmf_tpu_torch/eval/fid.py`` with
``eval/inception.py``'s proxy) against the JAX package's
(``cmf_tpu/eval/fid.py`` with ``_proxy_feature_fn``): the same proxy
weights, the same reference images and the same sample images give the same
FID; and a FID pass of the mnist model sends every coupling of every chunk
through the coupler kernel's wrapper, while its reference pass sends none.
Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cmf_tpu.config import expand_grid, get_config, get_schema
from cmf_tpu.data.image import _synthetic_raw
from cmf_tpu.eval import fid as jax_fid
from cmf_tpu.eval.inception import _proxy_feature_fn
from cmf_tpu_torch.eval import fid, inception
from cmf_tpu_torch.interop import proxy_weights_from_jax
from cmf_tpu_torch.models import get_density
from cmf_tpu_torch.ops import coupler_stack as cs

from test_torch_inception import jax_proxy_weights

FID_DIMS = 256  # 16 channels × 4 cells: 64 features
SHAPE = (1, 28, 28)


class _JaxImages:
    """Images 255·sigmoid(z + shift), z the JAX FID's draws."""

    def sample(self, variables, rng, num_samples):
        return 255.0 * jax.nn.sigmoid(jax.random.normal(rng, (num_samples, *SHAPE)) + variables)


class _TorchImages:
    """The same images from the same z, replayed chunk by chunk."""

    def __init__(self, noise, shift):
        self.noise, self.shift, self.drawn = noise, shift, []

    def sample(self, num_samples, generator=None):
        z = torch.tensor(self.noise[len(self.drawn)])
        assert z.shape[0] == num_samples and torch.is_inference_mode_enabled()
        self.drawn.append(num_samples)
        return 255.0 * torch.sigmoid(z + self.shift)


def test_image_fid_matches_cmf_tpu():
    config = {"num_fid_samples": 300, "test_batch_size": 100}
    ref = _synthetic_raw("mnist", True, seed=0, max_n=250)[0].astype(np.float32)
    ref_chunks = [ref[i : i + 100] for i in range(0, 250, 100)]
    key, shift = jax.random.PRNGKey(7), 0.3

    fid_j = jax_fid.get_fid_function(config, [jnp.asarray(c) for c in ref_chunks], _proxy_feature_fn(FID_DIMS))
    want = fid_j(_JaxImages(), shift, key)

    noise = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sub, (100, *SHAPE))))
    images = _TorchImages(noise, shift)
    features = proxy_weights_from_jax(*jax_proxy_weights(FID_DIMS))
    fid_t = fid.get_fid_function(config, [torch.tensor(c) for c in ref_chunks], features)
    got = fid_t(images, torch.Generator())
    assert images.drawn == [100, 100, 100]
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert fid_t.feature_extractor == fid_j.feature_extractor == "proxy"
    assert fid_t.last_jitter == fid_j.last_jitter


def test_image_statistics_match_cmf_tpu():
    x = _synthetic_raw("fashion-mnist", False, seed=0, max_n=120)[0].astype(np.float32)
    chunks = [x[i : i + 50] for i in range(0, 120, 50)]
    mu_j, cov_j = jax_fid.activation_statistics(iter([jnp.asarray(c) for c in chunks]),
                                                _proxy_feature_fn(FID_DIMS))
    features = proxy_weights_from_jax(*jax_proxy_weights(FID_DIMS))
    mu_t, cov_t = fid.activation_statistics(iter([torch.tensor(c) for c in chunks]), features)
    assert mu_t.shape == (64,) and cov_t.shape == (64, 64)
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-5, atol=1e-5 * np.abs(mu_j).max())
    np.testing.assert_allclose(cov_t, cov_j, rtol=1e-4, atol=1e-5 * np.abs(cov_j).max())


def test_fid_pass_sends_every_coupling_through_the_coupler_kernel():
    """10 couplings a ``sample`` call, 3 chunks a pass: 30 calls of the
    coupler kernel's wrapper (on the card, 30 launches). The reference pass
    runs under ``no_grad``: the model is not sampled there."""
    config = expand_grid(get_config("mnist", "non-square", use_baseline=False))[0]
    config.update(g_hidden_channels=[4], prior_hidden_channels=[8], prior_num_density_layers=2,
                  latent_dimension=4)
    density = get_density(get_schema(config), x_shape=SHAPE, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    ref = _synthetic_raw("mnist", True, seed=0, max_n=40)[0].astype(np.float32)
    cs.reset_launch_counts()
    fid_fn = fid.get_fid_function({"num_fid_samples": 14, "test_batch_size": 4},
                                  [torch.tensor(ref[:20]), torch.tensor(ref[20:])],
                                  inception.ProxyFeatures(*inception.proxy_weights(FID_DIMS)))
    assert cs.CALLS == 0
    score = fid_fn(density, torch.Generator().manual_seed(1))
    assert cs.CALLS == 10 * 3  # 14 // 4 chunks of 4, as the JAX package's scan
    assert cs.LAUNCHES == 0  # the plain version on the CPU
    assert np.isfinite(score) and fid_fn.feature_extractor == "proxy"
