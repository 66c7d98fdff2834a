"""The port's FID feature extractors (``cmf_tpu_torch/eval/inception.py``,
``eval/inception_v3.py``) against the JAX package's
(``cmf_tpu/eval/inception.py``, ``eval/inception_jax.py``): the random-conv
proxy on the JAX package's own weights at 28, 32 and 64 pixels, the
InceptionV3 on ``random_state_dict(0)``, the pre-processing pipeline against
the golden features, the weight checks and the order in which the feature
function is resolved. Inputs come from numpy seeds."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.eval import inception as jax_inception
from cmf_tpu.eval.inception_jax import inception_pool3_features
from cmf_tpu.eval.inception_jax import random_state_dict as jax_random_state_dict
from cmf_tpu.eval.inception_jax import state_dict_spec as jax_state_dict_spec
from cmf_tpu_torch.eval import inception, inception_v3
from cmf_tpu_torch.interop import inception_from_npz, proxy_weights_from_jax

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "inception_pipeline_golden.npz")
# fp32 both sides, the convolutions summing in their own order: error over
# the largest feature.
PROXY_TOL = 1e-5
INCEPTION_TOL = 1e-4


def jax_proxy_weights(fid_dims, seed=0):
    """The JAX package's proxy weights, drawn by its recipe
    (inception.py:30-34)."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    shapes = [(32, 3, 5, 5), (64, 32, 3, 3), (fid_dims // 16, 64, 3, 3)]
    return [np.asarray(jax.random.normal(k, s) * 0.2) for k, s in zip((k1, k2, k3), shapes)]


def _rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("pixels", [28, 32, 64])
def test_proxy_matches_cmf_tpu(pixels, channels):
    """SAME padding at stride 2 is asymmetric in XLA ((1, 2) for the 5×5 conv
    at 28 pixels): a symmetric pad would shift every feature."""
    x = np.random.default_rng(pixels + channels).integers(0, 256, (3, channels, pixels, pixels))
    x = x.astype(np.float32)
    want = np.asarray(jax_inception._proxy_feature_fn(2048)(jnp.asarray(x)))
    got = proxy_weights_from_jax(*jax_proxy_weights(2048))(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (3, 512)
    assert _rel_err(got, want) <= PROXY_TOL


@pytest.mark.parametrize("n,k,stride,pads", [(28, 5, 2, (1, 2)), (14, 3, 2, (0, 1)), (7, 3, 2, (1, 1)),
                                             (32, 5, 2, (1, 2)), (16, 3, 1, (1, 1))])
def test_same_padding_is_xla_s(n, k, stride, pads):
    assert inception.same_padding(n, k, stride) == pads


def test_port_proxy_weights_are_seeded_draws_at_cmf_tpu_s_shapes():
    a, b = inception.proxy_weights(2048, seed=0), inception.proxy_weights(2048, seed=0)
    assert [tuple(w.shape) for w in a] == [tuple(w.shape) for w in jax_proxy_weights(2048)]
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], inception.proxy_weights(2048, seed=1)[0])
    assert abs(float(torch.cat([w.reshape(-1) for w in a]).std()) - 0.2) < 0.01


def test_inception_v3_matches_cmf_tpu():
    sd = jax_random_state_dict(0)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 3, 299, 299)).astype(np.float32)
    want = np.asarray(inception_pool3_features({k: jnp.asarray(v) for k, v in sd.items()}, jnp.asarray(x)))
    model = inception_v3.InceptionV3.from_state_dict(inception_v3.random_state_dict(0))
    with torch.no_grad():
        got = model(torch.tensor(x)).numpy()
    assert got.shape == (2, 2048)
    assert _rel_err(got, want) <= INCEPTION_TOL


def test_spec_and_fixture_equal_cmf_tpu_s():
    assert inception_v3.state_dict_spec() == jax_state_dict_spec()
    ours, theirs = inception_v3.random_state_dict(3), jax_random_state_dict(3)
    assert all(np.array_equal(ours[k], theirs[k]) for k in theirs) and set(ours) == set(theirs)


def test_pipeline_matches_the_golden_features(tmp_path):
    """cmf_tpu's golden path: a torch state_dict → ``convert_torch_weights``
    → ``.npz`` → ``load_feature_fn``; uint8 grayscale → tile → 299 →
    [-1, 1] → pool3 (``tests/test_eval.py``'s tolerance)."""
    sd = {k: torch.from_numpy(v) for k, v in inception_v3.random_state_dict(0).items()}
    pth, npz = str(tmp_path / "inception.pth"), str(tmp_path / "inception.npz")
    torch.save(sd, pth)
    inception_v3.convert_torch_weights(pth, npz)
    features = inception_v3.load_feature_fn(npz)
    assert features.extractor_kind == "inception-jax"
    x = np.random.default_rng(42).integers(0, 256, (4, 1, 28, 28)).astype(np.float32)
    with torch.no_grad():
        got = features(torch.tensor(x)).numpy()
    golden = np.load(GOLDEN)["features"]
    assert got.shape == (4, 2048)
    np.testing.assert_allclose(got, golden, rtol=2e-3, atol=2e-3)


def test_validate_params_rejects_bad_dicts(tmp_path):
    sd = inception_v3.random_state_dict(0)
    inception_v3.validate_params(sd)
    missing = dict(sd)
    missing.pop("Mixed_7c.branch_pool.conv.weight")
    with pytest.raises(ValueError, match="missing"):
        inception_v3.validate_params(missing)
    bad_shape = dict(sd)
    bad_shape["Conv2d_1a_3x3.conv.weight"] = np.zeros((1, 1, 1, 1), np.float32)
    with pytest.raises(ValueError, match="shape"):
        inception_v3.validate_params(bad_shape)
    extra = {**sd, "fc.weight": np.zeros((1000, 2048), np.float32)}
    with pytest.raises(ValueError, match="unexpected"):
        inception_v3.validate_params(extra)
    npz = str(tmp_path / "bad.npz")
    np.savez(npz, **missing)
    with pytest.raises(ValueError, match="missing"):
        inception_from_npz(npz)


def test_feature_fn_order(tmp_path, monkeypatch, capsys):
    """Without weights the proxy, with cmf_tpu's warning, once; with
    ``CMF_TPU_INCEPTION_WEIGHTS`` the port's InceptionV3 over that file."""
    monkeypatch.delenv("CMF_TPU_INCEPTION_WEIGHTS", raising=False)
    monkeypatch.setattr(inception, "_WARNED", False)
    proxy = inception.get_feature_fn({"fid_dims": 2048})
    assert proxy.extractor_kind == "proxy"
    assert "random-conv proxy" in capsys.readouterr().out
    inception.get_feature_fn({"fid_dims": 2048})
    assert capsys.readouterr().out == ""
    x = torch.zeros(2, 1, 28, 28)
    assert tuple(proxy(x).shape) == (2, 512)

    npz = str(tmp_path / "inception.npz")
    np.savez(npz, **inception_v3.random_state_dict(0))
    monkeypatch.setenv("CMF_TPU_INCEPTION_WEIGHTS", npz)
    features = inception.get_feature_fn({"fid_dims": 2048})
    assert features.extractor_kind == "inception-jax"
    assert isinstance(features.network, inception_v3.InceptionV3)
