"""The image half of the port's metric analysis
(``cmf_tpu_torch/viz/metric_analysis.py``) against the JAX package's
(``cmf_tpu/viz/metric_analysis.py``), on the mnist non-square schema at
x_shape (1, 8, 8) with ResNet couplers of width 8 and d = 20 (the JAX weights
carried across by ``interop``), at 32 images; and the two-dim manifold grid
on the same schema at d = 2.

The JAX side is computed once per module: its image metric visualiser (the
g_kk and latent-variance sorts and MACS, as its JSON payload and scalar,
and every array it draws, recorded at ``Axes.imshow``), the three
prominent-z grids from ``PRNGKey(14545)`` (the port's functions are given
the same draws), the effective-z curves and the per-dimension FID, and the
centering visualiser's drawn arrays. The JAX package scores the effective-z
FID on raw pixels, which raises ``ValueError`` on images in both packages
(the covariance of decodes from k < d latents is near rank k, and its fp32
eigenvalues fall below the last jitter); the curves are held on the means
of the four image quarters, where the FID is well posed, and the raw-pixel
fault is held as the same raise at the same point.

Tolerances: data-space arrays 1e-5 relative and 1e-5 × 256 absolute (the
existing ``SAMPLE_TOL``; 1e-5 absolute on arrays drawn in [0, 1]); g_kk and
MACS 1e-4 relative (fp32 JVPs through ten ResNet couplers, each side summing
in its own order); reconstruction MSE 1e-5 relative; FID 1e-3 relative.
TensorBoard is blocked (importing it pulls in TensorFlow where that is
installed)."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from matplotlib.axes import Axes

from cmf_tpu.config import expand_grid, get_config, get_schema
from cmf_tpu.models import get_density as jax_get_density
from cmf_tpu.training.experiment import describe_density as jax_describe_density
from cmf_tpu.viz import metric_analysis as jma
from cmf_tpu_torch.interop import variables_from_jax
from cmf_tpu_torch.models import get_density
from cmf_tpu_torch.nets import ResNet
from cmf_tpu_torch.ops import coupler_stack as cs
from cmf_tpu_torch.training import describe_density, two_dim_manifold_grid
from cmf_tpu_torch.viz import metric_analysis as ma

from _torch_parity import t, to_numpy

X_SHAPE = (1, 8, 8)
N = 32
LATENT = 20
SAMPLE_TOL = 1e-5
METRIC_TOL = 1e-4
RECON_TOL = 1e-5
FID_TOL = 1e-3
# cumulative_dim_fid: two batches of 32 decodes for each k.
FID_BATCH = 32
FID_BATCHES = 2
RAW_FID_FAULT = "unstable even at jitter 1e-2"


def mnist_config(**overrides):
    config = expand_grid(get_config("mnist", "non-square", use_baseline=False))[0]
    return {**config, "model": "non-square", "dataset": "mnist", **overrides}


def _pool_jax(x):
    """The mean of each 4×4 quarter of an 8×8 image: 4 features."""
    return x.reshape(x.shape[0], 1, 2, 4, 2, 4).mean(axis=(3, 5)).reshape(x.shape[0], -1)


def _pool_torch(x):
    return F.adaptive_avg_pool2d(x, 2).flatten(1)


class _Writer:
    """What a visualiser writes, as the JAX package's writer is given it."""

    def __init__(self):
        self.json, self.scalars, self.figures = {}, {}, []

    def write_json(self, tag, data):
        self.json[tag] = data

    def write_scalar(self, tag, value, global_step=None):
        self.scalars[tag] = (value, global_step)

    def write_figure(self, tag, figure, global_step=None):
        self.figures.append((tag, global_step))


def _drawn(mp, arrays):
    """Record every array given to ``Axes.imshow``, as float64."""
    real = Axes.imshow

    def imshow(ax, X, *args, **kw):
        arrays.append(np.asarray(X, dtype=np.float64))
        return real(ax, X, *args, **kw)

    mp.setattr(Axes, "imshow", imshow)


def _jitted(jd):
    """``jd`` with its decode, fixed sample and encode jitted: the analyses
    call them eagerly, and an eager JAX call costs seconds at each new
    shape on a CPU."""
    jd.decode = jax.jit(jd.decode, static_argnames="train")
    jd.fixed_sample = jax.jit(jd.fixed_sample)
    jd.extract_latent = jax.jit(jd.extract_latent, static_argnames="earliest")
    return jd


def _files(folder):
    return sorted(os.path.relpath(os.path.join(d, f), folder) for d, _, fs in os.walk(folder) for f in fs)


def _jax_prominent_noise(d):
    rng = jax.random.PRNGKey(ma.PROMINENT_Z_SEED)
    width = max(len(g) for g in jma._subgroup_latents(np.arange(d), d))
    return (np.asarray(jax.random.normal(rng, (10, d))), np.asarray(jax.random.normal(rng, (8, width))))


def _jax_fid_noise(rng, d):
    """The draws of cmf_tpu's cumulative_dim_fid: a batch from each split."""
    key, out = rng, []
    for _ in range(FID_BATCHES):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (FID_BATCH, d))))
    return np.concatenate(out)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    schema = get_schema(mnist_config(g_hidden_channels=[8], prior_hidden_channels=[8]))
    jd = jax_get_density(schema, x_shape=X_SHAPE)
    jv = jd.init(jax.random.PRNGKey(0))
    td = get_density(schema, x_shape=X_SHAPE, device="cpu")
    variables_from_jax(td, to_numpy(jv))
    jd = _jitted(jd)
    x = np.random.default_rng(0).integers(0, 256, size=(N, *X_SHAPE)).astype(np.float32)
    xj = jnp.asarray(x)

    folder = str(tmp_path_factory.mktemp("jax_metric"))
    writer, drawn, centering = _Writer(), [], []
    with pytest.MonkeyPatch.context() as mp:
        _drawn(mp, drawn)
        with pytest.raises(ValueError, match=RAW_FID_FAULT) as raised:
            jma.ImageMetricDensityVisualizer(writer, x).visualize(jd, jv, 0, write_folder=folder)
    with pytest.MonkeyPatch.context() as mp:
        _drawn(mp, centering)
        jma.ImageCenteringDensityVisualizer(_Writer(), x).visualize(jd, jv, 0)

    order = np.asarray(writer.json["metric_analysis_epoch0"]["latent_variance_order"])
    noise, seeds = _jax_prominent_noise(LATENT)
    rng = jax.random.PRNGKey(5)
    grids = {}
    for name, fn in (("samples_cumulative", jma.prominent_z_cumulative),
                     ("samples_sequential", jma.prominent_z_combined),
                     ("samples_hierarchical", jma.prominent_z_hierarchical)):
        imgs, nrow = fn(jd, jv, order, jax.random.PRNGKey(ma.PROMINENT_Z_SEED))
        grids[name] = (np.asarray(imgs), nrow)
    recon, fid = jma.effective_z_curves(jd, jv, xj, order, feature_fn=_pool_jax)
    curve = jma.cumulative_dim_fid(jd, jv, x, rng, order, feature_fn=_pool_jax,
                                   num_samples=FID_BATCH * FID_BATCHES, batch_size=FID_BATCH)
    return {
        "td": td, "x": x, "z": np.asarray(jd.extract_latent(jv, xj)), "order": order,
        "writer": writer, "drawn": drawn, "centering": centering, "files": _files(folder),
        "raised": str(raised.value), "noise": noise, "seeds": seeds, "grids": grids,
        "recon": recon, "fid": fid, "fid_noise": _jax_fid_noise(rng, LATENT), "curve": curve,
    }


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def _images_close(got, want):
    np.testing.assert_allclose(got, want, rtol=SAMPLE_TOL, atol=SAMPLE_TOL * 256)


def test_sorts_and_macs_match_the_jax_payload(case):
    td, payload = case["td"], case["writer"].json["metric_analysis_epoch0"]
    z = ma.encode(td, t(case["x"]))
    _close(z.numpy(), case["z"], METRIC_TOL)
    g_sorted, g_order = ma.g_kk_sort(td, z)
    _close(g_sorted, payload["g_kk_sorted"], METRIC_TOL)
    np.testing.assert_array_equal(g_order, payload["g_kk_order"])
    var_sorted, var_order, cumfrac = ma.latent_variance_sort(td, t(case["x"]))
    _close(var_sorted, payload["latent_variance_sorted"], METRIC_TOL)
    np.testing.assert_array_equal(var_order, payload["latent_variance_order"])
    _close(cumfrac, payload["cumulative_variance"], METRIC_TOL)
    value, cos = ma.macs(td, z)
    assert value == pytest.approx(payload["macs"], rel=METRIC_TOL)
    _close(cos, case["drawn"][0], METRIC_TOL)


def test_decoder_jacobian_takes_the_conv_modules_and_a_jvp_never_reaches_the_kernel(case):
    """``torch.func.jvp`` leaves inference mode, so the Jacobian takes the
    conv modules even when called inside it; the coupler's wrapper raises
    on a tensor that carries a tangent."""
    td = case["td"]
    z = ma.encode(td, t(case["x"][:2]))
    cs.reset_launch_counts()
    jac = ma.decoder_jacobian(td, z)
    with torch.inference_mode():
        again = ma.decoder_jacobian(td, z)
    assert cs.CALLS == 0
    assert torch.equal(again, jac)
    net = next(m for m in td.modules() if isinstance(m, ResNet))
    x = torch.randn(2, net.conv_in.w.shape[1], *X_SHAPE[1:])
    with pytest.raises(RuntimeError, match="no forward-mode"):
        torch.func.jvp(lambda a: cs.fused_resnet_coupler(a, net.kernel_params()), (x,), (x,))
    with pytest.raises(RuntimeError, match="no forward-mode"):
        torch.func.vmap(lambda a: cs.fused_resnet_coupler(a, net.kernel_params()))(x[:, None])
    assert cs.CALLS == 0


def test_prominent_z_grids_match_jax_on_the_same_draws(case):
    td, order = case["td"], case["order"]
    noise, seeds = t(case["noise"]), t(case["seeds"])
    for name, fn, draw in (("samples_cumulative", ma.prominent_z_cumulative, noise),
                           ("samples_sequential", ma.prominent_z_combined, noise),
                           ("samples_hierarchical", ma.prominent_z_hierarchical, seeds)):
        imgs, nrow = fn(td, order, draw)
        want, want_nrow = case["grids"][name]
        assert nrow == want_nrow and imgs.shape == want.shape, name
        _images_close(imgs, want)
        # The indicator and blank tiles are exact.
        tiles = np.isin(want, [0.0, 255.0]).reshape(len(want), -1).all(axis=1)
        np.testing.assert_array_equal(imgs[tiles], want[tiles])
        np.testing.assert_allclose(ma._image_grid(imgs, nrow), jma._image_grid(want, want_nrow),
                                   rtol=SAMPLE_TOL, atol=SAMPLE_TOL)
    assert case["grids"]["samples_sequential"][1] == 11
    assert case["grids"]["samples_hierarchical"][1] == 32


def test_prominent_z_noise_has_the_jax_shapes(case):
    noise, seeds = ma.prominent_z_noise(case["order"])
    assert noise.shape == case["noise"].shape and seeds.shape == case["seeds"].shape
    again, _ = ma.prominent_z_noise(case["order"])
    assert torch.equal(noise, again)


def test_image_metric_visualiser_writes_and_draws_what_cmf_tpu_does(case, monkeypatch, tmp_path):
    """The payload, the scalar, the figures and every drawn array (the |cos|
    matrix, 28 sweep images, the three grids on the JAX draws), then the
    same raise in the raw-pixel effective-z FID, with the same files left in
    the folder."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(ma, "prominent_z_noise", lambda order: (t(case["noise"]), t(case["seeds"])))
    drawn, writer = [], _Writer()
    _drawn(monkeypatch, drawn)
    with pytest.raises(ValueError, match=RAW_FID_FAULT) as raised:
        ma.ImageMetricDensityVisualizer(writer, case["x"]).visualize(case["td"], 0, write_folder=str(tmp_path))
    assert str(raised.value) == case["raised"]
    assert _files(str(tmp_path)) == case["files"]
    assert "plotted_samples_prominent_d/samples_hierarchical.pdf" in case["files"]
    want = case["writer"]
    assert writer.figures == want.figures
    (got_payload,), (want_payload,) = writer.json.values(), want.json.values()
    assert set(got_payload) == set(want_payload)
    for k, v in want_payload.items():
        if "order" in k:
            assert got_payload[k] == v, k
        else:
            _close(got_payload[k], v, METRIC_TOL)
    assert writer.scalars["metric/macs"][1] == 0
    assert writer.scalars["metric/macs"][0] == pytest.approx(want.scalars["metric/macs"][0], rel=METRIC_TOL)
    assert len(drawn) == len(case["drawn"]) == 1 + 4 * 7 + 3
    _close(drawn[0], case["drawn"][0], METRIC_TOL)
    for got, ref in zip(drawn[1:], case["drawn"][1:]):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=SAMPLE_TOL, atol=SAMPLE_TOL)


def test_sweeps_match_the_drawn_jax_sweeps(case):
    td, order = case["td"], case["order"]
    rows = ma.prominent_z_sweeps(td, ma.encode(td, t(case["x"])), order)
    assert rows.shape == (4, 7, *X_SHAPE)
    drawn = case["drawn"][1:29]
    for got, ref in zip(rows.reshape(28, *X_SHAPE), drawn):
        np.testing.assert_allclose(np.clip(got[0], 0, 256) / 256.0, ref, rtol=SAMPLE_TOL, atol=SAMPLE_TOL)


def test_effective_z_curves_match_jax(case):
    recon, fid = ma.effective_z_curves(case["td"], t(case["x"]), case["order"], feature_fn=_pool_torch)
    assert list(recon) == list(case["recon"]) == [1, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20]
    for k in recon:
        assert recon[k] == pytest.approx(case["recon"][k], rel=RECON_TOL), k
        assert fid[k] == pytest.approx(case["fid"][k], rel=FID_TOL), k


def test_effective_z_raw_pixel_fid_raises_as_in_cmf_tpu(case):
    with pytest.raises(ValueError, match=RAW_FID_FAULT):
        ma.effective_z_curves(case["td"], t(case["x"]), case["order"])


def test_cumulative_dim_fid_matches_jax(case):
    curve = ma.cumulative_dim_fid(case["td"], t(case["x"]), t(case["fid_noise"]), case["order"],
                                  feature_fn=_pool_torch, batch_size=FID_BATCH)
    assert len(curve) == len(case["curve"]) == LATENT
    np.testing.assert_allclose(curve, case["curve"], rtol=FID_TOL)


def test_centering_recons_match_the_drawn_jax_ones(case):
    recon, recon_c = ma.centering_recons(case["td"], t(case["x"][:8]))
    drawn = np.stack(case["centering"]).reshape(8, 3, *X_SHAPE[1:])
    np.testing.assert_array_equal(drawn[:, 0], np.clip(case["x"][:8, 0], 0, 256) / 256.0)
    for i, got in ((1, recon), (2, recon_c)):
        np.testing.assert_allclose(np.clip(got[:, 0], 0, 256) / 256.0, drawn[:, i], rtol=SAMPLE_TOL,
                                   atol=SAMPLE_TOL)


def test_analysis_routes_every_encode_and_decode_through_the_coupler(case):
    """On the CPU the wrapper takes the plain version; it is still called
    once for each coupling that an encode, a decode or a fixed sample
    crosses: ten."""
    td, x = case["td"], t(case["x"])
    cs.reset_launch_counts()
    ma.encode(td, x)
    ma.decode(td, torch.zeros(2, LATENT))
    ma.fixed_sample(td, torch.zeros(2, LATENT))
    assert cs.CALLS == 30 and cs.LAUNCHES == 0
    cs.reset_launch_counts()
    out = ma.image_metric_analysis(td, x)
    # 2 encodes, 4 sweeps, 5 + 16 + 5 fixed samples of the grids.
    assert cs.CALLS == 10 * (2 + 4 + 5 + 16 + 5)
    assert set(out["grids"]) == set(case["grids"])


def test_two_dim_manifold_grid_matches_jax():
    schema = get_schema(mnist_config(g_hidden_channels=[8], prior_hidden_channels=[8], latent_dimension=2))
    jd = jax_get_density(schema, x_shape=X_SHAPE)
    jv = jd.init(jax.random.PRNGKey(2))
    td = get_density(schema, x_shape=X_SHAPE, device="cpu")
    variables_from_jax(td, to_numpy(jv))
    jd = _jitted(jd)
    # cmf_tpu/training/experiment.py:459-467's latents.
    xv, yv = np.meshgrid(np.linspace(-3.0, 3.0, 8), np.linspace(3.0, -3.0, 8))
    latents = jnp.asarray(np.stack([xv.reshape(-1), yv.reshape(-1)], axis=1), jnp.float32)
    want = np.asarray(jd.decode(jv, latents, train=False))
    cs.reset_launch_counts()
    got = two_dim_manifold_grid(td)
    assert cs.CALLS == 10
    assert got.shape == (64, *X_SHAPE)
    _images_close(got, want)


@pytest.mark.parametrize("dataset", ["sphere", "miniboone", "mnist"])
def test_describe_density_matches_cmf_tpu(dataset):
    """The published default of each dataset the port trains, at full
    width."""
    config = mnist_config() if dataset == "mnist" else {
        **expand_grid(get_config(dataset, "non-square", use_baseline=False))[0],
        "model": "non-square", "dataset": dataset}
    schema = get_schema(config)
    x_shape = {"sphere": (3,), "miniboone": (43,), "mnist": (1, 28, 28)}[dataset]
    want = jax_describe_density(jax_get_density(schema, x_shape=x_shape))
    got = describe_density(get_density(schema, x_shape=x_shape, device="cpu"))
    assert got == want
    assert got.count("\n") > 5


def test_effective_z_json_is_read_by_cmf_tpus_collector(tmp_path):
    """The visualiser on a flat model (hemisphere-2-6: no sweeps drawn, no
    grids, as in the JAX package) writes ``test_metric/{recon,fid}.json``,
    the same as cmf_tpu's; its collector reads both packages' files the same
    way."""
    from cmf_tpu.analysis import collect_effective_z
    from cmf_tpu_torch.training import DummyWriter

    from _sphere_pair import sphere_pair

    jd, jv, td, x = sphere_pair("hemisphere-2-6", seed=3, n=64, latent_dimension=2)
    jd = _jitted(jd)
    runs = tmp_path / "runs"
    for pkg in ("jax", "port"):
        run = runs / "hemisphere-2-6" / pkg
        run.mkdir(parents=True)
        lam = 0.1 if pkg == "port" else 0.2
        (run / "config.json").write_text(json.dumps(
            {"dataset": "hemisphere-2-6", "latent_dimension": 2, "metric_regularization_param": lam}))
        if pkg == "jax":
            jma.ImageMetricDensityVisualizer(_Writer(), x).visualize(jd, jv, 0, write_folder=str(run))
        else:
            out = ma.ImageMetricDensityVisualizer(DummyWriter(), x).visualize(td, 0, write_folder=str(run))
            assert out["grids"] == {} and out["sweeps"].shape == (2, 7, 6)
        assert sorted(os.listdir(run)) == ["config.json", "metric_analysis.pdf", "test_metric"]
    for which in ("recon", "fid"):
        curves = collect_effective_z(str(runs), which)
        assert set(curves) == {0.1, 0.2} and list(curves[0.1]) == list(curves[0.2]) == [1, 2]
        tol = RECON_TOL if which == "recon" else FID_TOL
        for k in (1, 2):
            assert curves[0.1][k] == pytest.approx(curves[0.2][k], rel=tol), (which, k)
