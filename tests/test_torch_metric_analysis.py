"""The port's metric analysis (``cmf_tpu_torch/viz/metric_analysis.py``)
against the JAX package's (``cmf_tpu/viz/metric_analysis.py``), function by
function, on the hemisphere-2-6 model (its published d=2, and the
CMF-vs-RNF battery's d=6) with the JAX weights perturbed and carried across,
at rows of the dataset; then the 4/6-D visualiser's written scalar and JSON
files against what the JAX visualiser writes.

Tolerances: 1e-4 relative on the decoder Jacobian and everything built
from it (fp32 JVPs through five couplings, each side summing in its own
order); the numpy-only functions exactly; 2e-2 relative on the discrete
curvature of a decoded sweep, whose arccos of cosines within 1e-5 of 1
turns the sweeps' 1e-7 fp32 differences into 1e-3 of the curvature."""

import json
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.viz import metric_analysis as jma
from cmf_tpu_torch.training import Writer
from cmf_tpu_torch.viz import metric_analysis as ma

from _sphere_pair import sphere_pair
from _torch_parity import t

TOL = 1e-4
CURVATURE_TOL = 2e-2


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module", params=[2, 6], ids=["d2", "d6"])
def pair(request):
    """(jax_density, jax_variables, torch_density, x, z) of hemisphere-2-6
    at latent dimension d, with z the port's latents of x."""
    jd, jv, td, x = sphere_pair("hemisphere-2-6", seed=6, n=48, latent_dimension=request.param)
    with torch.no_grad():
        z = td.extract_latent(t(x))
    return jd, jv, td, x, z


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=tol * max(1.0, np.abs(want).max()))


def test_decoder_jacobian_and_metric_tensor(pair):
    jd, jv, td, x, z = pair
    zj = jnp.asarray(z.numpy())
    jac = ma.decoder_jacobian(td, z)
    assert tuple(jac.shape) == (48, 6, z.shape[1])
    _close(jac.numpy(), jma.decoder_jacobian(jd, jv, zj))
    _close(ma.metric_tensor(td, z).numpy(), jma.metric_tensor(jd, jv, zj))
    _close(ma.volume_distortion(td, z), jma.volume_distortion(jd, jv, zj))


def test_sorts(pair):
    jd, jv, td, x, z = pair
    g_sorted, g_order = ma.g_kk_sort(td, z)
    want_sorted, want_order = jma.g_kk_sort(jd, jv, jnp.asarray(z.numpy()))
    _close(g_sorted, want_sorted)
    np.testing.assert_array_equal(g_order, want_order)
    for got, want in zip(ma.latent_variance_sort(td, t(x)), jma.latent_variance_sort(jd, jv, jnp.asarray(x))):
        if got.dtype.kind == "f":
            _close(got, want)
        else:
            np.testing.assert_array_equal(got, want)


def test_macs_and_canonical_summary(pair):
    jd, jv, td, x, z = pair
    got, cos = ma.macs(td, z)
    want, want_cos = jma.macs(jd, jv, jnp.asarray(z.numpy()))
    assert math.isclose(got, want, rel_tol=TOL)
    _close(cos, want_cos)
    ours = ma.canonical_metric_summary(td, t(x), max_points=40)
    theirs = jma.canonical_metric_summary(jd, jv, jnp.asarray(x), max_points=40)
    assert set(ours) == set(theirs)
    for k in theirs:
        if isinstance(theirs[k], int):
            assert ours[k] == theirs[k], k
        else:
            assert math.isclose(ours[k], theirs[k], rel_tol=TOL), k


def test_per_z_invariants(pair):
    jd, jv, td, x, z = pair
    rows = [z[:16], z[16:40]]
    ours = ma.per_z_invariants(td, rows, labels=["a", "b"])
    theirs = jma.per_z_invariants(jd, jv, [jnp.asarray(r.numpy()) for r in rows], labels=["a", "b"])
    _assert_battery_close(ours, theirs)


def _assert_battery_close(ours, theirs):
    assert len(ours) == len(theirs)
    for o, w in zip(ours, theirs):
        assert set(o) == set(w)
        for k, v in w.items():
            if isinstance(v, (str, int)):
                assert o[k] == v, k
            else:
                assert math.isclose(o[k], v, rel_tol=TOL, abs_tol=TOL), (k, o[k], v)


def test_numpy_invariants_are_the_same_functions():
    rng = np.random.default_rng(0)
    theta = np.linspace(0, 4 * np.pi, 200)
    spiral = np.stack([np.cos(theta) * (1 + theta), np.sin(theta) * (1 + theta), theta], 1)
    assert ma.winding_number(spiral[:, :2]) == jma.winding_number(spiral[:, :2])
    assert math.isclose(ma.winding_number(spiral[:, :2]), 2.0, rel_tol=1e-9)
    assert ma.discrete_curvature(spiral) == jma.discrete_curvature(spiral)
    circle = np.stack([np.cos(theta[:100] / 2), np.sin(theta[:100] / 2)], 1)
    noisy = circle + 0.01 * rng.normal(size=circle.shape)
    for pts in (circle, noisy, rng.normal(size=(120, 3))):
        assert ma.rips_betti(pts) == jma.rips_betti(pts)


class _JaxWriter:
    def __init__(self):
        self.scalars, self.json = {}, {}

    def write_scalar(self, tag, value, global_step=None):
        self.scalars[tag] = (float(value), global_step)

    def write_json(self, tag, data):
        self.json[tag] = data

    def write_figure(self, tag, figure, global_step=None):
        pass


def test_high_dimensional_visualiser_writes_what_cmf_tpu_writes(pair, tmp_path):
    jd, jv, td, x, _ = pair
    data = np.concatenate([x, x[::-1] + 0.01], axis=0)
    theirs = _JaxWriter()
    jma.HighDimensionalNonSquareVisualizer(theirs, data).visualize(jd, jv, 3)
    writer = Writer(str(tmp_path), make_subdir=False, tee=False)
    ma.HighDimensionalNonSquareVisualizer(writer, data).visualize(td, 3, write_folder=str(tmp_path))
    for name in ("projections_epoch3.pdf", "jacobian_epoch3.pdf", "projections.pdf", "jacobian.pdf"):
        assert os.path.getsize(tmp_path / name) > 0, name
    with open(tmp_path / "scalars.jsonl") as f:
        (row,) = [json.loads(line) for line in f]
    assert row["tag"].endswith("metric/macs") and row["step"] == 3
    assert math.isclose(row["value"], theirs.scalars["metric/macs"][0], rel_tol=TOL)
    with open(tmp_path / "invariants_epoch3.json") as f:
        invariants = json.load(f)
    want = theirs.json["invariants_epoch3"]
    assert set(invariants) == set(want)
    for k, v in want.items():
        tol = CURVATURE_TOL if k.endswith("_curvature") else TOL
        assert math.isclose(invariants[k], v, rel_tol=tol, abs_tol=TOL), (k, invariants[k], v)
    with open(tmp_path / "topological_battery_epoch3.json") as f:
        _assert_battery_close(json.load(f), theirs.json["topological_battery_epoch3"])
