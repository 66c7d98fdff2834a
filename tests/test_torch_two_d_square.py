"""The 2-D zoo's square flows and CIFs against the JAX package: every
published 2-D command of ``--model sos|planar|bnaf|maf|realnvp|nsf-ar``
with and without ``--baseline``, ``affine --baseline`` and the coupled
spline (``nsf-ar --baseline --config autoregressive=False``), built by both
factories at their published widths (D = 2), cut to at most 2 layers, with
the same weights: the elbo and every gradient against the JAX package's
jitted ``value_and_grad``, on its draws of u for the CIFs; ``sample`` raising for
the forward-only flows; the overflow of sos's degree-9 powers at an init
where the JAX package overflows too; and one epoch of two commands
through both CLIs from the same weights, at their published depths."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main as jax_cli
import cmf_tpu.training.experiment
import cmf_tpu.viz
import cmf_tpu_torch.training.experiment
import cmf_tpu_torch.viz
from cmf_tpu.config import expand_grid, get_config, get_schema
from cmf_tpu.training.writer import DummyWriter as JaxDummyWriter
from cmf_tpu_torch.data import two_d
from cmf_tpu_torch.densities import BijectionDensity, ELBODensity
from cmf_tpu_torch.interop import flatten_tree, jax_path, variables_from_jax
from cmf_tpu_torch.main import main
from cmf_tpu_torch.training.writer import DummyWriter

from _torch_parity import build_pair, to_numpy
from _torch_tabular import FWD_TOL, GRAD_TOL, assert_grads_close, jax_elbo_u_noise, rel_err, t

DATASET = "2uniforms"
BATCH = 64
DEPTH = 2  # the JAX side's compile of a 10- or 20-layer model takes seconds

# (model, --baseline, config overrides): the 14 published 2-D commands.
MODELS = {
    "sos": ("sos", False, {}),
    "sos-baseline": ("sos", True, {}),
    "planar": ("planar", False, {}),
    "planar-baseline": ("planar", True, {}),
    "bnaf": ("bnaf", False, {}),
    "bnaf-baseline": ("bnaf", True, {}),
    "maf": ("maf", False, {}),
    "maf-baseline": ("maf", True, {}),
    "realnvp": ("realnvp", False, {}),
    "realnvp-baseline": ("realnvp", True, {}),
    "nsf-ar": ("nsf-ar", False, {}),
    "nsf-ar-baseline": ("nsf-ar", True, {}),
    "affine-baseline": ("affine", True, {}),
    "nsf-c-baseline": ("nsf-ar", True, {"autoregressive": False}),
}
FORWARD_ONLY = {"sos", "planar", "cond-planar", "bnaf"}


def two_d_config(name, depth=None):
    """The published 2-D config of ``name``, with at most ``depth`` layers."""
    model, baseline, overrides = MODELS[name]
    config = expand_grid(get_config(DATASET, model, use_baseline=baseline))[0]
    config = {**config, "model": model, "dataset": DATASET, **overrides}
    if depth is not None:
        config["num_density_layers"] = min(depth, config["num_density_layers"])
    return config


def two_d_batch(n, seed):
    return two_d._GENERATORS[DATASET](np.random.default_rng(seed), n, DATASET).astype(np.float32)


@pytest.fixture
def _quiet(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)


@pytest.mark.parametrize("name", list(MODELS))
def test_two_d_elbo_and_gradients_match_cmf_tpu(name):
    """The published 2-D schema built by both factories from the JAX
    package's init: every leaf carried (none left over), the elbo within
    1e-5 relative and every gradient within 1e-4 of its tensor's largest;
    the CIFs on the JAX package's u. The forward-only layers make
    ``sample`` raise."""
    schema = get_schema(two_d_config(name, DEPTH))
    jd, jv, td = build_pair(schema, dim=2, seed=0)
    leaves = {**flatten_tree(to_numpy(jv["params"])), **flatten_tree(to_numpy(jv["state"]))}
    assert {jax_path(k) for k in td.state_dict()} == set(leaves)
    layers = sum(isinstance(m, ELBODensity) for m in td.modules())
    assert (layers > 0) == (not MODELS[name][1]) and isinstance(td, (BijectionDensity, ELBODensity))
    x = two_d_batch(BATCH, seed=1)
    key = jax.random.PRNGKey(2)

    def loss(p):
        info, _ = jd.elbo({"params": p, "state": jv["state"]}, jnp.asarray(x), rng=key, train=True)
        return -jnp.mean(info["elbo"]), info["elbo"]

    (_, elbo_j), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(jv["params"])
    assert np.all(np.isfinite(np.asarray(elbo_j)))
    noise = {"u_noise": [t(n) for n in jax_elbo_u_noise(key, layers, BATCH, 1)]} if layers else {}
    elbo_t = td.elbo(t(x), **noise)["elbo"]
    (-elbo_t.mean()).backward()
    assert rel_err(elbo_t.detach().numpy(), elbo_j) <= FWD_TOL
    assert_grads_close(td, grads_j, GRAD_TOL)
    if FORWARD_ONLY & {layer["type"] for layer in schema}:
        with pytest.raises(NotImplementedError, match="no analytic inverse"):
            td.sample(4, generator=torch.Generator())


def test_sos_overflows_at_init_as_cmf_tpu_does():
    """Three sos layers of degree 4 compose degree-9 polynomials: at some
    inits (this JAX seed) the elbo of the 2-D data leaves fp32's range.
    The port overflows on the same rows and agrees on the others."""
    jd, jv, td = build_pair(get_schema(two_d_config("sos-baseline")), dim=2, seed=2)
    x = two_d_batch(1000, seed=0)
    elbo_j = np.asarray(jax.jit(lambda v, xx: jd.elbo(v, xx)[0]["elbo"])(jv, jnp.asarray(x)))
    with torch.no_grad():
        elbo_t = td.elbo(t(x))["elbo"].numpy()
    finite = np.isfinite(elbo_j)
    assert 0 < np.sum(~finite) < len(x)
    np.testing.assert_array_equal(np.isfinite(elbo_t), finite)
    assert rel_err(elbo_t[finite], elbo_j[finite]) <= FWD_TOL


class _Scalars:
    """Every scalar a CLI run writes through its DummyWriter."""

    def __init__(self, monkeypatch, cls):
        self.rows = []
        monkeypatch.setattr(cls, "write_scalar",
                            lambda _, tag, value, global_step=None: self.rows.append((tag, global_step, float(value))))

    def steps(self, tag):
        return {s: v for k, s, v in self.rows if k == tag}


@pytest.mark.parametrize("name", ["sos-baseline", "nsf-c-baseline"])
def test_one_epoch_through_both_clis_from_the_same_weights(name, monkeypatch, _quiet):
    """One epoch of 3 batches of 1000 through ``main.py`` and the port's
    CLI, the port's density loaded with the JAX package's init: the valid
    loss within 1e-4 relative."""
    model, _, overrides = MODELS[name]
    argv = ["--dataset", DATASET, "--model", model, "--baseline", "--nosave", "--config", "max_epochs=1",
            "--config", "max_dataset_size=3000", "--config", "seed=0"]
    argv += [a for k, v in overrides.items() for a in ("--config", f"{k}={v}")]
    monkeypatch.setattr(cmf_tpu.viz, "get_visualizer", lambda *a, **k: None)
    monkeypatch.setattr(cmf_tpu_torch.viz, "get_visualizer", lambda *a, **k: None)
    inits = []
    jax_get_density = cmf_tpu.training.experiment.get_density

    def recording(*args, **kwargs):
        density = jax_get_density(*args, **kwargs)
        init = density.init

        def recorded(key):
            variables = init(key)
            # A copy: the JAX trainer donates the variables to its step.
            inits.append(jax.tree.map(np.array, variables))
            return variables

        density.init = recorded
        return density

    monkeypatch.setattr(cmf_tpu.training.experiment, "get_density", recording)
    theirs = _Scalars(monkeypatch, JaxDummyWriter)
    jax_cli.main(argv)
    (init,) = inits
    port_get_density = cmf_tpu_torch.training.experiment.get_density

    def loading(*args, **kwargs):
        return variables_from_jax(port_get_density(*args, **kwargs), init)

    monkeypatch.setattr(cmf_tpu_torch.training.experiment, "get_density", loading)
    ours = _Scalars(monkeypatch, DummyWriter)
    (setup,) = main(argv + ["--device", "cpu"])
    assert len(setup["trainer"].history) == 3
    got, want = ours.steps("valid/loss"), theirs.steps("valid/loss")
    assert list(got) == list(want) == [1]
    assert abs(got[1] - want[1]) <= 1e-4 * max(1.0, abs(want[1])), (got, want)
