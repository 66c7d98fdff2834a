"""The README's sphere run and the CMF-vs-RNF battery's hemisphere model in
the port against the JAX package: the affine prior; the elbo and every
parameter gradient of the published models (sphere; hemisphere-2-6 at the
battery's d=6 with the off-diagonal and with the diagonal metric term) on
the same weights; ``extract_latent``, ``decode``, ``fixed_sample`` and the
pullback correction; the validation and test closures through each
package's trainer; the parameter count; and the CLI on the CPU with a run
dir, ``--resume`` and ``--test --resume``.

Weights come from the JAX package's init, perturbed, carried across by
``interop``. The JAX side's exact log-det runs its Pallas kernel in
interpret mode (``CMF_TPU_PALLAS_INTERPRET=1``) where a test says so, else
its plain XLA route, as its own tests run it on the CPU; the port's kernels
take their plain versions. Tolerances: fp32 both sides, 1e-4 on values and
1e-3 on gradients (second-order terms through the log-det), as the other
parity tests."""

import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.bijections import AffineBijection as JaxAffine
from cmf_tpu.training import experiment as jax_experiment
from cmf_tpu_torch.bijections import AffineBijection
from cmf_tpu_torch.main import main
from cmf_tpu_torch.interop import variables_from_jax
from cmf_tpu_torch.training import experiment, print_num_params

from _sphere_pair import sphere_pair, zoo_config
from _torch_parity import assert_trees_close, t, to_numpy, torch_grads

ELBO_TOL = 1e-4
GRAD_TOL = 1e-3

VARIANTS = {
    "sphere": ("sphere", {}, {}),
    "sphere-eval": ("sphere", {}, None),
    "hemisphere-g_ij": ("hemisphere-2-6", {"latent_dimension": 6},
                        {"add_offdiagonal_metric_reg": True, "metric_wt": 0.7}),
    "hemisphere-g_kk": ("hemisphere-2-6", {"latent_dimension": 6},
                        {"add_diagonal_metric_reg": True, "metric_wt": 0.7}),
}


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    # The CLI's writer tees stdout and stderr: put them back after each test.
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("CMF_TPU_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("per_channel", [False, True])
def test_affine_matches_cmf_tpu(per_channel):
    rng = np.random.default_rng(0)
    x_shape = (3, 4)
    jb = JaxAffine(x_shape, per_channel)
    params = {k: rng.normal(size=jb.param_shape).astype(np.float32) for k in ("shift", "log_scale")}
    tb = AffineBijection(x_shape, per_channel)
    variables_from_jax(tb, {"params": params, "state": {}})
    x = rng.normal(size=(5, *x_shape)).astype(np.float32)
    z_j, lj_j, _ = jb.forward({"params": params, "state": {}}, jnp.asarray(x))
    z_t, lj_t = tb(t(x))
    np.testing.assert_allclose(z_t.detach().numpy(), z_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lj_t.detach().numpy(), lj_j, rtol=1e-6, atol=1e-6)
    x_j, ilj_j = jb.inverse({"params": params, "state": {}}, z_j)
    x_t, ilj_t = tb.inverse(z_t)
    np.testing.assert_allclose(x_t.detach().numpy(), x_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ilj_t.detach().numpy(), ilj_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(x_t.detach().numpy(), x, rtol=1e-5, atol=1e-5)


def _prior_affine(td, jv):
    """The port's affine prior module and the JAX tree's params of it."""
    node, params = td, jv["params"]
    while not isinstance(getattr(node, "bijection", None), AffineBijection):
        node, params = node.prior, params["prior"]
    return node.bijection, params["bijection"]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_elbo_and_gradients_match_jax(variant, pallas_interpret):
    dataset, overrides, kw = VARIANTS[variant]
    jd, jv, td, x = sphere_pair(dataset, seed=3, n=16, **overrides)
    affine, affine_params = _prior_affine(td, jv)
    for name in ("shift", "log_scale"):
        np.testing.assert_array_equal(getattr(affine, name).detach().numpy(), affine_params[name])
        assert np.abs(affine_params[name]).max() > 0  # carried across, not the zero init
    train = kw is not None
    kw = {"likelihood_wt": 1.0, **(kw or {})}

    def jax_loss(params):
        info, _ = jd.elbo({"params": params, "state": jv["state"]}, jnp.asarray(x), train=train, **kw)
        return -jnp.mean(info["elbo"]), info["elbo"]

    (_, elbo_j), grads_j = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jv["params"])
    elbo_t = td.elbo(t(x), train=train, **kw)["elbo"]
    (-elbo_t.mean()).backward()
    elbo_j = np.asarray(elbo_j)
    np.testing.assert_allclose(elbo_t.detach().numpy(), elbo_j, rtol=ELBO_TOL,
                               atol=ELBO_TOL * np.abs(elbo_j).max())
    grads_t = torch_grads(td)
    scale = max(np.abs(g).max() for g in grads_t.values())
    assert_trees_close(grads_t, grads_j, rtol=GRAD_TOL, atol=GRAD_TOL * scale)


@pytest.mark.parametrize("dataset,overrides", [
    ("sphere", {}),
    ("hemisphere-2-6", {"latent_dimension": 6}),
    ("von-mises-circle", {"latent_dimension": 1}),
])
def test_latent_decode_and_samples_match_jax(dataset, overrides):
    jd, jv, td, x = sphere_pair(dataset, seed=4, n=24, **overrides)
    with torch.no_grad():
        for earliest in (False, True):
            np.testing.assert_allclose(
                td.extract_latent(t(x), earliest=earliest).numpy(),
                np.asarray(jd.extract_latent(jv, jnp.asarray(x), earliest=earliest)),
                rtol=1e-5, atol=1e-5, err_msg=f"earliest={earliest}")
        z = td.extract_latent(t(x))
        np.testing.assert_allclose(td.decode(z).numpy(), np.asarray(jd.decode(jv, jnp.asarray(z.numpy()))),
                                   rtol=1e-5, atol=1e-5)
    d = z.shape[1]
    noise = np.random.default_rng(5).normal(size=(7, d)).astype(np.float32)
    np.testing.assert_allclose(td.fixed_sample(t(noise)).numpy(),
                               np.asarray(jd.fixed_sample(jv, noise=jnp.asarray(noise))), rtol=1e-5, atol=1e-5)
    assert td.sample(9, generator=torch.Generator().manual_seed(0)).shape == (9, x.shape[1])
    if d == 1:
        np.testing.assert_allclose(
            td.pullback_log_jac_jac_transpose(t(x)).detach().numpy(),
            np.asarray(jax.jit(jd.pullback_log_jac_jac_transpose)(jv, jnp.asarray(x))), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dataset,overrides", [
    ("sphere", {}),
    ("hemisphere-2-6", {"latent_dimension": 6, "g_ij_loss": True, "num_valid_elbo_samples": 3}),
])
def test_valid_and_test_losses_match_cmf_tpu(dataset, overrides):
    """Each package's trainer, on the same weights and splits (cut to 300
    rows), validates by -elbo (the reconstruction term in, through
    ``metrics``) and tests by -elbo without it: the same two numbers."""
    config = zoo_config(dataset, max_dataset_size=300, seed=2, nosave=True, **overrides)
    jd, jv, _, _ = sphere_pair(dataset, seed=2, **{k: v for k, v in overrides.items() if k == "latent_dimension"})
    theirs = jax_experiment.setup_experiment(config, write_to_disk=False)["trainer"]
    theirs.params, theirs.model_state = jv["params"], jv["state"]
    setup = experiment.setup_experiment(config, write_to_disk=False, device="cpu")
    variables_from_jax(setup["density"], to_numpy(jv))
    ours = setup["trainer"]
    ours._validate(1)
    theirs._validate(1)
    assert math.isclose(ours.best_valid_loss, theirs.best_valid_loss, rel_tol=ELBO_TOL)
    test_ours, test_theirs = ours.test(), theirs.test()
    assert set(test_ours) == set(test_theirs) == {"loss"}
    assert math.isclose(test_ours["loss"], test_theirs["loss"], rel_tol=ELBO_TOL)
    # The two closures differ by the reconstruction term, which is zero only
    # where the latent keeps every coordinate (d = D = 6).
    valid_fn, test_fn = experiment.elbo_loss_fns(config)
    xb = next(iter(ours.valid_loader))
    with torch.no_grad():
        gap = float(valid_fn(setup["density"], xb).mean() - test_fn(setup["density"], xb)["loss"].mean())
    assert gap > 1e-3 if dataset == "sphere" else abs(gap) < 1e-4


def test_num_params_match_cmf_tpu(capsys):
    for dataset, overrides in (("sphere", {}), ("hemisphere-2-6", {"latent_dimension": 6})):
        config = zoo_config(dataset, seed=0, **overrides)
        print_num_params(config, device="cpu")
        jax_experiment.print_num_params(config)
        ours, theirs = capsys.readouterr().out.strip().splitlines()[-2:]
        assert ours == theirs and ours.startswith("Number of parameters: ")


def test_cli_print_num_params_on_the_cpu_only_when_asked(capsys, monkeypatch):
    """``--print-num-params --device cpu`` prints the JAX package's count;
    without ``--device`` it runs on the card, and raises where there is
    none."""
    argv = ["--model", "non-square", "--dataset", "sphere", "--print-num-params"]
    assert main(argv + ["--device", "cpu"]) == []
    jax_experiment.print_num_params(zoo_config("sphere", seed=0))
    ours, theirs = capsys.readouterr().out.strip().splitlines()[-2:]
    assert ours == theirs and ours.startswith("Number of parameters: ")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def _scalars(run_dir, tag):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == f"sphere/{tag}"}


def test_cli_sphere_run_then_resume_then_test(tmp_path):
    """The README's first command on the CPU, with a run dir, cut in depth:
    validation by -elbo every epoch, a test (and the 3-D visualiser's
    figure) after epoch 1, both checkpoints; then --resume trains on from
    ``latest`` and --test --resume writes metrics.json and the figure."""
    (setup,) = main([
        "--model", "non-square", "--dataset", "sphere", "--device", "cpu", "--logdir-root", str(tmp_path),
        "--config", "max_epochs=2", "--config", "max_dataset_size=2000", "--config", "seed=1",
    ])
    run_dir = setup["writer"].logdir
    config = json.load(open(os.path.join(run_dir, "config.json")))
    assert config["early_stopping"] and config["prior"] == "affine" and config["epochs_per_test"] == 50
    valid, test = _scalars(run_dir, "valid/loss"), _scalars(run_dir, "test/loss")
    assert sorted(valid) == [1, 2] and sorted(test) == [1]
    assert all(math.isfinite(v) for v in list(valid.values()) + list(test.values()))
    assert valid[2] < valid[1]
    assert os.path.getsize(os.path.join(run_dir, "manifold3d_epoch1.pdf")) > 0
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == ["best_valid.pt", "latest.pt"]

    config["max_epochs"] = 3
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(config, f)
    (resumed,) = main(["--resume", run_dir, "--device", "cpu"])
    assert resumed["trainer"].restored_from == "latest"
    assert [h[0] for h in resumed["trainer"].history] == [3, 3]
    assert sorted(_scalars(run_dir, "valid/loss")) == [1, 2, 3]

    (tested,) = main(["--test", "--resume", run_dir, "--device", "cpu"])
    assert tested["trainer"].restored_from == "best_valid"
    metrics = json.load(open(os.path.join(run_dir, "metrics.json")))
    assert metrics == tested["results"] and set(metrics) == {"loss"} and math.isfinite(metrics["loss"])
    assert os.path.getsize(os.path.join(run_dir, "density.pdf")) > 0
