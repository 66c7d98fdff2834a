"""The port's batch-norm bijection and passthrough-before-eval wrapper
against the JAX package's functions, called directly (its CLI crashes in
both batch-norm modes, ROADMAP §3): the bijection's forward and inverse in
training and evaluation mode, per channel (flat and NCHW) and per element,
with and without the affine, at momentum 1, 0.1 and 0 and with ``detach``;
its buffers after 1 and 3 training forwards; the wrapper's refresh over the
stored rows and the rows themselves; the elbo and gradients of the tabular
realnvp CIF and ``maf --baseline`` at D = 6; and, in the port alone, the
non-finite freeze, the evaluation's restore of the training state and a
run dir's resume.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.bijections.batchnorm import BatchNormBijection as JaxBatchNormBijection
from cmf_tpu.config import expand_grid, get_config
from cmf_tpu.config import get_schema as jax_get_schema
from cmf_tpu.training import experiment as jax_experiment
from cmf_tpu_torch.bijections import BatchNormBijection
from cmf_tpu_torch.interop import flatten_tree, jax_path, variables_from_jax
from cmf_tpu_torch.main import main
from cmf_tpu_torch.nets import batch_statistics
from cmf_tpu_torch.training import Trainer, experiment, get_objective, make_optimizer

from _torch_parity import build_pair, to_numpy
from _torch_tabular import DIM, HIDDEN, jax_elbo_u_noise, rel_err, t

# Values and log-jacobians: one fp32 mean and variance a statistic, summed
# in another order; relative to the largest entry.
FWD_TOL = 1e-5
# Gradients: max err over max |grad| per tensor.
GRAD_TOL = 1e-4
# The running and batch statistics: the same sums.
STATE_TOL = 1e-6

BATCH = 32


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    # The CLI's writer tees stdout and stderr: put them back after each test.
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)


def _inputs(shape, seed):
    r = np.random.default_rng(seed)
    # Off-centre and scaled, so that normalising changes the values.
    return (1.5 + 2.0 * r.normal(size=(BATCH, *shape))).astype(np.float32)


def _bijection_pair(shape, per_channel, affine, momentum, detach, seed=0):
    """Both bijections with the same parameters (off their init) and the
    same running statistics (not 0 and 1, so evaluation mode reads them)."""
    kw = dict(x_shape=shape, per_channel=per_channel, apply_affine=affine, momentum=momentum, detach=detach)
    jb, tb = JaxBatchNormBijection(**kw), BatchNormBijection(**kw)
    variables = to_numpy(jb.init(jax.random.PRNGKey(seed)))
    r = np.random.default_rng(seed + 1)
    variables["params"] = {k: (0.3 * r.normal(size=v.shape)).astype(np.float32)
                           for k, v in variables["params"].items()}
    pshape = variables["state"]["running_mean"].shape
    variables["state"] = {
        "running_mean": r.normal(size=pshape).astype(np.float32),
        "running_var": r.uniform(0.5, 2.0, size=pshape).astype(np.float32),
        "batch_mean": r.normal(size=pshape).astype(np.float32),
        "batch_var": r.uniform(0.5, 2.0, size=pshape).astype(np.float32),
    }
    variables_from_jax(tb, variables)
    return jb, tb, variables


def _state(tb):
    return {k: v.detach().numpy().copy() for k, v in tb.named_buffers()}


def _assert_state(tb, want):
    got = _state(tb)
    assert set(got) == set(want)
    for k in want:
        assert rel_err(got[k], want[k]) <= STATE_TOL, k


BIJECTION_CASES = [
    # (x shape, per channel, affine, momentum, detach)
    ((DIM,), True, True, 1.0, False),
    ((DIM,), True, False, 1.0, False),
    ((DIM,), False, True, 0.1, False),
    ((DIM,), True, True, 0.1, True),
    ((3, 4, 4), True, True, 1.0, False),
    ((3, 4, 4), True, False, 0.1, True),
    ((3, 4, 4), False, True, 0.0, False),
]
BIJECTION_IDS = ["flat-channel-affine-m1", "flat-channel-m1", "flat-element-affine-m0.1",
                 "flat-channel-affine-m0.1-detach", "nchw-channel-affine-m1", "nchw-channel-m0.1-detach",
                 "nchw-element-affine-m0"]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape, per_channel, affine, momentum, detach", BIJECTION_CASES, ids=BIJECTION_IDS)
def test_bijection_matches_jax(shape, per_channel, affine, momentum, detach, train):
    """Forward values, log-jacobians, the gradients of a random functional
    of both (in the parameters and the input), the state a training
    forward leaves, then the inverse of the forward's z with that state."""
    jb, tb, variables = _bijection_pair(shape, per_channel, affine, momentum, detach)
    x = _inputs(shape, seed=2)
    r = np.random.default_rng(3)
    wz = r.normal(size=x.shape).astype(np.float32)
    wl = r.normal(size=BATCH).astype(np.float32)

    @jax.jit
    def forward(params, xx):
        def loss(p, xx):
            z, lj, new_state = jb.forward({"params": p, "state": variables["state"]}, xx, train=train)
            return jnp.sum(z * wz) + jnp.sum(lj * wl), (z, lj, new_state)

        (_, aux), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, xx)
        return aux, grads

    (z_j, lj_j, state_j), (g_params, g_x) = forward(variables["params"], jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    tb.batch_stats = train
    z_t, lj_t = tb(xt)
    ((z_t * t(wz)).sum() + (lj_t * t(wl)).sum()).backward()
    assert rel_err(z_t.detach().numpy(), z_j) <= FWD_TOL
    assert rel_err(lj_t.detach().numpy(), lj_j) <= FWD_TOL
    assert rel_err(xt.grad.numpy(), g_x) <= GRAD_TOL
    for name, p in tb.named_parameters():
        assert rel_err(p.grad.numpy(), g_params[name]) <= GRAD_TOL, name
    _assert_state(tb, to_numpy(state_j))

    x_j, lji_j = jb.inverse({"params": variables["params"], "state": state_j}, z_j, train=train)
    with torch.no_grad():
        x_t, lji_t = tb.inverse(t(np.asarray(z_j)))
    assert rel_err(x_t.numpy(), x_j) <= FWD_TOL
    assert rel_err(lji_t.numpy(), lji_j) <= FWD_TOL
    assert rel_err(x_t.numpy(), x) <= 1e-5  # the round trip


@pytest.mark.parametrize("momentum", [1.0, 0.1, 0.0])
def test_buffers_after_one_and_three_training_forwards(momentum):
    """The running and batch statistics after each of three training
    forwards on different batches, per channel on NCHW inputs."""
    shape = (3, 4, 4)
    jb, tb, variables = _bijection_pair(shape, True, True, momentum, False, seed=4)
    forward = jax.jit(lambda v, xx: jb.forward(v, xx, train=True)[2])
    state = variables["state"]
    with batch_statistics(tb), torch.no_grad():
        for i in range(3):
            x = _inputs(shape, seed=10 + i)
            state = to_numpy(forward({"params": variables["params"], "state": state}, jnp.asarray(x)))
            tb(t(x))
            if i in (0, 2):
                _assert_state(tb, state)
    # The four buffers are four tensors.
    assert len({b.data_ptr() for b in tb.buffers()}) == 4


def _published_cut(model, baseline):
    """miniboone's published ``model`` config (the batch-norm models), cut
    to 2 layers and widths of 8, u = 3 for the CIF."""
    config = expand_grid(get_config("miniboone", model, use_baseline=baseline))[0]
    config = {**config, "model": model, "dataset": "miniboone", "num_density_layers": 2,
              "st_nets": [HIDDEN] * 2, "p_nets": [HIDDEN] * 2, "q_nets": [HIDDEN] * 2}
    if model == "realnvp":
        config["coupler_hidden_channels"] = [HIDDEN] * 2
    if model == "maf":
        config["ar_map_hidden_channels"] = [HIDDEN] * 2
    if config["use_cond_affine"] and not baseline:
        config["num_u_channels"] = 3
    return config


MODELS = [("realnvp", False), ("maf", True)]
MODEL_IDS = ["realnvp-cif", "maf-baseline"]


def _model_pair(model, baseline, seed=0):
    config = _published_cut(model, baseline)
    schema = jax_get_schema(config)
    assert schema[0]["type"] == "passthrough-before-eval"
    assert any(layer["type"] == "batch-norm" for layer in schema)
    jd, jv, td = build_pair(schema, dim=DIM, seed=seed)
    num_cif = sum(layer.get("num_u_channels", 0) > 0 for layer in schema)
    return config, jd, jv, td, num_cif


def _bn_state(td):
    """{JAX path: value} of every batch-norm buffer of the port."""
    return {jax_path(n): b.detach().numpy().copy() for n, b in td.named_buffers()
            if n.rsplit(".", 1)[-1] in ("running_mean", "running_var", "batch_mean", "batch_var")}


def _assert_bn_state(td, jax_state):
    want = flatten_tree(to_numpy(jax_state))
    got = _bn_state(td)
    assert got and set(got) <= set(want)
    for k, v in got.items():
        assert rel_err(v, want[k]) <= STATE_TOL, k


@pytest.mark.parametrize("model, baseline", MODELS, ids=MODEL_IDS)
def test_model_elbo_and_gradients_match_jax(model, baseline):
    """A training elbo (the batch's statistics, stored and snapshot) with
    every parameter gradient and the state it leaves; then an evaluation
    elbo on other rows through the snapshot."""
    config, jd, jv, td, num_cif = _model_pair(model, baseline, seed=5)
    assert (num_cif > 0) == (not baseline)
    x = _inputs((DIM,), seed=6)
    key = jax.random.PRNGKey(7)

    def jax_loss(params):
        info, state = jd.elbo({"params": params, "state": jv["state"]}, jnp.asarray(x), rng=key, train=True)
        return -jnp.mean(info["elbo"]), (info["elbo"], state)

    (_, (elbo_j, state_j)), grads_j = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jv["params"])
    noise = [t(e) for e in jax_elbo_u_noise(key, num_cif, BATCH, 3)]
    draws = {"u_noise": noise} if num_cif else {}
    with batch_statistics(td):
        elbo_t = td.elbo(t(x), **draws)["elbo"]
    (-elbo_t.mean()).backward()
    assert rel_err(elbo_t.detach().numpy(), elbo_j) <= FWD_TOL
    # Over the largest gradient of the model: a shift that feeds a
    # training-mode batch-norm has a zero gradient (the batch mean takes it
    # away), rounding noise in both packages.
    want = flatten_tree(to_numpy(grads_j))
    scale = max(np.abs(g).max() for g in want.values())
    for name, p in td.named_parameters():
        err = np.abs(p.grad.numpy() - want[jax_path(name)]).max()
        assert err <= GRAD_TOL * scale, name
    _assert_bn_state(td, state_j)

    x2 = _inputs((DIM,), seed=8)
    key2 = jax.random.PRNGKey(9)
    info_j, _ = jax.jit(lambda v, xx: jd.elbo(v, xx, rng=key2, train=False))(
        {"params": jv["params"], "state": state_j}, jnp.asarray(x2))
    draws = {"u_noise": [t(e) for e in jax_elbo_u_noise(key2, num_cif, BATCH, 3)]} if num_cif else {}
    with torch.no_grad():
        eval_t = td.elbo(t(x2), **draws)["elbo"]
    assert rel_err(eval_t.numpy(), info_j["elbo"]) <= FWD_TOL


@pytest.mark.parametrize("model, baseline", MODELS, ids=MODEL_IDS)
def test_refresh_state_matches_jax(model, baseline):
    """``refresh_state`` over 200 stored rows: every batch-norm layer takes
    the rows' statistics, as the JAX wrapper's refreshed state."""
    config, jd, jv, td, num_cif = _model_pair(model, baseline, seed=11)
    rows = (0.5 + 1.5 * np.random.default_rng(12).normal(size=(200, DIM))).astype(np.float32)
    key = jax.random.PRNGKey(13)
    variables = jd.attach_data(jv, jnp.asarray(rows))
    state_j = jax.jit(lambda v: jd.refresh_state(v, rng=key))(variables)
    td.attach_data(t(rows))
    draws = {"u_noise": [t(e) for e in jax_elbo_u_noise(key, num_cif, 200, 3)]} if num_cif else {}
    before = _bn_state(td)
    td.refresh_state(**draws)
    _assert_bn_state(td, state_j)
    assert any(not np.array_equal(before[k], v) for k, v in _bn_state(td).items())
    assert all(p.grad is None for p in td.parameters())
    np.testing.assert_array_equal(np.asarray(state_j["passthrough_x"]), td.passthrough_x.numpy())


def test_stored_rows_are_cmf_tpus(monkeypatch):
    """The experiment's stored rows, byte-equal to those ``cmf_tpu``'s
    ``setup_experiment`` attaches, at the published 100,000 against a split
    of 300 rows."""
    monkeypatch.setenv("CMF_TPU_SYNTHETIC_DATA", "1")
    config = {**_published_cut("realnvp", True), "synthetic_data": True, "max_dataset_size": 300, "nosave": True,
              "seed": 3, "use_fid": False}
    jax_setup = jax_experiment.setup_experiment(config, write_to_disk=False)
    port_setup = experiment.setup_experiment(config, write_to_disk=False, device="cpu")
    want = np.asarray(jax_setup["trainer"].model_state["passthrough_x"])
    got = port_setup["density"].passthrough_x
    assert want.shape == (300, 43) and port_setup["density"].num_points == 100_000
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


def _trainer(td, config):
    opt = make_optimizer({**config, "lr": 1e-3}, td.parameters())
    return Trainer(td, get_objective(config), [opt], None, max_epochs=1)


def test_freeze_keeps_the_batch_norm_buffers_and_copies_no_rows():
    """A finite step moves the snapshot statistics; a NaN batch leaves every
    batch-norm buffer, and every parameter, as the previous step left it.
    The stored rows are not among the tensors the freeze copies."""
    config, _, _, td, _ = _model_pair("maf", True, seed=15)
    td.attach_data(t(_inputs((DIM,), seed=16)))
    trainer = _trainer(td, config)
    flags = trainer.objective.for_epoch(1)
    assert not any(f is td.passthrough_x for f in trainer._frozen(trainer.optimizers[0]))
    before = _bn_state(td)
    loss, _ = trainer.step(t(_inputs((DIM,), seed=17)), flags)
    assert np.isfinite(float(loss))
    after = _bn_state(td)
    assert all(not np.array_equal(before[k], after[k]) for k in before if k.endswith("running_mean"))
    params = [p.detach().clone() for p in td.parameters()]
    bad = _inputs((DIM,), seed=18)
    bad[3] = np.nan
    loss, _ = trainer.step(t(bad), flags)
    assert not np.isfinite(float(loss))
    for k, v in _bn_state(td).items():
        np.testing.assert_array_equal(v, after[k], err_msg=k)
    assert all(torch.equal(p, q) for p, q in zip(td.parameters(), params))


def test_evaluation_refreshes_then_restores_the_training_state():
    """Inside ``evaluating`` the statistics are those of a refresh over the
    stored rows; after the validation and the test pass the buffers hold
    the training state bit for bit."""
    config, _, _, td, _ = _model_pair("maf", True, seed=19)
    rows = t(_inputs((DIM,), seed=20))
    td.attach_data(rows)
    trainer = _trainer(td, config)
    trainer.step(t(_inputs((DIM,), seed=21)), trainer.objective.for_epoch(1))
    trained = _bn_state(td)
    with trainer.evaluating():
        inside = _bn_state(td)
    td.refresh_state()
    refreshed = _bn_state(td)
    for k in trained:
        np.testing.assert_array_equal(inside[k], refreshed[k], err_msg=k)
    assert any(not np.array_equal(inside[k], trained[k]) for k in trained)
    with trainer.evaluating():
        pass
    for k in trained:
        np.testing.assert_array_equal(_bn_state(td)[k], refreshed[k])  # the refresh above is kept

    def valid(density, x, generator=None):
        return -density.elbo(x)["elbo"]

    trainer.valid_loss_fn = valid
    trainer.test_metrics_fn = lambda d, x, g=None: {"loss": valid(d, x)}
    trainer.valid_loader = trainer.test_loader = [rows[:16], rows[16:]]
    trainer._validate(1)
    assert np.isfinite(trainer.best_valid_loss)
    assert np.isfinite(trainer.test()["loss"])
    for k, v in _bn_state(td).items():
        np.testing.assert_array_equal(v, refreshed[k], err_msg=k)
    assert trainer.timings["refresh"][0] == 4  # the two blocks above, the validation, the test


def test_cli_run_dir_resumes_with_the_same_rows(tmp_path):
    """``--model realnvp`` (the CIF: snapshot mode, no affine) on synthetic
    miniboone into a run dir, at cut widths: FID validation each epoch, a
    test, checkpoints; a resume makes the same stored rows from the seed,
    restores the buffers of ``latest`` and trains on; ``--test --resume``."""
    argv = ["--model", "realnvp", "--dataset", "miniboone", "--synthetic-data", "--device", "cpu",
            "--logdir-root", str(tmp_path), "--config", "num_density_layers=2", "--config", "max_epochs=2",
            "--config", "max_dataset_size=200", "--config", "train_batch_size=50", "--config", "num_fid_samples=100",
            "--config", "test_batch_size=100", "--config", "valid_batch_size=100", "--config", "seed=0",
            "--config", "coupler_hidden_channels=[8]", "--config", "st_nets=[8]", "--config", "p_nets=[8]",
            "--config", "q_nets=[8]"]
    (setup,) = main(argv)
    trainer = setup["trainer"]
    assert len(trainer.history) == 8 and all(np.isfinite(h[1]) for h in trainer.history)
    # A validation an epoch; at epoch 1 the test's metrics, its FID and the
    # (tabular: drawing nothing) visualiser, each refreshed as in cmf_tpu.
    assert trainer.timings["refresh"][0] == 2 + 3
    run_dir = setup["writer"].logdir
    saved = torch.load(os.path.join(run_dir, "checkpoints", "latest.pt"), weights_only=True)
    assert not any("passthrough" in k for k in saved["model_state"])
    rows = setup["density"].passthrough_x

    config = json.load(open(os.path.join(run_dir, "config.json")))
    config["max_epochs"] = 3
    json.dump(config, open(os.path.join(run_dir, "config.json"), "w"))
    (resumed,) = main(["--resume", run_dir, "--device", "cpu"])
    assert torch.equal(resumed["density"].passthrough_x, rows)
    assert resumed["trainer"].restored_from == "latest"
    assert [h[0] for h in resumed["trainer"].history] == [3] * 4

    (tested,) = main(["--test", "--resume", run_dir, "--device", "cpu"])
    metrics = json.load(open(os.path.join(run_dir, "metrics.json")))
    assert all(np.isfinite(metrics[k]) for k in ("elbo", "log-prob", "fid"))


def test_sos_overflows_in_evaluation_as_cmf_tpu_does():
    """``sos --baseline`` at its published widths and depth, at init: the
    training elbo of 1000 rows is finite on every row, its batch-norm
    renormalising each layer's output; after a refresh over 3000 stored
    rows, the evaluation elbo of 1000 held-out rows overflows on a few
    rows, the same in both packages (the degree-9 powers of rows beyond
    the stored rows' statistics)."""
    from cmf_tpu.data.tabular import get_synthetic_tabular

    config = expand_grid(get_config("miniboone", "sos", use_baseline=True))[0]
    jd, jv, td = build_pair(jax_get_schema(config), dim=43, seed=0)
    train, valid, _ = get_synthetic_tabular("miniboone", seed=0)
    rows = train[np.random.default_rng(0).permutation(len(train))[:3000]].astype(np.float32)
    x = valid[:1000].astype(np.float32)
    with torch.no_grad(), batch_statistics(td):
        assert torch.isfinite(td.elbo(t(rows[:1000]))["elbo"]).all()
    state = jax.jit(lambda v: jd.refresh_state(v, rng=None))(jd.attach_data(jv, jnp.asarray(rows)))
    info_j, _ = jax.jit(lambda v, xx: jd.elbo(v, xx, train=False))(
        {"params": jv["params"], "state": state}, jnp.asarray(x))
    td.attach_data(t(rows))
    td.refresh_state()
    with torch.no_grad():
        elbo_t = td.elbo(t(x))["elbo"].numpy()
    finite_j = np.isfinite(np.asarray(info_j["elbo"]))
    print(f"finite rows: {finite_j.sum()} (cmf_tpu), {np.isfinite(elbo_t).sum()} (port) of {len(x)}")
    assert 0 < (~finite_j).sum() < 0.05 * len(x)
    np.testing.assert_array_equal(np.isfinite(elbo_t), finite_j)
    assert rel_err(elbo_t[finite_j], np.asarray(info_j["elbo"])[finite_j]) <= FWD_TOL
