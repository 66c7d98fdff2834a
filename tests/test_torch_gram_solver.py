"""The port's exact-Gram Hutchinson solver against the JAX package's:
``spd_solve``; the head's Gram route (the log-det value, ``diag_est``, the
elbo with and without the g_kk term, and the parameter gradients) on the
sphere's 2-D head and a narrow miniboone-shaped one, with the probes ε
passed in; one optimizer step of each package from the same weights, batch
and probes; and the CLI on synthetic miniboone, through the published
warm-up's first likelihood epoch and with the likelihood on from epoch 1.
"""

import sys
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cmf_tpu.config import expand_grid, get_config
from cmf_tpu.config import get_schema as jax_get_schema
from cmf_tpu.ops.chol import jittered_cholesky as jax_jittered_cholesky
from cmf_tpu.ops.chol import spd_solve as jax_spd_solve
from cmf_tpu.training.trainer import Trainer as JaxTrainer
from cmf_tpu_torch.interop import flatten_tree, jax_path
from cmf_tpu_torch.main import main
from cmf_tpu_torch.ops.chol import jittered_cholesky, spd_solve
from cmf_tpu_torch.training import Trainer, get_objective, make_optimizer

from _torch_parity import (
    DIM,
    assert_trees_close,
    batch,
    build_pair,
    small_config,
    t,
    to_numpy,
    torch_grads,
)

# spd_solve on well-conditioned Grams (condition below 1e3): fp32 solves
# summed in another order, a few rounding units of the largest entry.
SOLVE_TOL = 1e-5
# The head's values: the exact log-det and the Gram's diagonal are computed
# from the same fp32 Jacobian columns in both packages.
VALUE_TOL = 1e-5
# Gradients, max err over max |grad| over every parameter: the surrogate's
# gradient is a second-order one (a VJP of a JVP of the decode) contracted
# with the solve; the port's and XLA's fp32 sums differ in order.
GRAD_TOL = 1e-4
LR = 1e-3

SPHERE_DIM = 3  # the sphere's ambient D; its latent d is 2


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    # The CLI's writer tees stdout and stderr: put them back after each test.
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    # Both packages warn once that 'auto' left the CG settings inert.
    warnings.filterwarnings("ignore", message="hutchinson_solver='auto' resolved")


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def _gram(rng, batch_size, d, rows, scale=1.0):
    cols = scale * rng.normal(size=(batch_size, rows, d))
    return np.einsum("bki,bkj->bij", cols, cols).astype(np.float32)


@pytest.mark.parametrize("d, samples", [(2, 1), (5, 3), (21, 1), (70, 2)],
                         ids=["d2", "d5-S3", "d21", "d70-library"])
def test_spd_solve_matches_jax(d, samples):
    """Well-conditioned Grams: the solution and the factor, unrolled up to
    d = 64 and through the library's triangular solves above it."""
    rng = np.random.default_rng(d)
    gram = _gram(rng, 6, d, 3 * d)
    rhs = rng.normal(size=(6, d, samples)).astype(np.float32)
    x_j, l_j = jax.jit(jax_spd_solve)(jnp.asarray(gram), jnp.asarray(rhs))
    x_t, l_t = spd_solve(t(gram), t(rhs))
    print(f"d={d}: condition numbers up to {np.linalg.cond(gram.astype(np.float64)).max():.1f}")
    assert _rel(x_t.numpy(), x_j) <= SOLVE_TOL
    assert _rel(l_t.numpy(), l_j) <= SOLVE_TOL
    np.testing.assert_allclose(np.einsum("bij,bjs->bis", gram, x_t.numpy()), rhs, rtol=1e-3, atol=1e-3)


def test_spd_solve_takes_the_jitter_of_a_singular_gram():
    """A rank-3 Gram at d = 6 fails the first factorisation: both packages
    find the same jitter level and solve the jittered system. Its three
    smallest pivots are sqrt(jitter + fp32 rounding of the null space), so
    they, and the solution along them, agree only to the system's fp32
    conditioning: both solutions are held by their residual there, the
    three large pivots at 1e-4."""
    rng = np.random.default_rng(1)
    gram = _gram(rng, 1, 6, 3)
    rhs = rng.normal(size=(1, 6, 2)).astype(np.float32)
    _, jitter_j = jax.jit(jax_jittered_cholesky)(jnp.asarray(gram))
    _, jitter_t = jittered_cholesky(t(gram))
    assert float(jitter_j) == float(jitter_t) > 0
    x_j, l_j = jax.jit(jax_spd_solve)(jnp.asarray(gram), jnp.asarray(rhs))
    x_t, l_t = spd_solve(t(gram), t(rhs))
    pivots_j = np.diagonal(np.asarray(l_j), axis1=1, axis2=2)
    pivots_t = torch.diagonal(l_t, dim1=1, dim2=2).numpy()
    assert np.isfinite(pivots_t).all()
    np.testing.assert_allclose(pivots_t[:, :3], pivots_j[:, :3], rtol=1e-4)
    jittered = gram.astype(np.float64) + float(jitter_t) * np.eye(6)
    cond = np.linalg.cond(jittered[0])
    print(f"jitter {float(jitter_t):.3e}; pivots {pivots_t} vs {pivots_j}; condition {cond:.3e}")
    for x in (x_t.numpy(), np.asarray(x_j)):
        residual = np.einsum("bij,bjs->bis", jittered, x) - rhs
        assert np.abs(residual).max() <= 1e-7 * cond * np.abs(rhs).max()


def test_spd_solve_of_an_indefinite_gram_is_nan():
    """−I: every jitter level fails; NaN in both packages, no exception."""
    gram = -np.eye(4, dtype=np.float32)[None].repeat(2, axis=0)
    rhs = np.ones((2, 4, 1), np.float32)
    x_j, _ = jax.jit(jax_spd_solve)(jnp.asarray(gram), jnp.asarray(rhs))
    x_t, l_t = spd_solve(t(gram), t(rhs))
    assert np.isnan(np.asarray(x_j)).all() and torch.isnan(x_t).all()
    assert torch.isnan(torch.diagonal(l_t, dim1=1, dim2=2)).any()


def _sphere_config(**overrides):
    config = expand_grid(get_config("sphere", "non-square", use_baseline=False))[0]
    return {**config, "log_jacobian_method": "hutch_with_cg", **overrides}


HEADS = {
    # the miniboone head cut to D = 11, d = 5 (tests/_torch_parity.py)
    "miniboone": lambda **kw: (jax_get_schema(small_config(log_jacobian_method="hutch_with_cg", **kw)), DIM, 5),
    # the sphere's published head: D = 3, d = 2, couplers [10]×2
    "sphere": lambda **kw: (jax_get_schema(_sphere_config(**kw)), SPHERE_DIM, 2),
}


def _head_pair(kind, seed, **overrides):
    schema, dim, d = HEADS[kind](**overrides)
    jd, jv, td = build_pair(schema, dim=dim, seed=seed)
    x = batch(16, dim=dim, seed=seed)
    rng = jax.random.PRNGKey(seed)
    eps = np.asarray(jax.random.normal(rng, (16, d, 1)))
    return jd, jv, td, x, rng, eps


def _jax_log_det(jd, jv, x, rng, w_ld, w_diag):
    """The JAX head's ``_approx_log_det`` on the prior's z, and the gradient
    of Σ w_ld·log_det + Σ w_diag·diag_est in the parameters."""

    def fn(params):
        variables = {"params": params, "state": jv["state"]}
        prior_info, pstate = jd.prior.elbo({"params": params["prior"], "state": jv["state"]["prior"]},
                                           x, rng=rng, train=True)
        decode_flat = jd._decode_fns(variables, pstate, True)
        log_det, _, diag_est = jd._approx_log_det(decode_flat, prior_info["low_dim_x"], rng, True,
                                                  pstate=pstate, variables=variables)
        return jnp.sum(w_ld * log_det) + jnp.sum(w_diag * diag_est), (log_det, diag_est)

    (_, (log_det, diag_est)), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(jv["params"])
    return np.asarray(log_det), np.asarray(diag_est), grads


@pytest.mark.parametrize("kind", ["miniboone", "sphere"])
def test_gram_route_log_det_and_diagonal_match_jax(kind):
    """Both heads resolve 'auto' to the Gram; the value of the log-det is
    the exact one, ``diag_est`` the Gram's diagonal, and the gradients of
    both through the surrogate match."""
    jd, jv, td, x, rng, eps = _head_pair(kind, seed=3)
    assert jd._resolved_hutch_solver(eps.shape[1]) == td._resolved_hutch_solver(eps.shape[1]) == "gram"
    r = np.random.default_rng(5)
    w_ld = r.normal(size=16).astype(np.float32)
    w_diag = r.normal(size=eps.shape[:2]).astype(np.float32)
    log_det_j, diag_j, grads_j = _jax_log_det(jd, jv, jnp.asarray(x), rng, w_ld, w_diag)

    z = td.prior.elbo(t(x))["low_dim_x"]
    log_det_t, _, diag_t = td._approx_log_det(z, eps=t(eps))
    ((log_det_t * t(w_ld)).sum() + (diag_t * t(w_diag)).sum()).backward()
    assert _rel(log_det_t.detach().numpy(), log_det_j) <= VALUE_TOL
    assert _rel(diag_t.detach().numpy(), diag_j) <= VALUE_TOL
    grads_t = torch_grads(td)
    scale = max(np.abs(g).max() for g in grads_t.values())
    assert_trees_close(grads_t, grads_j, rtol=0, atol=GRAD_TOL * scale)

    # The value is the exact log-det of the eval path, not the surrogate.
    with torch.no_grad():
        exact, _, _ = td._exact_log_det(z)
    np.testing.assert_allclose(log_det_t.detach().numpy(), exact.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind, g_kk", [("miniboone", False), ("miniboone", True), ("sphere", True)],
                         ids=["miniboone", "miniboone-g_kk", "sphere-g_kk"])
def test_gram_route_elbo_and_gradients_match_jax(kind, g_kk):
    """The training elbo with the likelihood on, with and without the g_kk
    term, and every parameter gradient of −mean(elbo)."""
    jd, jv, td, x, rng, eps = _head_pair(kind, seed=7)
    kw = dict(likelihood_wt=1.0, metric_wt=0.5, add_diagonal_metric_reg=g_kk)

    def jax_loss(params):
        info, _ = jd.elbo({"params": params, "state": jv["state"]}, jnp.asarray(x), rng=rng, train=True, **kw)
        return -jnp.mean(info["elbo"]), info["elbo"]

    (_, elbo_j), grads_j = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jv["params"])
    elbo_t = td.elbo(t(x), train=True, hutchinson_eps=t(eps), **kw)["elbo"]
    (-elbo_t.mean()).backward()
    assert _rel(elbo_t.detach().numpy(), elbo_j) <= 1e-5
    grads_t = torch_grads(td)
    scale = max(np.abs(g).max() for g in grads_t.values())
    assert_trees_close(grads_t, grads_j, rtol=0, atol=GRAD_TOL * scale)


def test_one_step_of_each_package_matches():
    """One Adam step of the port's trainer and of the JAX package's step
    function from the same weights and batch, the port given the JAX step's
    probes: the loss, the gradient norm and every updated parameter."""
    config = small_config(log_jacobian_method="hutch_with_cg", likelihood_warmup=False)
    jd, jv, td = build_pair(jax_get_schema(config), seed=13)
    flags = get_objective(config).for_epoch(1)
    assert not flags["skip_likelihood"]
    x = batch(16, seed=13)

    opt = optax.chain(optax.scale_by_adam(), optax.scale_by_learning_rate(LR))
    step = JaxTrainer._make_loss_step(SimpleNamespace(optimizers=[opt], density=jd), 0, flags)
    key = jax.random.PRNGKey(0)
    carry = (jv["params"], jv["state"], opt.init(jv["params"]), key)
    lw, mw = (jnp.asarray(flags[k], jnp.float32) for k in ("likelihood_wt", "metric_wt"))
    (params_j, _, _, _), (loss_j, norm_j) = jax.jit(step)(carry, jnp.asarray(x), lw, mw)
    _, step_key = jax.random.split(key)
    eps = t(np.asarray(jax.random.normal(step_key, (16, 5, 1))))

    approx = td._approx_log_det
    td._approx_log_det = lambda z, generator=None, eps_=None: approx(z, eps=eps)
    trainer = Trainer(td, get_objective(config), [make_optimizer({"lr": LR}, td.parameters())], None, max_epochs=1)
    loss_t, norm_t = trainer.step(t(x), flags)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(norm_t), float(norm_j), rtol=1e-4)
    want = flatten_tree(to_numpy(params_j))
    before = flatten_tree(to_numpy(jv["params"]))
    for name, p in td.named_parameters():
        k = jax_path(name)
        moved = np.abs(want[k] - before[k]) > 1e-2 * LR
        diff = np.abs(p.detach().numpy() - want[k])
        # Adam moves each element by about LR; an element whose JAX gradient
        # is near zero may move the other way in fp32 (test_torch_training.py).
        assert np.all(diff[moved] <= 1e-5 + 1e-4 * np.abs(want[k][moved])), k
        assert np.all(diff <= 2 * LR), k


NARROW = ["--config", "num_density_layers=2", "--config", "coupler_hidden_channels=[16]",
          "--config", "prior_num_density_layers=2", "--config", "prior_hidden_channels=[8]",
          "--config", "latent_dimension=5"]
HUTCH_CLI = ["--model", "non-square", "--dataset", "miniboone", "--synthetic-data", "--device", "cpu", "--nosave",
             "--config", "log_jacobian_method=hutch_with_cg", "--config", "num_fid_samples=100",
             "--config", "test_batch_size=100", "--config", "seed=1"] + NARROW


def test_cli_trains_past_the_warmup_start():
    """The published warm-up (25 → 50): epochs 1-25 skip the likelihood,
    epoch index 26 is the first through the Gram solver; every loss finite."""
    (setup,) = main(HUTCH_CLI + ["--config", "max_epochs=28", "--config", "max_dataset_size=40",
                                 "--config", "train_batch_size=40"])
    history = setup["trainer"].history
    assert [h[0] for h in history] == list(range(1, 29))
    assert [h[3] for h in history] == [True] * 25 + [False] * 3
    assert all(np.isfinite(h[1]) for h in history)


def test_cli_validates_from_epoch_one_without_warmup(monkeypatch):
    """``likelihood_warmup=False``: the likelihood from step 1, FID validation
    from epoch 1 (miniboone is a FID dataset); finite train and validation
    losses."""
    from cmf_tpu_torch.training import experiment

    scalars = []

    class Recorder(experiment.DummyWriter):
        def write_scalar(self, tag, value, global_step=None):
            scalars.append((tag, float(value), global_step))

    monkeypatch.setattr(experiment, "DummyWriter", Recorder)
    (setup,) = main(HUTCH_CLI + ["--config", "likelihood_warmup=False", "--config", "max_epochs=2",
                                 "--config", "max_dataset_size=120", "--config", "train_batch_size=40"])
    history = setup["trainer"].history
    assert len(history) == 6 and not any(h[3] for h in history)
    assert all(np.isfinite(h[1]) for h in history)
    valid = [(v, s) for tag, v, s in scalars if tag == "valid/loss"]
    assert [s for _, s in valid] == [1, 2] and all(np.isfinite(v) for v, _ in valid)
