"""The port's square NSF (``--model nsf-ar --baseline``) against the JAX
package, at D = 6 with widths of 8: the LU linear bijection, the
rational-quadratic spline (its bin search at the knots, its tails, its
inverse) and the autoregressive spline bijection, each on the same weights
(carried by ``interop``) and numpy inputs; then the 2-layer square NSF
built by both factories from miniboone's published config: elbo, the
importance-sampled metrics and one eager train step of the port's trainer
(Adam, cosine, clipping at 5) against the JAX step; the FID of the same
draws; and the CLI on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.bijections.linear import LULinearBijection as JaxLULinear
from cmf_tpu.bijections.spline import AutoregressiveRationalQuadraticSplineBijection as JaxARSpline
from cmf_tpu.bijections.spline import _compute_knots as jax_compute_knots
from cmf_tpu.bijections.spline import rational_quadratic_spline as jax_spline
from cmf_tpu.eval import fid as jax_fid
from cmf_tpu.eval.metrics import metrics as jax_metrics
from cmf_tpu.nets import get_activation as jax_activation
from cmf_tpu.training.experiment import make_optimizer as jax_make_optimizer
from cmf_tpu_torch.bijections import (
    AutoregressiveRationalQuadraticSplineBijection,
    LULinearBijection,
    rational_quadratic_spline,
)
from cmf_tpu_torch.densities import BijectionDensity, DiagonalGaussianDensity
from cmf_tpu_torch.eval import fid
from cmf_tpu_torch.eval.metrics import metrics
from cmf_tpu_torch.main import main
from cmf_tpu_torch.nets import get_activation
from cmf_tpu_torch.training import Trainer, get_objective, make_optimizer

from _torch_parity import to_numpy
from _torch_tabular import (
    DIM,
    FWD_TOL,
    GRAD_TOL,
    INV_TOL,
    ROUND_TRIP_TOL,
    assert_updated,
    check_bijection,
    inputs,
    rel_err,
    t,
    tabular_pair,
)

TAIL = 3.0
BINS = 4


def test_lu_linear_matches_cmf_tpu():
    jax_bij = JaxLULinear(DIM)
    port = LULinearBijection(DIM)
    assert {n for n, _ in port.named_buffers()} == {"l_mask"}
    check_bijection(jax_bij, port, inputs(32, seed=1), seed=2, round_trip_tol=INV_TOL)


def _spline_params(n, seed):
    r = np.random.default_rng(seed)
    uw = r.normal(size=(n, DIM, BINS)).astype(np.float32)
    uh = r.normal(size=(n, DIM, BINS)).astype(np.float32)
    ud = r.normal(size=(n, DIM, BINS - 1)).astype(np.float32)
    return uw, uh, ud


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_spline_matches_cmf_tpu_inside_and_in_the_tails(inverse):
    """Seeded normal inputs at scale 2: about an eighth fall in the linear
    tails outside ±3."""
    x = inputs(64, seed=3, scale=2.0)
    params = _spline_params(64, seed=4)
    assert 0 < np.mean(np.abs(x) > TAIL) < 0.5

    def jax_loss(xx, uw, uh, ud):
        out, ld = jax_spline(xx, uw, uh, ud, TAIL, inverse=inverse)
        return jnp.sum(out * w) + jnp.sum(ld * w[::-1]), (out, ld)

    w = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    (_, (out_j, ld_j)), grads_j = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3), has_aux=True))(
        jnp.asarray(x), *map(jnp.asarray, params))
    args = [t(a).requires_grad_(True) for a in (x, *params)]
    out_t, ld_t = rational_quadratic_spline(*args, TAIL, inverse=inverse)
    ((out_t * t(w)).sum() + (ld_t * t(w[::-1].copy())).sum()).backward()
    assert rel_err(out_t.detach().numpy(), out_j) <= FWD_TOL
    assert rel_err(ld_t.detach().numpy(), ld_j) <= FWD_TOL
    for a, g in zip(args, grads_j):
        assert rel_err(a.grad.numpy(), g) <= GRAD_TOL
    outside = np.abs(x) > TAIL
    np.testing.assert_array_equal(out_t.detach().numpy()[outside], x[outside])
    assert np.all(ld_t.detach().numpy()[outside] == 0.0)


def test_spline_picks_the_bin_of_cmf_tpu_at_the_knots():
    """Inputs exactly at the knots (and at ±tail_bound): the port's count of
    knots ≤ x must land in the JAX package's bin, forward and inverse."""
    uw, uh, ud = _spline_params(1, seed=6)
    cw, _, ch, _, _ = (np.asarray(a) for a in jax.jit(lambda *a: jax_compute_knots(*a, TAIL))(uw, uh, ud))
    for knots, inverse in ((cw, False), (ch, True)):
        x = knots[0].T.copy()  # (K+1, D): each row the d-th knot of every dimension
        params = [np.broadcast_to(a, (x.shape[0],) + a.shape[1:]).copy() for a in (uw, uh, ud)]
        out_j, ld_j = jax.jit(lambda *a, inv=inverse: jax_spline(*a, TAIL, inverse=inv))(x, *params)
        out_t, ld_t = rational_quadratic_spline(t(x), *map(t, params), TAIL, inverse=inverse)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), rtol=FWD_TOL, atol=FWD_TOL)


def test_spline_round_trip():
    x = inputs(256, seed=7, scale=1.5)
    params = [t(a) for a in _spline_params(256, seed=8)]
    z, ld = rational_quadratic_spline(t(x), *params, TAIL)
    back, ld_inv = rational_quadratic_spline(z, *params, TAIL, inverse=True)
    assert rel_err(back.numpy(), x) <= ROUND_TRIP_TOL
    assert rel_err(-ld_inv.numpy(), ld.numpy()) <= ROUND_TRIP_TOL


def test_autoregressive_spline_matches_cmf_tpu():
    """1 hidden layer of 8, 4 bins, relu, as miniboone's NSF (cut); the
    inverse is D sequential passes."""
    jax_bij = JaxARSpline(DIM, 1, 8, BINS, TAIL, jax_activation("relu"), dropout_probability=0.2)
    port = AutoregressiveRationalQuadraticSplineBijection(DIM, 1, 8, BINS, TAIL, get_activation("relu"),
                                                          dropout_probability=0.2)
    assert sorted(n for n, _ in port.named_buffers()) == ["net.masks.0", "net.masks.1"]
    check_bijection(jax_bij, port, inputs(32, seed=9, scale=1.5), seed=3, round_trip_tol=ROUND_TRIP_TOL)


def _nsf():
    config, jd, jv, td = tabular_pair("nsf-ar", baseline=True, seed=5)
    assert isinstance(td, BijectionDensity)
    assert [type(m).__name__ for m in td.modules() if hasattr(m, "inverse")].count("LULinearBijection") == 3
    return config, jd, jv, td


def test_square_nsf_elbo_and_metrics_match_cmf_tpu():
    config, jd, jv, td = _nsf()
    x = inputs(48, seed=10)
    for k in (1, 3):  # the square flow's elbo draws nothing: every sample coincides
        want = jax.jit(lambda v, xx, k=k: jax_metrics(jd, v, xx, k, rng=jax.random.PRNGKey(1)))(jv, jnp.asarray(x))
        with torch.no_grad():
            got = metrics(td, t(x), k, generator=torch.Generator().manual_seed(1))
        for key in ("elbo", "log-prob", "bpd", "elbo-gap"):
            scale = max(1.0, float(np.abs(np.asarray(want["elbo"])).max()))
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=FWD_TOL,
                                       atol=FWD_TOL * scale, err_msg=key)
    z_j = jax.jit(lambda v, xx: jd.extract_latent(v, xx))(jv, jnp.asarray(x))
    with torch.no_grad():
        assert rel_err(td.extract_latent(t(x)).numpy(), z_j) <= FWD_TOL
    # Decoding the same noise runs every inverse of the chain.
    noise = inputs(16, seed=14)
    x_j = jax.jit(lambda v, n: jd.fixed_sample(v, noise=n))(jv, jnp.asarray(noise))
    assert rel_err(td.fixed_sample(t(noise)).numpy(), x_j) <= INV_TOL


def test_square_nsf_train_step_matches_cmf_tpu():
    """One eager step of the port's trainer (Adam, cosine, clipping at 5,
    as published) against the JAX loss, gradients and optax update."""
    config, jd, jv, td = _nsf()
    assert config["lr_schedule"] == "cosine" and config["max_grad_norm"] == 5
    config = {**config, "lr": 1e-3}
    x = inputs(64, seed=11, scale=1.5)
    objective = get_objective(config)
    flags = objective.for_epoch(1)
    opt_j, _ = jax_make_optimizer(config, 10)
    trainer = Trainer(td, objective, [make_optimizer(config, td.parameters(), 10)], [], max_epochs=0)

    def loss_fn(p):
        info, _ = jd.elbo({"params": p, "state": jv["state"]}, jnp.asarray(x), train=True)
        return -jnp.mean(info["elbo"])

    @jax.jit
    def step(params):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, _ = opt_j.update(grads, opt_j.init(params), params)
        return loss, grads, jax.tree.map(lambda p, u: p + u, params, updates)

    loss_j, grads_j, params_j = step(jv["params"])
    loss_t, norm_t = trainer.eager_step(t(x), flags)
    assert abs(float(loss_t) - float(loss_j)) <= FWD_TOL * max(1.0, abs(float(loss_j)))
    norm_j = float(np.sqrt(sum(np.sum(np.square(g)) for g in jax.tree.leaves(to_numpy(grads_j)))))
    assert abs(float(norm_t) - norm_j) <= GRAD_TOL * norm_j
    assert norm_j > 5  # the clip acts
    assert_updated(td, grads_j, params_j, config["lr"])


def test_square_nsf_fid_matches_cmf_tpu_on_the_same_draws(monkeypatch):
    """The FID closure of both packages on the same base draws; each sample
    chunk inverts the AR splines by D passes."""
    config, jd, jv, td = _nsf()
    cfg = {"num_fid_samples": 90, "test_batch_size": 30}
    ref = inputs(60, seed=12)
    chunks = [ref[:30], ref[30:]]
    key = jax.random.PRNGKey(13)
    want = jax_fid.get_fid_function(cfg, [jnp.asarray(c) for c in chunks])(jd, jv, key)
    draws = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, (30, DIM))))
    monkeypatch.setattr(DiagonalGaussianDensity, "_sample", lambda self, n, generator=None: t(draws.pop(0)))
    got = fid.get_fid_function(cfg, [t(c) for c in chunks])(td, torch.Generator())
    assert not draws
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_square_nsf_cli_trains_on_cpu():
    """``--model nsf-ar --baseline`` at 2 layers, 2 epochs: the square
    objective, Adam with the cosine schedule and clipping, no early
    stopping, and a test pass to finite metrics and FID."""
    argv = ["--model", "nsf-ar", "--dataset", "miniboone", "--baseline", "--synthetic-data", "--nosave",
            "--device", "cpu", "--config", "num_density_layers=2", "--config", "max_epochs=2",
            "--config", "max_dataset_size=200", "--config", "num_fid_samples=100",
            "--config", "test_batch_size=100", "--config", "valid_batch_size=100"]
    (setup,) = main(argv)
    trainer = setup["trainer"]
    assert isinstance(setup["density"], BijectionDensity) and not trainer.early_stopping
    steps = 2 * len(trainer.train_loader)
    assert len(trainer.history) == steps > 0 and trainer.train_loader.batch_size == 64
    assert all(np.isfinite(h[1]) for h in trainer.history)
    assert trainer.optimizers[0].schedule_steps == steps
    results = trainer.test()
    assert set(results) == {"elbo", "log-prob", "bpd", "elbo-gap", "fid", "feature_extractor"}
    assert all(np.isfinite(v) for k, v in results.items() if k != "feature_extractor")
