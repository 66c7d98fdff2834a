"""The port's CIFs (``--model maf``, ``--model nsf-ar``, ``--model
cond-affine``) against the JAX package, at D = 6 with widths of 8 and
u = 3: the masked autoregressive MLP (its masks and outputs), MADE, the
conditional affine layer and the conditional Gaussian, each on the same
weights (carried by ``interop``) and numpy inputs; then the 2-layer CIF-MAF
built by both factories from miniboone's published config: the ELBO, the
importance-sampled metrics, one eager train step of the port's trainer, the
samples behind the FID, ``fixed_sample`` and ``extract_latent``, on the
JAX package's draws of u passed in; and the CLI on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.bijections.affine import ConditionalAffineBijection as JaxCondAffine
from cmf_tpu.bijections.made import MADEBijection as JaxMADE
from cmf_tpu.couplers import ChunkedSharedCoupler as JaxChunked
from cmf_tpu.densities.gaussian import DiagonalGaussianConditionalDensity as JaxCondGaussian
from cmf_tpu.eval import fid as jax_fid
from cmf_tpu.eval.metrics import metrics as jax_metrics
from cmf_tpu.nets import MLP as JaxMLP
from cmf_tpu.nets import AutoregressiveMLP as JaxARMLP
from cmf_tpu.nets import get_activation as jax_activation
from cmf_tpu.training.experiment import make_optimizer as jax_make_optimizer
from cmf_tpu_torch.bijections import ConditionalAffineBijection, MADEBijection
from cmf_tpu_torch.couplers import ChunkedSharedCoupler
from cmf_tpu_torch.densities import (
    DiagonalGaussianConditionalDensity,
    DiagonalGaussianDensity,
    ELBODensity,
    gaussian,
)
from cmf_tpu_torch.eval import fid
from cmf_tpu_torch.eval.metrics import metrics
from cmf_tpu_torch.interop import flatten_tree, jax_path, variables_from_jax
from cmf_tpu_torch.main import main
from cmf_tpu_torch.nets import MLP, AutoregressiveMLP, get_activation
from cmf_tpu_torch.training import Trainer, get_objective, make_optimizer

from _torch_parity import to_numpy
from _torch_tabular import (
    DIM,
    FWD_TOL,
    GRAD_TOL,
    HIDDEN,
    INV_TOL,
    assert_grads_close,
    assert_updated,
    check_bijection,
    inputs,
    jax_elbo_u_noise,
    jax_sample_draws,
    rel_err,
    t,
    tabular_pair,
)

NUM_U = 3


def test_autoregressive_mlp_masks_and_outputs_match_cmf_tpu():
    """Degrees and masks exactly as the JAX package's, kept as state; the
    outputs (B, heads, D) within 1e-6."""
    jax_net = JaxARMLP(DIM, [HIDDEN, HIDDEN], 5, jax_activation("tanh"))
    variables = jax_net.init(jax.random.PRNGKey(0))
    port = AutoregressiveMLP(DIM, [HIDDEN, HIDDEN], 5, get_activation("tanh"))
    variables_from_jax(port, to_numpy(variables))
    for i, m in enumerate(jax_net.masks):
        np.testing.assert_array_equal(port.masks[i].numpy(), m)
    assert sorted(n for n, _ in port.named_buffers()) == ["masks.0", "masks.1", "masks.2"]
    x = inputs(16, seed=1)
    want, _ = jax.jit(jax_net.apply)(variables, jnp.asarray(x))
    got = port(t(x))
    assert got.shape == (16, 5, DIM)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(AssertionError, match="Random degree init"):
        AutoregressiveMLP(DIM, [DIM - 1], 2, torch.tanh)


def test_made_matches_cmf_tpu():
    """Forward, log-jacobian and gradients; the inverse is D passes."""
    jax_bij = JaxMADE(DIM, [HIDDEN, HIDDEN], jax_activation("tanh"))
    port = MADEBijection(DIM, [HIDDEN, HIDDEN], get_activation("tanh"))
    check_bijection(jax_bij, port, inputs(32, seed=2), seed=4, round_trip_tol=INV_TOL)


class _Indexed(ConditionalAffineBijection):
    """The conditional affine layer with its index fixed, so the bijection
    checks run on it."""

    def __init__(self, coupler, u):
        super().__init__((DIM,), coupler)
        self.u = u

    def forward(self, x):
        return super().forward(x, self.u)

    def inverse(self, z):
        return super().inverse(z, self.u)


class _JaxIndexed:
    def __init__(self, bij, u):
        self.bij, self.u = bij, u

    def init(self, key):
        return self.bij.init(key)

    def forward(self, variables, x):
        return self.bij.forward(variables, x, u=self.u)

    def inverse(self, variables, z):
        return self.bij.inverse(variables, z, u=self.u)


def test_cond_affine_matches_cmf_tpu():
    """z = (x + t(u))·exp(s(u)), its coupler an MLP of u."""
    u = inputs(32, seed=5)[:, :NUM_U]
    jax_bij = JaxCondAffine((DIM,), JaxChunked(JaxMLP(NUM_U, [HIDDEN], 2 * DIM, jax_activation("tanh"))))
    port = _Indexed(ChunkedSharedCoupler(MLP(NUM_U, [HIDDEN], 2 * DIM, torch.tanh)), t(u))
    check_bijection(_JaxIndexed(jax_bij, jnp.asarray(u)), port, inputs(32, seed=6), seed=7,
                    round_trip_tol=INV_TOL)


def test_conditional_gaussian_matches_cmf_tpu():
    """log_prob, the reparameterised sample on the JAX draw passed in,
    and the entropy."""
    jax_density = JaxCondGaussian(JaxChunked(JaxMLP(DIM, [HIDDEN], 2 * NUM_U, jax_activation("tanh"))))
    variables = jax_density.init(jax.random.PRNGKey(8))
    port = DiagonalGaussianConditionalDensity(ChunkedSharedCoupler(MLP(DIM, [HIDDEN], 2 * NUM_U, torch.tanh)))
    variables_from_jax(port.coupler.net, to_numpy(variables))  # the JAX tree is the net's own
    x = inputs(24, seed=9)
    u = inputs(24, seed=10)[:, :NUM_U]
    key = jax.random.PRNGKey(11)
    lp_j, (s_j, slp_j), ent_j = jax.jit(lambda v, uu, xx: (
        jax_density.log_prob(v, uu, xx), jax_density.sample(v, key, xx), jax_density.entropy(v, xx)))(
        variables, jnp.asarray(u), jnp.asarray(x))
    noise = t(jax.random.normal(key, (24, NUM_U)))
    s_t, slp_t = port.sample(t(x), noise=noise)
    for got, want in ((port.log_prob(t(u), t(x)), lp_j), (s_t, s_j), (slp_t, slp_j), (port.entropy(t(x)), ent_j)):
        assert rel_err(got.detach().numpy(), want) <= FWD_TOL


def _cif(model="maf"):
    config, jd, jv, td = tabular_pair(model, seed=3)
    layers = sum(isinstance(m, ELBODensity) for m in td.modules())
    return config, jd, jv, td, layers


def test_cif_maf_elbo_and_metrics_match_cmf_tpu():
    """The 2-layer CIF-MAF (flatten, MADE, cond-affine, flip, MADE,
    cond-affine): the elbo and its gradients on the JAX package's u, then
    ``metrics`` at K = 1 and K = 3, one set of draws a sample."""
    config, jd, jv, td, layers = _cif()
    assert layers == 2 and config["num_u_channels"] == NUM_U
    x = inputs(40, seed=12)
    key = jax.random.PRNGKey(13)

    def loss(p):
        info, _ = jd.elbo({"params": p, "state": jv["state"]}, jnp.asarray(x), rng=key, train=True)
        return -jnp.mean(info["elbo"]), info["elbo"]

    (_, elbo_j), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(jv["params"])
    noise = [t(n) for n in jax_elbo_u_noise(key, layers, 40, NUM_U)]
    elbo_t = td.elbo(t(x), train=True, u_noise=noise)["elbo"]
    (-elbo_t.mean()).backward()
    assert rel_err(elbo_t.detach().numpy(), elbo_j) <= FWD_TOL
    assert_grads_close(td, grads_j, GRAD_TOL)

    for k in (1, 3):
        want = jax.jit(lambda v, xx, k=k: jax_metrics(jd, v, xx, k, rng=key))(jv, jnp.asarray(x))
        keys = [key] if k == 1 else list(jax.random.split(key, k))
        draws = [{"u_noise": [t(n) for n in jax_elbo_u_noise(kk, layers, 40, NUM_U)]} for kk in keys]
        with torch.no_grad():
            got = metrics(td, t(x), k, draws=draws)
        for name in ("elbo", "log-prob", "bpd", "elbo-gap"):
            scale = max(1.0, float(np.abs(np.asarray(want["elbo"])).max()))
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=FWD_TOL,
                                       atol=FWD_TOL * scale, err_msg=name)


def _queued(monkeypatch, noise):
    """Each conditional Gaussian sample without noise of its own takes the
    next of ``noise`` (the JAX package's draws, in the port's order)."""
    real = gaussian.diagonal_gaussian_sample

    def replay(means, stddevs, generator=None, given=None):
        return real(means, stddevs, generator, given if given is not None else t(noise.pop(0)))

    monkeypatch.setattr(gaussian, "diagonal_gaussian_sample", replay)


def test_cif_maf_train_step_matches_cmf_tpu(monkeypatch):
    """One eager step of the port's trainer (Adam, as published) against the
    JAX loss, gradients and update, on the same u."""
    config, jd, jv, td, layers = _cif()
    config = {**config, "lr": 1e-3}
    x = inputs(64, seed=14)
    key = jax.random.PRNGKey(15)
    objective = get_objective(config)
    opt_j, _ = jax_make_optimizer(config, 10)
    trainer = Trainer(td, objective, [make_optimizer(config, td.parameters(), 10)], [], max_epochs=0,
                      generator=torch.Generator())

    def loss_fn(p):
        info, _ = jd.elbo({"params": p, "state": jv["state"]}, jnp.asarray(x), rng=key, train=True)
        return -jnp.mean(info["elbo"])

    @jax.jit
    def step(params):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, _ = opt_j.update(grads, opt_j.init(params), params)
        return loss, grads, jax.tree.map(lambda p, u: p + u, params, updates)

    loss_j, grads_j, params_j = step(jv["params"])
    noise = jax_elbo_u_noise(key, layers, 64, NUM_U)
    _queued(monkeypatch, noise)
    loss_t, _ = trainer.eager_step(t(x), objective.for_epoch(1))
    assert not noise
    assert abs(float(loss_t) - float(loss_j)) <= FWD_TOL * max(1.0, abs(float(loss_j)))
    assert_updated(td, grads_j, params_j, config["lr"])


def test_cif_maf_samples_and_fid_match_cmf_tpu(monkeypatch):
    """``sample`` draws z from the base, then each layer's u from p(u|z)
    and inverts: the FID closure of both packages on the same draws;
    ``fixed_sample`` (u at p's mean) and ``extract_latent`` (u at q's
    mean)."""
    config, jd, jv, td, layers = _cif()
    cfg = {"num_fid_samples": 60, "test_batch_size": 30}
    ref = inputs(60, seed=16)
    chunks = [ref[:30], ref[30:]]
    key = jax.random.PRNGKey(17)
    want = jax_fid.get_fid_function(cfg, [jnp.asarray(c) for c in chunks])(jd, jv, key)
    base, u_draws = [], []
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws = jax_sample_draws(sub, layers, 30, NUM_U)
        base.append(draws[0])
        u_draws += draws[1:]
    monkeypatch.setattr(DiagonalGaussianDensity, "_sample", lambda self, n, generator=None: t(base.pop(0)))
    _queued(monkeypatch, u_draws)
    got = fid.get_fid_function(cfg, [t(c) for c in chunks])(td, torch.Generator())
    assert not base and not u_draws
    np.testing.assert_allclose(got, want, rtol=1e-4)

    noise = inputs(16, seed=18)
    x_j = jax.jit(lambda v, n: jd.fixed_sample(v, noise=n))(jv, jnp.asarray(noise))
    assert rel_err(td.fixed_sample(t(noise)).numpy(), x_j) <= INV_TOL
    x = inputs(16, seed=19)
    z_j = jax.jit(lambda v, xx: jd.extract_latent(v, xx))(jv, jnp.asarray(x))
    with torch.no_grad():
        assert rel_err(td.extract_latent(t(x)).numpy(), z_j) <= FWD_TOL


def test_cif_state_comes_across_whole():
    """Every parameter and buffer of the port holds the JAX leaf at its
    path: the MADE masks, the rand-channel-perm buffers, the LU factors and
    masks, the conditional couplers of p and q."""
    for model in ("maf", "nsf-ar", "cond-affine"):
        _, _, jv, td = tabular_pair(model, seed=1)
        leaves = {**flatten_tree(to_numpy(jv["params"])), **flatten_tree(to_numpy(jv["state"]))}
        port = td.state_dict()
        assert len(port) == len(leaves), model
        for name, value in port.items():
            np.testing.assert_array_equal(value.numpy(), leaves[jax_path(name)].astype(value.numpy().dtype))


CLI = ["--dataset", "miniboone", "--synthetic-data", "--nosave", "--device", "cpu",
       "--config", "num_density_layers=2", "--config", "max_epochs=2", "--config", "max_dataset_size=200",
       "--config", "num_fid_samples=100", "--config", "test_batch_size=100", "--config", "valid_batch_size=100",
       "--config", "train_batch_size=50", "--config", "st_nets=[8]", "--config", "p_nets=[8]"]


@pytest.mark.parametrize("model, extra, jobs", [
    ("maf", ["--config", "ar_map_hidden_channels=[43]", "--config", "q_nets=[8]"], 1),
    ("nsf-ar", ["--config", "q_nets=[8]"], 1),
    ("cond-affine", [], 2),
])
def test_cif_cli_trains_on_cpu(model, extra, jobs):
    """Each CIF command at 2 layers for 2 epochs to a finite test result;
    ``cond-affine``'s config is a two-value ``q_nets`` grid, so it runs two
    jobs."""
    setups = main(["--model", model] + CLI + extra)
    assert len(setups) == jobs
    for setup in setups:
        trainer = setup["trainer"]
        assert sum(isinstance(m, ELBODensity) for m in setup["density"].modules()) == 2
        assert len(trainer.history) == 2 * len(trainer.train_loader) > 0
        results = trainer.test()
        assert all(np.isfinite(v) for k, v in results.items() if k != "feature_extractor"), results
        assert "fid" in results and "log-prob" in results
