"""The M-flow baseline (``--baseline``: ``m_flow=True``) in the port against
the JAX package: the head's train elbo under both flag sets and its eval
elbo, values and every gradient, on the same weights; the two parameter
groups against ``nonsquare_param_masks`` leaf for leaf, on the flat model
and on a small multiscale image model; a reconstruction epoch and then a
likelihood epoch through both packages' step functions, with the zero
gradient ``optax.masked`` passes through checked on the JAX side; a
two-optimizer checkpoint round trip; and ``--baseline`` through both CLIs
on a tiny sphere and miniboone run.

Tolerances: fp32 both sides, 1e-4 on values and 1e-3 on gradients, as the
other parity tests; Adam trajectories as ``test_torch_train_step.py``
holds them."""

import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main as jax_cli
import cmf_tpu.training
import cmf_tpu.viz
import cmf_tpu_torch.viz
from cmf_tpu.config import expand_grid, get_config, get_schema
from cmf_tpu.densities.nonsquare import ManifoldFlowHeadDensity as JaxManifoldFlowHead
from cmf_tpu.models import get_density as jax_get_density
from cmf_tpu.training.experiment import make_optimizer as jax_make_optimizer
from cmf_tpu.training.experiment import nonsquare_param_masks
from cmf_tpu.training.trainer import Trainer as JaxTrainer
from cmf_tpu.training.writer import DummyWriter as JaxDummyWriter
from cmf_tpu_torch.densities import DiagonalGaussianDensity, ManifoldFlowHeadDensity
from cmf_tpu_torch.interop import flatten_tree, jax_path, variables_from_jax
from cmf_tpu_torch.main import main
from cmf_tpu_torch.models import get_density
from cmf_tpu_torch.training import (
    DummyWriter,
    Trainer,
    Writer,
    get_objective,
    make_optimizers,
    nonsquare_param_groups,
)

from _torch_parity import DIM, batch, build_pair, small_config, small_schema, t, to_numpy, torch_grads

ELBO_TOL = 1e-4
GRAD_TOL = 1e-3
LR = 1e-3
BATCHES = 2  # a step epoch


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)


def _config(**overrides):
    return small_config(m_flow=True, likelihood_warmup=False, lr=LR, **overrides)


def _pair(seed=4):
    jd, jv, td = build_pair(small_schema(m_flow=True), seed=seed)
    assert isinstance(jd, JaxManifoldFlowHead) and isinstance(td, ManifoldFlowHeadDensity)
    return jd, jv, td


def _flags():
    """{name: flags} of a likelihood epoch (1) and a reconstruction epoch (2)."""
    objective = get_objective(_config())
    flags = {"likelihood": objective.for_epoch(1), "reconstruction": objective.for_epoch(2)}
    assert flags["likelihood"]["optimizer_index"] == 1 and not flags["likelihood"]["add_reconstruction"]
    assert flags["reconstruction"]["optimizer_index"] == 0 and flags["reconstruction"]["skip_likelihood"]
    return flags


def _jax_loss(jd, state, flags):
    def loss(params, x):
        info, _ = jd.elbo(
            {"params": params, "state": state}, x, train=True,
            likelihood_wt=flags["likelihood_wt"], metric_wt=flags["metric_wt"],
            add_reconstruction=flags["add_reconstruction"],
            add_diagonal_metric_reg=flags["add_diagonal_metric_reg"],
            add_offdiagonal_metric_reg=flags["add_offdiagonal_metric_reg"],
            skip_likelihood=bool(flags["skip_likelihood"]),
        )
        return -jnp.mean(info["elbo"]), info["elbo"]

    return loss


@pytest.mark.parametrize("kind", ["likelihood", "reconstruction"])
def test_train_elbo_and_gradients_match_jax(kind):
    jd, jv, td = _pair()
    flags = _flags()[kind]
    x = batch(16, seed=11)
    (_, want), grads = jax.jit(jax.value_and_grad(_jax_loss(jd, jv["state"], flags), has_aux=True))(
        jv["params"], jnp.asarray(x))
    got = td.elbo(t(x), train=True, likelihood_wt=flags["likelihood_wt"],
                  add_reconstruction=flags["add_reconstruction"], skip_likelihood=bool(flags["skip_likelihood"]))
    (-got["elbo"].mean()).backward()
    np.testing.assert_allclose(got["elbo"].detach().numpy(), np.asarray(want), rtol=ELBO_TOL, atol=ELBO_TOL)
    want_grads = flatten_tree(to_numpy(grads))
    got_grads = torch_grads(td)
    scale = max(np.abs(g).max() for g in want_grads.values())
    for k, g in want_grads.items():
        np.testing.assert_allclose(got_grads[k], g, rtol=GRAD_TOL, atol=GRAD_TOL * scale, err_msg=k)


def test_eval_elbo_takes_the_exact_log_det_as_jax():
    jd, jv, td = _pair()
    x = batch(16, seed=12)
    want, _ = jax.jit(lambda v, x: jd.elbo(v, x, train=False))(jv, jnp.asarray(x))
    with torch.no_grad():
        got = td.elbo(t(x), train=False)["elbo"].numpy()
        ood = td.ood(t(x))
    np.testing.assert_allclose(got, np.asarray(want["elbo"]), rtol=ELBO_TOL, atol=ELBO_TOL)
    jax_ood = jax.jit(lambda v, x: jd.ood(v, x))(jv, jnp.asarray(x))
    for k in ("likelihood", "reconstruction-error"):
        np.testing.assert_allclose(ood[k].numpy(), np.asarray(jax_ood[k]), rtol=ELBO_TOL, atol=ELBO_TOL)


def test_step_is_capturable_whatever_the_log_det_method():
    from cmf_tpu_torch.densities.wrapper import DequantizationDensity

    density = get_density(small_schema(m_flow=True, log_jacobian_method="hutch_with_cg"), x_shape=(DIM,),
                          device="cpu")
    assert isinstance(density, ManifoldFlowHeadDensity) and density.step_capturable
    assert DequantizationDensity(density).step_capturable is False


def _assert_groups_match_masks(jd, jv, td):
    recon_mask, lik_mask = (flatten_tree(m) for m in nonsquare_param_masks(jd, jv["params"]))
    recon, lik = nonsquare_param_groups(td)
    in_lik = {id(p) for p in lik}
    named = list(td.named_parameters())
    assert {jax_path(n) for n, _ in named} == set(lik_mask)
    assert len(recon) + len(lik) == len(named) and lik and recon
    for name, p in named:
        path = jax_path(name)
        assert bool(lik_mask[path]) == (id(p) in in_lik), path
        assert bool(recon_mask[path]) == (id(p) not in in_lik), path
    assert [id(p) for p in recon] == [id(p) for _, p in named if id(p) not in in_lik]


def test_param_groups_match_jax_masks_on_the_flat_model():
    _assert_groups_match_masks(*_pair())


def test_param_groups_match_jax_masks_on_a_multiscale_image_model():
    config = expand_grid(get_config("mnist", "non-square", use_baseline=True))[0]
    config.update(g_hidden_channels=[8], prior_hidden_channels=[8])
    schema = get_schema(config)
    jd = jax_get_density(schema, x_shape=(1, 8, 8))
    jv = jd.init(jax.random.PRNGKey(0))
    td = get_density(schema, x_shape=(1, 8, 8), device="cpu")
    variables_from_jax(td, to_numpy(jv))
    _assert_groups_match_masks(jd, jv, td)


def test_param_groups_raise_on_a_node_they_cannot_walk():
    from cmf_tpu.densities import DiagonalGaussianDensity as JaxGaussian

    jd = JaxGaussian(shape=(3,), num_fixed_samples=2)
    with pytest.raises(RuntimeError, match="Cannot walk density node"):
        nonsquare_param_masks(jd, jd.init(jax.random.PRNGKey(0))["params"])
    with pytest.raises(RuntimeError, match="Cannot walk density node"):
        nonsquare_param_groups(DiagonalGaussianDensity(shape=(3,), num_fixed_samples=2))


def _jax_states(params, opt_states):
    adam = [s.inner_state[0] for s in opt_states]
    return {
        "params": flatten_tree(to_numpy(params)),
        "mu": [flatten_tree(to_numpy(a.mu)) for a in adam],
        "nu": [flatten_tree(to_numpy(a.nu)) for a in adam],
        "count": [int(a.count) for a in adam],
    }


def _jax_epochs(jd, jv, config, epochs, batches):
    """The JAX trainer's step function over ``epochs`` (a list of flags),
    ``batches`` (a list per epoch): the state before the first step and
    after each, params and the two masked Adam states."""
    recon_mask, lik_mask = nonsquare_param_masks(jd, jv["params"])
    opts = [jax_make_optimizer(config, BATCHES, mask=m)[0] for m in (recon_mask, lik_mask)]
    holder = SimpleNamespace(optimizers=opts, density=jd)
    params, state = jv["params"], jv["state"]
    opt_states = [o.init(params) for o in opts]
    rng = jax.random.PRNGKey(0)
    states = [_jax_states(params, opt_states)]
    for flags, xs in zip(epochs, batches):
        i = flags["optimizer_index"]
        step = jax.jit(JaxTrainer._make_loss_step(holder, i, flags))
        lw, mw = jnp.float32(flags["likelihood_wt"]), jnp.float32(flags["metric_wt"])
        for x in xs:
            (params, state, opt_states[i], rng), _ = step((params, state, opt_states[i], rng), jnp.asarray(x), lw, mw)
            states.append(_jax_states(params, opt_states))
    return states, (recon_mask, lik_mask)


def _port_state(trainer):
    names = {p: jax_path(n) for n, p in trainer.density.named_parameters()}
    out = {"params": {names[p]: p.detach().numpy().copy() for p in names}, "mu": [], "nu": [], "count": []}
    for opt in trainer.optimizers:
        out["mu"].append({names[p]: opt.state[p]["mu"].numpy().copy() for p in opt.params})
        out["nu"].append({names[p]: opt.state[p]["nu"].numpy().copy() for p in opt.params})
        out["count"].append(int(opt.count))
    return out


def _load_state(trainer, state):
    """A JAX step's state copied into the port's tensors."""
    names = {p: jax_path(n) for n, p in trainer.density.named_parameters()}
    with torch.no_grad():
        for p, k in names.items():
            p.copy_(t(state["params"][k]))
        for i, opt in enumerate(trainer.optimizers):
            opt.count.fill_(state["count"][i])
            for p in opt.params:
                for part in ("mu", "nu"):
                    opt.state[p][part].copy_(t(state[part][i][names[p]]))


def test_reconstruction_then_likelihood_epoch_match_the_jax_step():
    """Epoch 2 (reconstruction, optimizer 0) then epoch 3 (likelihood,
    optimizer 1), two batches each; each port step from the JAX state before
    it, against the JAX state after it. Each step leaves the other group's
    parameters and its optimizer's state bit-equal in both packages, and the
    JAX gradient of the other group is exactly zero, so ``optax.masked``'s
    pass-through adds nothing."""
    jd, jv, td = _pair(seed=6)
    config = _config()
    objective = get_objective(config)
    epochs = [objective.for_epoch(2), objective.for_epoch(3)]
    assert [f["optimizer_index"] for f in epochs] == [0, 1]
    batches = [[batch(16, seed=30 + 2 * e + i) for i in range(BATCHES)] for e in range(2)]
    want, (recon_mask, lik_mask) = _jax_epochs(jd, jv, config, epochs, batches)

    # The gradient optax.masked passes through for the other group is zero.
    for flags, other in zip(epochs, (lik_mask, recon_mask)):
        grads = jax.jit(jax.grad(lambda p, x: _jax_loss(jd, jv["state"], flags)(p, x)[0]))(
            jv["params"], jnp.asarray(batches[0][0]))
        for (k, g), (_, m) in zip(flatten_tree(to_numpy(grads)).items(), flatten_tree(other).items()):
            if m:
                assert not np.any(g), f"pass-through gradient of {k} is not zero"

    trainer = Trainer(td, objective, make_optimizers(config, td, BATCHES), None, max_epochs=0)
    lik_paths = {k for k, m in flatten_tree(lik_mask).items() if m}
    steps = [(flags, x) for flags, xs in zip(epochs, batches) for x in xs]
    for s, (flags, x) in enumerate(steps):
        _load_state(trainer, want[s])
        trainer.step(t(x), flags)
        got, w, before = _port_state(trainer), want[s + 1], want[s]
        assert got["count"] == w["count"] == [min(s + 1, 2), max(s - 1, 0)]
        other = 1 - flags["optimizer_index"]
        for i in range(2):
            assert set(got["mu"][i]) == set(w["mu"][i]) == {k for k in w["params"] if (k in lik_paths) == (i == 1)}
        for k in got["mu"][other]:
            for state in (got, w):
                for part in ("mu", "nu"):
                    np.testing.assert_array_equal(state[part][other][k], before[part][other][k], err_msg=k)
                np.testing.assert_array_equal(state["params"][k], before["params"][k], err_msg=k)

        # Elements whose gradient is zero but for rounding (a coordinate the
        # decode zero-pads: 0 on one side, a rounding unit of the tensor's
        # largest entry on the other) have a first moment at rounding level,
        # which Adam turns into a move of up to about LR a step.
        mu_scale = max(np.abs(v).max() for mu in w["mu"] for v in mu.values())
        zero_mu = {k: np.abs(v) <= 1e-6 * mu_scale for mu in w["mu"] for k, v in mu.items()}
        for k, wp in w["params"].items():
            diff = np.abs(got["params"][k] - wp)
            tight = diff <= 2e-5 + 1e-4 * np.abs(wp)
            assert np.all(tight | (zero_mu[k] & (diff <= 3 * LR))), (s, k)
        for part in ("mu", "nu"):
            scale = max(np.abs(v).max() for v in w[part][flags["optimizer_index"]].values())
            for k, wv in w[part][flags["optimizer_index"]].items():
                np.testing.assert_allclose(got[part][flags["optimizer_index"]][k], wv, rtol=1e-3,
                                           atol=1e-4 * scale, err_msg=f"step {s} {part} {k}")


def test_two_optimizer_checkpoint_round_trip_is_bit_equal(tmp_path):
    """Both optimizers' counts and moments under keys that name the group,
    restored in place, bit for bit."""
    _, _, td = _pair(seed=2)
    config = _config(lr_schedule="cosine", max_epochs=4, max_grad_norm=1.0, weight_decay=0.01, opt="adamax")
    writer = Writer(str(tmp_path), make_subdir=False, tee=False)
    trainer = Trainer(td, get_objective(config), make_optimizers(config, td, BATCHES), None, max_epochs=0,
                      writer=writer, generator=torch.Generator().manual_seed(0))
    flags = _flags()
    for i, kind in enumerate(("reconstruction", "likelihood", "reconstruction")):
        trainer.step(t(batch(16, seed=50 + i)), flags[kind])
    tensors = lambda: list(td.parameters()) + [v for o in trainer.optimizers for v in o.tensors()]  # noqa: E731
    saved = [x.detach().clone() for x in tensors()]
    assert [int(o.count) for o in trainer.optimizers] == [2, 1]
    trainer._save_checkpoint("latest")
    ckpt = torch.load(tmp_path / "checkpoints" / "latest.pt", weights_only=True)
    lik_names = {n for n, p in td.named_parameters() if any(p is q for q in trainer.optimizers[1].params)}
    assert {"0/count", "1/count"} <= set(ckpt["opt_states"])
    assert {k.split("/")[1] for k in ckpt["opt_states"] if k.startswith("1/") and k != "1/count"} == lik_names
    assert len(ckpt["opt_states"]) == 2 + 2 * len(list(td.parameters()))

    ptrs = [x.data_ptr() for x in tensors()]
    with torch.no_grad():
        for x in tensors():
            x.copy_(torch.randint_like(x, 0, 7) if not x.is_floating_point() else torch.randn_like(x))
    trainer._load_checkpoint("latest")
    assert [x.data_ptr() for x in tensors()] == ptrs
    for got, want in zip(tensors(), saved):
        assert got.dtype == want.dtype and torch.equal(got, want)


class _Scalars:
    """Records every scalar a CLI run writes through its DummyWriter."""

    def __init__(self, monkeypatch, cls):
        self.rows = []
        monkeypatch.setattr(cls, "write_scalar",
                            lambda _, tag, value, global_step=None: self.rows.append((tag, global_step, float(value))))

    def steps(self, tag):
        return {s: v for k, s, v in self.rows if k.endswith(tag)}


def _jax_adam_counts(trainer):
    return [int(s.inner_state[0].count) for s in trainer.opt_states]


SPHERE = ["--dataset", "sphere", "--config", "max_epochs=4", "--config", "max_dataset_size=3000",
          "--config", "train_batch_size=250", "--config", "lr_schedule=cosine"]
MINIBOONE = ["--dataset", "miniboone", "--synthetic-data", "--config", "max_epochs=4",
             "--config", "max_dataset_size=200", "--config", "train_batch_size=40",
             "--config", "likelihood_warmup_start=1", "--config", "likelihood_warmup_end=2",
             "--config", "num_fid_samples=100", "--config", "test_batch_size=100",
             "--config", "num_density_layers=2", "--config", "coupler_hidden_channels=[16]",
             "--config", "prior_num_density_layers=2", "--config", "prior_hidden_channels=[8]",
             "--config", "latent_dimension=5"]


@pytest.mark.parametrize("argv", [SPHERE, MINIBOONE], ids=["sphere", "miniboone"])
def test_baseline_cli_trains_both_groups_as_cmf_tpu(argv, monkeypatch):
    """``--baseline`` through both CLIs: the M-flow head, two optimizers
    that step on alternate engine epochs (each group's count equal), the
    validation every second epoch, and the same ``train/lr`` scalars."""
    common = ["--model", "non-square", "--baseline", "--nosave", "--config", "seed=1"] + argv
    # The figures are not what this holds; the JAX package draws the
    # sphere's eagerly, in seconds.
    monkeypatch.setattr(cmf_tpu.viz, "get_visualizer", lambda *a, **k: None)
    monkeypatch.setattr(cmf_tpu_torch.viz, "get_visualizer", lambda *a, **k: None)
    theirs_rows = _Scalars(monkeypatch, JaxDummyWriter)
    setups = []
    real_train = cmf_tpu.training.train
    monkeypatch.setattr(cmf_tpu.training, "train", lambda **kw: setups.append(real_train(**kw)))
    jax_cli.main(common)
    (theirs,) = setups
    ours_rows = _Scalars(monkeypatch, DummyWriter)
    (ours,) = main(common + ["--device", "cpu"])

    jt, pt = theirs["trainer"], ours["trainer"]
    assert isinstance(theirs["density"], JaxManifoldFlowHead) and isinstance(ours["density"], ManifoldFlowHeadDensity)
    assert len(pt.optimizers) == len(jt.optimizers) == 2 and pt.valid_frequency == jt.valid_frequency == 2
    assert [int(o.count) for o in pt.optimizers] == _jax_adam_counts(jt)
    assert all(int(o.count) > 0 for o in pt.optimizers)
    assert sorted({h[0] for h in pt.history}) == [e for e in range(1, 5) if not pt.objective.for_epoch(e)["skip_epoch"]]
    assert all(np.isfinite(h[1]) for h in pt.history)
    for tag in ("valid/loss", "train/lr", "train/loss"):
        assert sorted(ours_rows.steps(tag)) == sorted(theirs_rows.steps(tag)), tag
    assert sorted(ours_rows.steps("valid/loss")) == [e for e in (2, 4) if e >= pt.early_stopping_start_epoch]
    assert ours_rows.steps("train/lr") == theirs_rows.steps("train/lr") and ours_rows.steps("train/lr")
    assert all(np.isfinite(v) for v in ours_rows.steps("valid/loss").values())
