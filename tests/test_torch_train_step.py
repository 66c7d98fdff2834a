"""The port's one training step (``cmf_tpu_torch/training/trainer.py``)
against the JAX package's scanned epoch, and its "no host read" rule.

The JAX side is ``Trainer._make_loss_step`` of ``cmf_tpu`` under
``lax.scan``, as ``Trainer._get_epoch_fn`` runs it, with optax's Adam built
as ``tests/test_torch_training.py`` builds it. The third of four batches is
NaN, as ``tests/test_training.py::test_nan_epoch_preserves_last_finite_params``
poisons one: both packages keep the state of step 2 through step 3, carry on
from it at step 4, and the port raises at the epoch's end.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cmf_tpu.training.trainer import Trainer as JaxTrainer
from cmf_tpu_torch.interop import flatten_tree, jax_path
from cmf_tpu_torch.training import Trainer, get_objective, make_optimizer

from _torch_parity import DIM, batch, build_pair, small_config, small_schema, t, to_numpy

LR = 1e-3
BAD = 2  # the poisoned step, 0-based


def _jax_epoch(jd, jv, flags, batches):
    """Per step: (loss, grad_norm, params, Adam state) after it."""
    opt = optax.chain(optax.scale_by_adam(), optax.scale_by_learning_rate(LR))
    inner = JaxTrainer._make_loss_step(SimpleNamespace(optimizers=[opt], density=jd), 0, flags)
    lw = jnp.asarray(flags["likelihood_wt"], jnp.float32)
    mw = jnp.asarray(flags["metric_wt"], jnp.float32)

    def body(carry, x):
        carry, (loss, grad_norm) = inner(carry, x, lw, mw)
        return carry, (loss, grad_norm, carry[0], carry[2][0])

    carry = (jv["params"], jv["state"], opt.init(jv["params"]), jax.random.PRNGKey(0))
    _, per_step = jax.jit(lambda c, b: jax.lax.scan(body, c, b))(carry, jnp.asarray(batches))
    losses, norms, params, adam = per_step
    steps = []
    for s in range(len(batches)):
        pick = lambda tree: flatten_tree(to_numpy(jax.tree.map(lambda a: a[s], tree)))  # noqa: E731
        steps.append({
            "params": pick(params), "mu": pick(adam.mu), "nu": pick(adam.nu),
            "count": int(adam.count[s]),
        })
    return np.asarray(losses), np.asarray(norms), steps


def _port_state(trainer):
    (optimizer,) = trainer.optimizers
    out = {"params": {}, "mu": {}, "nu": {}, "count": int(optimizer.count)}
    for name, p in trainer.density.named_parameters():
        state = optimizer.state[p]
        out["params"][jax_path(name)] = p.detach().numpy().copy()
        out["mu"][jax_path(name)] = state["mu"].numpy().copy()
        out["nu"][jax_path(name)] = state["nu"].numpy().copy()
    return out


def test_poisoned_epoch_matches_scanned_epoch():
    jd, jv, td = build_pair(small_schema(), seed=9)
    objective = get_objective(small_config(likelihood_warmup=False))
    flags = objective.for_epoch(1)
    assert not flags["skip_likelihood"]
    batches = np.stack([batch(16, seed=40 + i) for i in range(4)])
    batches[BAD] = np.nan

    losses_j, norms_j, steps_j = _jax_epoch(jd, jv, flags, batches)

    trainer = Trainer(td, objective, [make_optimizer({"lr": LR}, td.parameters())], None, max_epochs=1)
    steps_t = []

    def loader():  # the state after each step, as the epoch asks for the next batch
        for x in batches:
            yield t(x)
            steps_t.append(_port_state(trainer))

    trainer.train_loader = loader()
    with pytest.raises(FloatingPointError):
        trainer.train()
    assert len(steps_t) == len(trainer.history) == 4
    losses_t = np.array([h[1] for h in trainer.history])
    norms_t = np.array([h[2] for h in trainer.history])
    assert np.isnan(losses_t[BAD]) and np.isnan(losses_j[BAD])
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    np.testing.assert_allclose(norms_t, norms_j, rtol=1e-3)

    # The bad step leaves the state as it was, bit for bit, in each package.
    for state in (steps_t, steps_j):
        for part in ("params", "mu", "nu"):
            for k, v in state[BAD][part].items():
                np.testing.assert_array_equal(v, state[BAD - 1][part][k], err_msg=f"{part} {k}")
        assert state[BAD]["count"] == state[BAD - 1]["count"] == BAD
    assert steps_t[-1]["count"] == steps_j[-1]["count"] == 3

    # Elements the JAX gradient leaves exactly zero (a channel the decode
    # zero-pads) get a rounding-unit gradient in the port, which Adam turns
    # into a move of up to about LR a step (test_torch_training.py).
    for s, (got, want) in enumerate(zip(steps_t, steps_j)):
        zero_mu = {k: v == 0 for k, v in want["mu"].items()}
        for k, w in want["params"].items():
            diff = np.abs(got["params"][k] - w)
            tight = diff <= 2e-5 + 1e-4 * np.abs(w)
            assert np.all(tight | (zero_mu[k] & (diff <= 3 * LR * (s + 1)))), (s, k)
        for part in ("mu", "nu"):
            scale = max(np.abs(v).max() for v in want[part].values())
            for k, w in want[part].items():
                np.testing.assert_allclose(got[part][k], w, rtol=1e-3, atol=1e-4 * scale,
                                           err_msg=f"step {s} {part} {k}")


HOST_READS = ("__bool__", "item", "tolist", "__float__", "__int__", "numpy", "__array__")


def test_exact_step_makes_no_host_read(monkeypatch):
    """One exact-path step on the CPU with every way to read a tensor on the
    host refused, the optimizer's update included: its count lives beside
    the parameters, on the CPU here and on the card there."""
    _, _, td = build_pair(small_schema(), seed=5)
    objective = get_objective(small_config(likelihood_warmup=False))
    flags = objective.for_epoch(1)
    optimizer = make_optimizer({"lr": LR}, td.parameters())
    trainer = Trainer(td, objective, [optimizer], None, max_epochs=1)
    x = t(batch(16, seed=1))
    td._dense_decode_program()  # set-up, made once per model

    def refused(name):
        real = getattr(torch.Tensor, name)

        def read(tensor, *args, **kwargs):
            raise AssertionError(f"host read in the train step: Tensor.{name}")

        return read

    reads = {name: refused(name) for name in HOST_READS}
    for name, fn in reads.items():
        monkeypatch.setattr(torch.Tensor, name, fn)
    loss, grad_norm = trainer.step(x, flags)
    monkeypatch.undo()
    assert torch.isfinite(loss) and torch.isfinite(grad_norm)
    assert trainer.captured is False


def test_first_step_non_finite_keeps_initial_state():
    """Adam's state exists from the trainer's start, so a NaN first step
    keeps the count and both moments at zero and the weights as they were,
    and the next step is Adam's first."""
    _, _, td = build_pair(small_schema(), seed=3)
    objective = get_objective(small_config(likelihood_warmup=False))
    flags = objective.for_epoch(1)
    trainer = Trainer(td, objective, [make_optimizer({"lr": LR}, td.parameters())], None, max_epochs=1)
    before = _port_state(trainer)
    assert before["count"] == 0
    assert all(not v.any() for part in ("mu", "nu") for v in before[part].values())
    loss, _ = trainer.step(t(np.full((16, DIM), np.nan, np.float32)), flags)
    assert torch.isnan(loss)
    after = _port_state(trainer)
    for part in ("params", "mu", "nu"):
        for k, v in before[part].items():
            np.testing.assert_array_equal(after[part][k], v, err_msg=f"{part} {k}")
    assert after["count"] == 0
    trainer.step(t(batch(16, seed=2)), flags)
    assert _port_state(trainer)["count"] == 1


@pytest.mark.parametrize(
    "method, dequantized, want",
    [("cholesky", False, True), ("hutch_with_cg", False, False), ("cholesky", True, False)],
)
def test_step_capturable_follows_the_density(method, dequantized, want):
    """The trainer captures a step only where the density says it may: the
    exact log-det with no noise drawn. The Hutchinson probes and the
    dequantization noise are random draws; CG reads a flag on the host."""
    from cmf_tpu_torch.densities.wrapper import DequantizationDensity
    from cmf_tpu_torch.models import get_density

    density = get_density(small_schema(log_jacobian_method=method), x_shape=(DIM,), device="cpu")
    if dequantized:
        density = DequantizationDensity(density)
    assert density.step_capturable is want
