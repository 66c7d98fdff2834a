"""The image square flows and image CIFs of the port against the JAX
package: the batch-norm layer (training mode, with and without detached
statistics, its running statistics after one and three steps; eval mode),
the ResNet coupler with batch-norm, and the multiscale RealNVP of
``--dataset mnist --model realnvp`` with and without ``--baseline`` cut to
8×8 images and widths of 2-4 (the training elbo, every gradient and the
state after the step; the eval elbo and samples on the same draws). Then
the trainer's hold on the batch-norm state (a non-finite step, a resume)
and the config check (``tests/test_torch_glow.py`` holds glow's layers and models,
``tests/test_torch_image_square_cli.py`` both CLIs' introspection)."""

import contextlib
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.nets.core import ResNet as JaxResNet
from cmf_tpu.nets.core import _BatchNorm2d as JaxBatchNorm2d
from cmf_tpu_torch.interop import flatten_tree, jax_path, variables_from_jax
from cmf_tpu_torch.main import main
from cmf_tpu_torch.nets import BatchNorm2d, ResNet, batch_statistics
from cmf_tpu_torch.ops import coupler_stack as cs
from cmf_tpu_torch.training import Trainer, get_objective, make_optimizer
from cmf_tpu_torch.training.experiment import check_supported

from _torch_image_square import (
    BATCH,
    COMMANDS,
    VALUE_TOL,
    batch_norm_layers,
    build_pair,
    check_eval_and_samples,
    check_train_step,
    command_config,
    images,
    perturbed,
    x_shape,
)
from _torch_parity import to_numpy
from _torch_tabular import GRAD_TOL, rel_err, t


def _normal(shape, seed, scale=1.0, shift=0.0):
    return (shift + scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _net_grads(jax_net, port, variables, x, train, seed):
    """Output, new state and the gradients of a random linear functional of
    the output in the parameters and the input: the JAX net's (jitted) and
    the port's on the same weights; the port's state is its buffers after
    the call."""
    w = _normal((x.shape[0], *jax_net_out_shape(jax_net, variables, x)[1:]), seed)

    @jax.jit
    def jax_side(params, xx):
        def f(p, xi):
            out, state = jax_net.apply({"params": p, "state": variables["state"]}, xi, train)
            return jnp.sum(out * w), (out, state)

        (_, (out, state)), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, xx)
        return out, state, grads

    out_j, state_j, (gp_j, gx_j) = jax_side(variables["params"], jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    with batch_statistics(port) if train else contextlib.nullcontext():
        out_t = port(xt)
    (out_t * t(w)).sum().backward()
    return out_t.detach().numpy(), out_j, state_j, gp_j, (xt.grad.numpy(), gx_j)


def jax_net_out_shape(jax_net, variables, x):
    return jax.eval_shape(lambda xx: jax_net.apply(variables, xx, False)[0], jnp.asarray(x)).shape


def assert_net_matches(port, out_t, out_j, state_j, gp_j, gx):
    assert rel_err(out_t, out_j) <= VALUE_TOL
    assert rel_err(*gx) <= GRAD_TOL
    want = flatten_tree(to_numpy(gp_j))
    got = {jax_path(n): p.grad.numpy() for n, p in port.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        assert rel_err(got[k], want[k]) <= GRAD_TOL, k
    state = flatten_tree(to_numpy(state_j))
    buffers = {n: b.numpy() for n, b in port.state_dict().items() if n not in got}
    assert set(buffers) == set(state)
    for k in state:
        assert rel_err(buffers[k], state[k]) <= VALUE_TOL, k


@pytest.mark.parametrize("detach", [False, True])
def test_batch_norm_train_mode_matches_cmf_tpu(detach):
    """Batch statistics with the biased variance, for the output, the
    gradient (through the statistics, or not with ``detach``) and the
    running statistics, after one step and after three."""
    jax_bn = JaxBatchNorm2d(3, detach=detach)
    variables = perturbed(jax_bn.init(jax.random.PRNGKey(0)), 1, scale=0.3)
    port = BatchNorm2d(3, detach=detach)
    variables_from_jax(port, to_numpy(variables))
    x = _normal((4, 3, 5, 5), 2, scale=2.0, shift=0.5)
    first = _net_grads(jax_bn, port, variables, x, True, 3)
    assert_net_matches(port, *first)

    state = first[2]
    for step in range(2):
        xs = _normal((4, 3, 5, 5), 10 + step, scale=1.0 + step)
        _, state = jax.jit(lambda v, xx: jax_bn.apply(v, xx, True))({"params": variables["params"], "state": state},
                                                                     jnp.asarray(xs))
        with batch_statistics(port):
            port(t(xs))
    for k in ("mean", "var"):
        assert rel_err(getattr(port, k).numpy(), state[k]) <= VALUE_TOL
    # The running variance moves by the biased batch variance (PyTorch's
    # own batch-norm would move it by the unbiased one).
    fresh = BatchNorm2d(3)
    with batch_statistics(fresh):
        fresh(t(xs))
    np.testing.assert_allclose(fresh.var.numpy(), 0.9 + 0.1 * np.var(xs, axis=(0, 2, 3)), rtol=1e-6)


def test_batch_norm_eval_mode_matches_cmf_tpu():
    """Outside the training switch: the running statistics, which stay."""
    jax_bn = JaxBatchNorm2d(3)
    variables = perturbed(jax_bn.init(jax.random.PRNGKey(4)), 5, scale=0.3)
    port = BatchNorm2d(3)
    variables_from_jax(port, to_numpy(variables))
    x = _normal((4, 3, 5, 5), 6, scale=2.0)
    assert_net_matches(port, *_net_grads(jax_bn, port, variables, x, False, 7))
    np.testing.assert_array_equal(port.var.numpy(), np.asarray(variables["state"]["var"]))


@pytest.mark.parametrize("train, detach", [(True, False), (True, True), (False, False)])
def test_batch_norm_resnet_matches_cmf_tpu(train, detach):
    """The ResNet coupler with batch-norm (bias-free block convs, ``out_bn``
    before the last relu): output, gradients and state; under inference
    mode it keeps the conv modules, never the coupler kernel."""
    jax_net = JaxResNet(2, [4, 4], 4, use_batchnorm=True, detach_bn=detach)
    variables = perturbed(jax_net.init(jax.random.PRNGKey(8)), 9, scale=0.2)
    port = ResNet(2, [4, 4], 4, use_batchnorm=True, detach_bn=detach)
    variables_from_jax(port, to_numpy(variables))
    assert port.blocks[0].conv1.b is None and port.conv_out.b is not None
    x = _normal((4, 2, 6, 6), 10)
    assert_net_matches(port, *_net_grads(jax_net, port, variables, x, train, 11))
    if not train:
        calls = cs.CALLS
        with torch.inference_mode():
            routed = port(t(x))
        assert cs.CALLS == calls
        with torch.no_grad():
            np.testing.assert_array_equal(routed.numpy(), port(t(x)).numpy())


REALNVP = ["realnvp-mnist-baseline", "realnvp-mnist"]


@pytest.mark.parametrize("name", REALNVP)
def test_realnvp_train_step_matches_cmf_tpu(name, monkeypatch):
    check_train_step(name, monkeypatch)


@pytest.mark.parametrize("name", REALNVP)
def test_realnvp_eval_elbo_and_samples_match_cmf_tpu(name, monkeypatch):
    check_eval_and_samples(name, monkeypatch)


def _trainer(name, **kwargs):
    config, _, _, td = build_pair(name)
    config = {**config, "lr": 1e-3}
    objective = get_objective(config)
    optimizer = make_optimizer(config, td.parameters(), 10)
    return td, objective, Trainer(td, objective, [optimizer], [], max_epochs=0,
                                  generator=torch.Generator().manual_seed(0), **kwargs)


def test_non_finite_step_keeps_the_batch_norm_state():
    """A step whose loss is not finite leaves every running statistic, as
    every parameter, as it was; a finite one moves them."""
    td, objective, trainer = _trainer("realnvp-mnist-baseline")
    before = {n: b.clone() for n, b in td.state_dict().items()}
    x = t(images(BATCH, x_shape("realnvp-mnist-baseline"), 0))
    bad = x.clone()
    bad[0, 0, 0, 0] = math.nan
    loss, _ = trainer.eager_step(bad, objective.for_epoch(1))
    assert not math.isfinite(float(loss))
    for n, b in td.state_dict().items():
        torch.testing.assert_close(b, before[n], rtol=0, atol=0, msg=n)
    loss, _ = trainer.eager_step(x, objective.for_epoch(1))
    assert math.isfinite(float(loss))
    moved = [n for n, b in td.state_dict().items() if n.endswith(".var") and not torch.equal(b, before[n])]
    assert len(moved) == sum(1 for _ in batch_norm_layers(td))
    assert all(not layer.batch_stats for layer in batch_norm_layers(td))


@pytest.fixture
def _quiet(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    # The CLI's writer tees stdout and stderr: put them back after the test.
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)


def test_resume_restores_the_batch_norm_state(tmp_path, _quiet):
    """A run dir's ``latest`` holds the running statistics; a resume
    restores them bit-equal before it trains on."""
    cut = ["--config", "g_hidden_channels=[4]", "--config", "max_dataset_size=40",
           "--config", "train_batch_size=20", "--config", "use_fid=False", "--config", "early_stopping=False",
           "--config", "epochs_per_test=100", "--config", "num_test_elbo_samples=1"]
    argv = ["--model", "realnvp", "--dataset", "mnist", "--baseline", "--synthetic-data", "--device", "cpu",
            "--logdir-root", str(tmp_path), "--config", "max_epochs=1"] + cut
    (setup,) = main(argv)
    saved = {n: b.clone() for n, b in setup["density"].state_dict().items() if n.endswith((".mean", ".var"))}
    assert saved and any(not torch.equal(b, torch.zeros_like(b)) for n, b in saved.items() if n.endswith(".mean"))
    run_dir = setup["writer"].logdir
    config_path = f"{run_dir}/config.json"
    with open(config_path) as f:
        config = json.load(f)
    with open(config_path, "w") as f:
        json.dump({**config, "max_epochs": 1}, f)
    (resumed,) = main(["--resume", run_dir, "--device", "cpu"])
    assert resumed["trainer"].restored_from == "latest" and resumed["trainer"].epoch == 1
    for n, b in resumed["density"].state_dict().items():
        if n in saved:
            torch.testing.assert_close(b, saved[n], rtol=0, atol=0, msg=n)


def test_non_square_batch_norm_resnet_is_refused_before_any_work(_quiet):
    """The non-square model with batch-norm ResNet couplers is no longer
    refused: ``--model non-square --dataset mnist --config
    resnet_batchnorm=True`` builds and takes one CPU step at cut widths,
    the couplers' running statistics moved by the forward; and every
    image square command passes the config check."""
    (setup,) = main([
        "--model", "non-square", "--dataset", "mnist", "--synthetic-data", "--device", "cpu", "--nosave",
        "--config", "resnet_batchnorm=True", "--config", "g_hidden_channels=[4]",
        "--config", "prior_hidden_channels=[8]", "--config", "prior_num_density_layers=2",
        "--config", "smaller_realnvp=True", "--config", "max_epochs=1", "--config", "max_dataset_size=50",
        "--config", "train_batch_size=50", "--config", "likelihood_warmup=False", "--config", "use_fid=False",
        "--config", "early_stopping=False", "--config", "seed=0",
    ])
    history = setup["trainer"].history
    assert len(history) == 1 and all(math.isfinite(h[1]) for h in history)
    means = [m.mean for m in setup["density"].modules() if isinstance(m, BatchNorm2d)]
    assert len(means) == 6 * 3 and all(not torch.equal(m, torch.zeros_like(m)) for m in means)
    for name in COMMANDS:
        check_supported(command_config(name), write_to_disk=False)


