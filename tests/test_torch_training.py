"""The port's train loop against the JAX package: a 3-step loss and
parameter trajectory against an optax Adam loop from the same start and
batches, the objective flags, the loader's batches, and the CLI on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cmf_tpu.config import expand_grid, get_config
from cmf_tpu.data.loaders import ArrayLoader as JaxArrayLoader
from cmf_tpu.data.loaders import get_loaders as jax_get_loaders
from cmf_tpu.training.objectives import get_objective as jax_get_objective
from cmf_tpu_torch.config import get_schema
from cmf_tpu_torch.data import ArrayLoader, get_loaders
from cmf_tpu_torch.main import main
from cmf_tpu_torch.interop import flatten_tree
from cmf_tpu_torch.training import Trainer, check_supported, get_objective, make_optimizer
from cmf_tpu_torch.training.experiment import check_schema

from _torch_parity import (
    batch,
    build_pair,
    small_config,
    small_schema,
    t,
    to_numpy,
    torch_grads,
    torch_params,
)

LR = 1e-3  # large enough that three steps move every parameter


def test_three_step_trajectory_matches_optax_adam():
    """Step 1 is a warmup step (likelihood off: the latent prior gets zero
    gradients, which Adam must still count), steps 2-3 have it on."""
    jd, jv, td = build_pair(small_schema(), seed=8)
    objective = get_objective(small_config())  # likelihood warmup 25 → 50
    flags = [objective.for_epoch(1), objective.for_epoch(49), objective.for_epoch(60)]
    assert [f["skip_likelihood"] for f in flags] == [True, False, False]
    xs = [batch(16, seed=20 + i) for i in range(3)]

    opt = optax.chain(optax.scale_by_adam(), optax.scale_by_learning_rate(LR))
    params, opt_state = jv["params"], opt.init(jv["params"])
    trainer = Trainer(td, objective, [make_optimizer({"lr": LR}, td.parameters())], [], max_epochs=0)
    losses_j, losses_t, rounding_only = [], [], {}
    for x, f in zip(xs, flags):
        def loss_fn(p, f=f, x=x):
            info, _ = jd.elbo(
                {"params": p, "state": jv["state"]}, jnp.asarray(x), train=True,
                likelihood_wt=f["likelihood_wt"], metric_wt=f["metric_wt"],
                add_reconstruction=f["add_reconstruction"],
                add_diagonal_metric_reg=f["add_diagonal_metric_reg"],
                add_offdiagonal_metric_reg=f["add_offdiagonal_metric_reg"],
                skip_likelihood=bool(f["skip_likelihood"]),
            )
            return -jnp.mean(info["elbo"])

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses_j.append(float(loss))
        losses_t.append(float(trainer.step(t(x), f)[0]))
        # Elements whose JAX gradient is exactly zero (a channel the decode
        # zero-pads) where the port's is one rounding unit.
        grads_t = torch_grads(td)
        for k, g in flatten_tree(to_numpy(grads)).items():
            rounding_only[k] = rounding_only.get(k, False) | ((g == 0) & (grads_t[k] != 0))

    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    # Adam moves an element by about LR whatever the size of its gradient,
    # so a rounding-unit gradient may move an element by up to LR; every
    # other element must follow the JAX trajectory closely.
    got, want = torch_params(td), flatten_tree(to_numpy(params))
    assert set(got) == set(want)
    for k in want:
        diff = np.abs(got[k] - want[k])
        tight = diff <= 2e-5 + 1e-4 * np.abs(want[k])
        assert np.all(tight | (rounding_only[k] & (diff <= 3 * LR))), k
    assert sum(int(m.sum()) for m in rounding_only.values()) < 0.01 * sum(m.size for m in rounding_only.values())


@pytest.mark.parametrize(
    "overrides",
    [{}, {"likelihood_warmup": False}, {"g_kk_loss": True}, {"g_ij_loss": True},
     {"m_flow": True}, {"m_flow": True, "likelihood_warmup": False}],
    ids=["default", "no-warmup", "g_kk", "g_ij", "m_flow", "m_flow-no-warmup"],
)
def test_objective_flags_match(overrides):
    config = small_config(**overrides)
    ours, theirs = get_objective(config), jax_get_objective(config)
    assert ours.early_stopping_start_epoch == theirs.early_stopping_start_epoch
    for epoch in range(1, 61):
        assert ours.for_epoch(epoch) == theirs.for_epoch(epoch), epoch


def test_loader_batches_match_array_loader():
    x = np.random.default_rng(0).normal(size=(103, 4)).astype(np.float32)
    ours = ArrayLoader(x, 10, "cpu", shuffle=True, drop_last=True, seed=3)
    theirs = JaxArrayLoader(x, 10, shuffle=True, drop_last=True, seed=3)
    for _ in range(2):  # two epochs: the shuffle follows (seed, epoch)
        got = [b.numpy() for b in ours]
        want = [np.asarray(b) for b in theirs]
        assert len(got) == len(want) == 10
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_get_loaders_matches_with_dataset_cap():
    config = {**small_config(), "max_dataset_size": 500}
    ours = get_loaders("miniboone", config, "cpu", seed=2, synthetic=True)
    theirs = jax_get_loaders("miniboone", config, seed=2, synthetic=True)
    for o, w in zip(ours, theirs):
        np.testing.assert_array_equal(o.x, w.x)
        assert len(o) == len(w)
    assert ours[0].num_examples == 500


def _flagship(**overrides):
    return {**small_config(), "model": "non-square", "dataset": "miniboone", **overrides}


def _published(model, dataset="miniboone", baseline=False, **overrides):
    config = expand_grid(get_config(dataset, model, use_baseline=baseline))[0]
    return {**config, "model": model, "dataset": dataset, **overrides}


_PORTED = [
    (lambda: _flagship(dataset="mnist", test_metric=True), "dataset-mnist-test_metric-True"),
    (lambda: _flagship(dataset="mnist", test_center=True), "dataset-mnist-test_center-True"),
    (lambda: _flagship(m_flow=True), "m_flow-True"),
    (lambda: _flagship(lr_schedule="cosine"), "lr_schedule-cosine"),
    (lambda: _flagship(max_grad_norm=1.0), "max_grad_norm-1.0"),
    (lambda: _flagship(opt="adamax"), "opt-adamax"),
    (lambda: _published("maf"), "maf-miniboone"),
    (lambda: _published("nsf-ar", baseline=True), "nsf-ar-miniboone-baseline"),
    (lambda: _published("nsf-ar"), "nsf-ar-miniboone"),
    (lambda: _published("cond-affine"), "cond-affine-miniboone"),
    (lambda: _published("glow", "mnist"), "glow-mnist"),
    (lambda: _published("realnvp", "mnist"), "realnvp-mnist"),
    (lambda: _published("bnaf", "2uniforms"), "bnaf-2uniforms"),
    (lambda: _published("planar", "2uniforms", baseline=True), "planar-2uniforms-baseline"),
    (lambda: _published("planar", "2uniforms"), "planar-2uniforms"),
    (lambda: _published("nsf-ar", baseline=True, autoregressive=False), "nsf-c-miniboone-baseline"),
    (lambda: _published("realnvp"), "realnvp-miniboone"),
    (lambda: _published("realnvp", baseline=True), "realnvp-miniboone-baseline"),
    (lambda: _published("maf", baseline=True), "maf-miniboone-baseline"),
    (lambda: _published("sos", baseline=True), "sos-miniboone-baseline"),
    (lambda: _flagship(log_jacobian_method="hutch_with_cg"), "log_jacobian_method-hutch_with_cg"),
]
# (config, id, what the refusal must name): one case per layer type that
# waits, each from a published config that has it.
_UNPORTED = [
    (lambda: _flagship(checkpoint_backend="orbax"), "checkpoint_backend-orbax", "JAX package's backend"),
    (lambda: _flagship(compute_dtype="bfloat16"), "compute_dtype-bfloat16", "compute_dtype"),
    (lambda: _published("non-square", "mnist", resnet_batchnorm=True), "non-square-mnist-resnet_batchnorm-True",
     "non-square model with batch-norm `resnet' couplers"),
    (lambda: _flagship(batch_norm=True), "batch_norm-True", "non-square model with `batch-norm' layers"),
]


@pytest.mark.parametrize("make, match", [(m, w) for m, _, w in _UNPORTED], ids=[i for _, i, _ in _UNPORTED])
def test_unported_config_raises(make, match):
    """The flagship's published defaults pass (a run dir, early stopping,
    FID), and so do mnist's. Still refused, naming what waits: the orbax
    checkpoint backend, bfloat16 compute, and batch-norm in a non-square
    model (its couplers' or its own layers')."""
    config = _flagship()
    assert config["early_stopping"] and config["use_fid"] and not config.get("nosave")
    check_supported(config)
    check_supported({**config, "dataset": "mnist"})
    with pytest.raises(NotImplementedError, match="later slice|JAX package's backend") as raised:
        check_supported(make())
    assert match in str(raised.value)


def test_acl_with_u_channels_is_refused():
    """No published config gives an affine coupling u-channels; a schema
    that does is refused by name."""
    schema = small_schema()
    schema = [{**layer, "num_u_channels": 2} if layer["type"] == "acl" else layer for layer in schema]
    with pytest.raises(NotImplementedError, match="`acl' layer with u-channels"):
        check_schema(schema)


@pytest.mark.parametrize("make", [m for m, _ in _PORTED], ids=[i for _, i in _PORTED])
def test_ported_config_passes(make):
    """mnist's metric and centering analyses into a run dir (matplotlib
    imports here), the M-flow baseline, the optimizer options, the
    tabular square NSF and CIFs, the image square flow and CIF with
    their invconvs, GlowCNN and batch-norm ResNet couplers, the 2-D
    zoo's BNAF and planar flows and the coupled spline, the tabular
    batch-norm models under the passthrough wrapper (realnvp with and
    without ``--baseline``, ``maf --baseline``, ``sos --baseline``) and
    the flagship's Hutchinson estimate, with their published settings."""
    check_supported(make())


@pytest.mark.parametrize("nets, net_type", [
    ({"p_nets": "learned-constant", "q_nets": "fixed-constant"}, "constant"),
    ({"p_nets": "identity"}, "identity"),
], ids=["constant", "identity"])
def test_constant_and_identity_coupler_nets_build(nets, net_type):
    """``--config p_nets=learned-constant|identity`` and ``q_nets=
    fixed-constant`` on the 2-D CIF-MAF: the config check passes, the
    factory builds the nets (the identity's 2 inputs are u's mean and
    log-stddev) and the elbo is finite."""
    from cmf_tpu_torch.models import get_density
    from cmf_tpu_torch.nets import ConstantNetwork, IdentityNetwork

    config = _published("maf", "2uniforms", **nets)
    schema = get_schema(config)
    assert net_type in {layer["p_coupler"]["shift_log_scale_net"]["type"] for layer in schema if "p_coupler" in layer}
    check_supported(config)
    density = get_density(schema, x_shape=(2,), device="cpu", generator=torch.Generator().manual_seed(0))
    cls = ConstantNetwork if net_type == "constant" else IdentityNetwork
    assert sum(isinstance(m, cls) for m in density.modules()) == (10 if net_type == "constant" else 5)
    x = torch.randn(16, 2, generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(density.elbo(x, generator=torch.Generator().manual_seed(2))["elbo"]).all()


def test_mnist_published_defaults_pass():
    """The image model's default run: a run dir, early stopping and FID on
    image features, with every other published setting."""
    config = expand_grid(get_config("mnist", "non-square", use_baseline=False))[0]
    config = {**config, "model": "non-square", "dataset": "mnist"}
    assert config["use_fid"] and config["early_stopping"] and not config.get("nosave")
    assert config["num_fid_samples"] == 10_000 and config["epochs_per_test"] == 10
    check_supported(config)


CLI_ARGS = [
    "--model", "non-square", "--dataset", "miniboone", "--synthetic-data", "--nosave",
    "--config", "likelihood_warmup=False", "--config", "max_epochs=2",
    "--config", "max_dataset_size=120", "--config", "train_batch_size=40",
    "--config", "num_density_layers=2", "--config", "coupler_hidden_channels=[16]",
    "--config", "prior_num_density_layers=2", "--config", "prior_hidden_channels=[8]",
    "--config", "latent_dimension=5", "--config", "seed=1",
    "--config", "early_stopping=False", "--config", "use_fid=False",
]


def test_cli_trains_on_cpu():
    from cmf_tpu_torch.ops import gram_logdet as gl

    launches = gl.launch_counts()
    (setup,) = main(CLI_ARGS + ["--device", "cpu"])
    history = setup["trainer"].history
    assert len(history) == 6  # 2 epochs × 3 batches of 40
    assert all(np.isfinite(h[1]) and not h[3] for h in history)
    assert gl.launch_counts() == launches
    assert all(p.device.type == "cpu" for p in setup["density"].parameters())
    assert torch.backends.cuda.matmul.allow_tf32 is False
