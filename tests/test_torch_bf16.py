"""The compute-precision policy (``compute_dtype="bfloat16"``) in the port
against the JAX package under its own bf16 policy, on the same weights and
inputs: the forward and the gradients of ``MLP``, ``AutoregressiveMLP``,
``ResNet`` and ``GlowCNN``; the flat dense decode program; a small
flagship-shaped head's elbo and gradients (the dense program and the exact
log-det). Then what the policy leaves alone (the coupled spline's residual
MLP), the CLI's bf16 runs, and ``check_supported``. The image head is in
``test_torch_bf16_image.py``.

Limits: values within 1e-2 relative, gradients within 5e-2 of the largest
|gradient|, and each difference below the JAX package's own gap between its
bf16 and its fp32 result at the same inputs: the two packages round the
same tensors at the same places, so they differ only where another order of
fp32 sums moves a bf16 rounding. The JAX policy is read at trace time, so
its functions are built and traced inside ``compute_dtype``."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu import nets as jax_nets
from cmf_tpu.ops.decode_jac import extract_dense_decode_program as jax_extract
from cmf_tpu_torch import nets
from cmf_tpu_torch.interop import flatten_tree, jax_path, variables_from_jax
from cmf_tpu_torch.main import main
from cmf_tpu_torch.ops.decode_jac import extract_dense_decode_program
from cmf_tpu_torch.training.experiment import check_supported

from _torch_parity import batch, build_pair, small_config, small_schema, t, to_numpy, torch_grads

VALUE_TOL = 1e-2
GRAD_TOL = 5e-2


@pytest.fixture(autouse=True)
def fp32_policies(monkeypatch):
    """Both packages' policies back to fp32 after each test (other test
    files run in the same process); the CLI's tee of stdout and stderr
    undone; no TensorBoard import."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    yield
    jax_nets.set_compute_dtype("float32")
    nets.set_compute_dtype("float32")


def assert_close_under_gap(got, want_bf16, want_fp32, tol, scale=None, name=""):
    """|got − want_bf16| within ``tol`` of ``scale`` (max |want_bf16|) and
    below |want_fp32 − want_bf16|, the JAX package's own bf16 gap."""
    got, want_bf16, want_fp32 = (np.asarray(a, np.float64) for a in (got, want_bf16, want_fp32))
    scale = np.abs(want_bf16).max() if scale is None else scale
    diff, gap = np.abs(got - want_bf16).max(), np.abs(want_fp32 - want_bf16).max()
    assert diff <= tol * scale, (name, diff, scale)
    assert diff < gap, (name, diff, gap)


def assert_grads_close_under_gap(got, want_bf16, want_fp32):
    """Every parameter's gradient as ``assert_close_under_gap``, scaled by
    the largest |gradient|; the bf16 gap taken over all of them."""
    want_bf16, want_fp32 = flatten_tree(to_numpy(want_bf16)), flatten_tree(to_numpy(want_fp32))
    assert set(got) == set(want_bf16)
    scale = max(np.abs(g).max() for g in want_bf16.values())
    diff = max(np.abs(got[k] - want_bf16[k]).max() for k in want_bf16)
    gap = max(np.abs(want_fp32[k] - want_bf16[k]).max() for k in want_bf16)
    assert diff <= GRAD_TOL * scale, (diff, scale)
    assert diff < gap, (diff, gap)


# ------------------------------------------------------------------- nets
NETS = {
    "mlp": (lambda: jax_nets.MLP(6, [16, 16], 4, jnp.tanh), (9, 6)),
    "autoregressive-mlp": (lambda: jax_nets.AutoregressiveMLP(5, [16, 16], 2, jax.nn.relu), (9, 5)),
    "resnet": (lambda: jax_nets.ResNet(2, [8, 8], 4, use_batchnorm=False), (3, 2, 6, 6)),
    "glow-cnn": (lambda: jax_nets.GlowCNN(2, 8, 4, zero_init_output=False), (3, 2, 6, 6)),
}


def _port_net(name, jax_net):
    if name == "mlp":
        return nets.MLP(6, [16, 16], 4, torch.tanh)
    if name == "autoregressive-mlp":
        return nets.AutoregressiveMLP(5, [16, 16], 2, torch.relu)
    if name == "resnet":
        return nets.ResNet(2, [8, 8], 4)
    return nets.GlowCNN(2, 8, 4, zero_init_output=False)


def _jax_net_outputs(net, variables, x, r):
    def loss(params, x):
        out, _ = net.apply({"params": params, "state": variables["state"]}, x)
        return jnp.sum(out * r), out

    (_, out), (g_params, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(variables["params"], x)
    return np.asarray(out), g_params, np.asarray(g_x)


@pytest.mark.parametrize("name", sorted(NETS))
def test_net_forward_and_gradients_match_jax(name):
    make, x_shape = NETS[name]
    jax_net = make()
    variables = to_numpy(jax_net.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    if name == "resnet":
        variables["params"]["head_w"] = rng.normal(size=(4, 1, 1)).astype(np.float32)
        variables["params"]["head_b"] = rng.normal(size=(4, 1, 1)).astype(np.float32)
    x = rng.normal(size=x_shape).astype(np.float32)
    out_shape = jax_net.apply(variables, jnp.asarray(x))[0].shape
    r = rng.normal(size=out_shape).astype(np.float32)
    out32, g32, gx32 = _jax_net_outputs(jax_net, variables, jnp.asarray(x), r)
    with jax_nets.compute_dtype("bfloat16"):
        out16, g16, gx16 = _jax_net_outputs(jax_net, variables, jnp.asarray(x), r)

    port = _port_net(name, jax_net)
    variables_from_jax(port, variables)
    xt = t(x).requires_grad_()
    with nets.compute_dtype("bfloat16"):
        out = port(xt)
    (out * t(r)).sum().backward()
    assert_close_under_gap(out.detach().numpy(), out16, out32, VALUE_TOL, name=name)
    grads = {jax_path(n): p.grad.numpy() for n, p in port.named_parameters()}
    assert_grads_close_under_gap(grads, g16, g32)
    assert_close_under_gap(xt.grad.numpy(), gx16, gx32, GRAD_TOL, name=f"{name} x")


def test_policy_strings_and_the_context():
    """"bf16" and "bfloat16" select bf16, anything else fp32, as in the JAX
    package; the context puts the previous policy back."""
    for value, want in (("bf16", torch.bfloat16), ("bfloat16", torch.bfloat16), ("float32", torch.float32),
                        ("float16", torch.float32), (None, torch.float32)):
        nets.set_compute_dtype(value)
        assert nets.get_compute_dtype() == want
    nets.set_compute_dtype("float32")
    with nets.compute_dtype("bfloat16"):
        assert nets.get_compute_dtype() == torch.bfloat16
    assert nets.get_compute_dtype() == torch.float32


def test_coupled_spline_residual_mlp_stays_fp32():
    """The coupled spline's residual MLP multiplies with a plain ``@`` in
    the JAX package (spline.py:151,158), so the bf16 policy leaves it, and
    the ``Dense`` layer it shares with ``MLP``, in fp32."""
    from cmf_tpu_torch.bijections.spline import _ResidualMLP

    net = _ResidualMLP(5, 16, 2, 7, torch.tanh, generator=torch.Generator().manual_seed(0))
    x = torch.randn(9, 5, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = net(x)
        with nets.compute_dtype("bfloat16"):
            got = net(x)
            mlp = nets.MLP(5, [16], 7, torch.tanh, generator=torch.Generator().manual_seed(0))
            rounded = mlp(x)
        fp32 = mlp(x)
    assert torch.equal(got, want)
    assert not torch.equal(rounded, fp32)


# ----------------------------------------------------------- flat program
def test_flat_program_matches_jax():
    jd, jv, td = build_pair(small_schema(), seed=1)
    x = batch(6, seed=1)
    pv0 = {"params": jv["params"]["prior"], "state": jv["state"]["prior"]}
    info, pstate = jd.prior.elbo(pv0, x, rng=None, train=False)
    z = np.asarray(info["low_dim_x"])
    pv = {"params": jv["params"]["prior"], "state": pstate}
    want32 = [np.asarray(a) for a in jax_extract(jd)(pv, z, train=False)]
    with jax_nets.compute_dtype("bfloat16"):
        want16 = [np.asarray(a) for a in jax_extract(jd)(pv, z, train=False)]
    with nets.compute_dtype("bfloat16"), torch.no_grad():
        got = extract_dense_decode_program(td)(t(z))
    for g, w16, w32, name in zip(got, want16, want32, ("recon", "columns")):
        assert_close_under_gap(g.numpy(), w16, w32, VALUE_TOL, name=name)


# -------------------------------------------------------------- the heads
def _jax_elbo_and_grads(density, variables, x, **kw):
    """(elbo, gradients) of the JAX package's training loss, fp32 then bf16,
    each traced afresh under its policy and jitted. The bf16 one compiles
    without XLA's excess precision (``xla_allow_excess_precision``), which
    lets a fusion keep a bf16 value in fp32: so compiled it rounds every
    tensor the policy names, as its eager ops and the port do."""
    def loss(params):
        info, _ = density.elbo({"params": params, "state": variables["state"]}, jnp.asarray(x), **kw)
        return -jnp.mean(info["elbo"]), info["elbo"]

    (_, elbo32), g32 = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    with jax_nets.compute_dtype("bfloat16"):
        fn = jax.jit(jax.value_and_grad(lambda p: loss(p), has_aux=True))
        compiled = fn.lower(variables["params"]).compile(compiler_options={"xla_allow_excess_precision": False})
    (_, elbo16), g16 = compiled(variables["params"])
    return (np.asarray(elbo32), g32), (np.asarray(elbo16), g16)


def test_flagship_head_matches_jax():
    """The exact log-det training elbo of a small flagship-shaped head (the
    dense program's bf16 matmuls, the fp32 Gram and Cholesky) and every
    parameter gradient."""
    jd, jv, td = build_pair(small_schema(), seed=2)
    x = batch(8, seed=2)
    (elbo32, g32), (elbo16, g16) = _jax_elbo_and_grads(jd, jv, x, rng=None, train=True)
    with nets.compute_dtype("bfloat16"):
        elbo = td.elbo(t(x), train=True)["elbo"]
    (-elbo.mean()).backward()
    assert_close_under_gap(elbo.detach().numpy(), elbo16, elbo32, VALUE_TOL, name="elbo")
    assert_grads_close_under_gap(torch_grads(td), g16, g32)


# ---------------------------------------------------------- CLI and gates
def test_check_supported_takes_bfloat16_and_still_refuses_orbax():
    """bfloat16 compute passes, with either checkpoint backend."""
    config = small_config(model="non-square", dataset="miniboone", compute_dtype="bfloat16")
    check_supported(config)
    check_supported({**config, "checkpoint_backend": "orbax"})


def test_cli_sphere_epoch_under_bf16(tmp_path, monkeypatch):
    """The counterpart of tests/test_training.py:281: a tiny sphere run
    with ``compute_dtype=bfloat16`` trains an epoch, its couplers' matmuls
    under the bf16 policy that setup sets."""
    seen = []
    original = nets.core._matmul

    def matmul(x, w):
        seen.append(nets.get_compute_dtype())
        return original(x, w)

    monkeypatch.setattr(nets.core, "_matmul", matmul)
    (setup,) = main([
        "--model", "non-square", "--dataset", "sphere", "--device", "cpu", "--nosave",
        "--config", "max_epochs=1", "--config", "max_dataset_size=1000", "--config", "seed=0",
        "--config", "num_density_layers=2", "--config", "coupler_hidden_channels=[8,8]",
        "--config", "compute_dtype=bfloat16",
    ])
    history = setup["trainer"].history
    assert history and all(np.isfinite(h[1]) for h in history)
    assert seen and set(seen) == {torch.bfloat16}


def test_cli_miniboone_bf16_trains_validates_and_tests(tmp_path):
    """The flagship under ``--config compute_dtype=bfloat16`` at small
    widths on the CPU: it trains with the likelihood on, validates by FID
    and tests, as its fp32 run does."""
    import json
    import os

    (setup,) = main([
        "--model", "non-square", "--dataset", "miniboone", "--synthetic-data", "--device", "cpu",
        "--logdir-root", str(tmp_path), "--config", "compute_dtype=bfloat16", "--config", "seed=0",
        "--config", "max_epochs=2", "--config", "max_dataset_size=120", "--config", "train_batch_size=40",
        "--config", "likelihood_warmup=False", "--config", "num_fid_samples=100",
        "--config", "test_batch_size=100", "--config", "epochs_per_test=1",
        "--config", "num_density_layers=2", "--config", "coupler_hidden_channels=[16]",
        "--config", "prior_num_density_layers=2", "--config", "prior_hidden_channels=[8]",
        "--config", "latent_dimension=5",
    ])
    assert nets.get_compute_dtype() == torch.bfloat16
    run_dir = setup["writer"].logdir
    rows = [json.loads(line) for line in open(os.path.join(run_dir, "scalars.jsonl"))]
    valid = [r["value"] for r in rows if r["tag"].endswith("valid/loss")]
    tests = [r for r in rows if "/test/" in r["tag"]]
    assert len(valid) == 2 and all(np.isfinite(valid)) and tests
    assert all(np.isfinite(h[1]) for h in setup["trainer"].history)
