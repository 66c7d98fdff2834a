"""The port's dense augmented-batch decode program
(``cmf_tpu_torch/ops/decode_jac.py``) against the JAX package's
``extract_dense_decode_program`` on the same weights, and against
``torch.func.jacfwd`` of the port's plain decode as an independent oracle:
its flat stages on the tabular chain, its conv stages on the multiscale
image chain (values, gradients and the bf16 policy), the head's routing by
``has_conv``, and which chains the two walks cover."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.config import expand_grid
from cmf_tpu.config import get_config as jax_get_config
from cmf_tpu.config import get_schema as jax_get_schema
from cmf_tpu.models import get_density as jax_get_density
from cmf_tpu.nets import compute_dtype as jax_compute_dtype
from cmf_tpu.nets import set_compute_dtype as jax_set_compute_dtype
from cmf_tpu.ops.decode_jac import extract_dense_decode_program as jax_extract
from cmf_tpu_torch.densities import NonSquareHeadDensity
from cmf_tpu_torch.interop import variables_from_jax
from cmf_tpu_torch.models import get_density
from cmf_tpu_torch.nets import batch_statistics, compute_dtype, set_compute_dtype
from cmf_tpu_torch.ops.decode_jac import extract_dense_decode_program

from _torch_parity import DIM, assert_trees_close, batch, build_pair, small_schema, t, to_numpy, torch_grads

TOL = 1e-5  # fp32, the same formulas summed in another order


def _rich_schema():
    """Every flat step the program has: alternating ACLs both ways, an
    independent-nets coupler with relu, a flip and a channel permutation."""
    schema = small_schema()
    tail = next(i for i, layer in enumerate(schema) if layer["type"] == "non-square-base")
    acls = [i for i, layer in enumerate(schema[:tail]) if layer["type"] == "acl"]
    schema[acls[2]]["coupler"] = {
        "independent_nets": True,
        "shift_net": {"type": "mlp", "hidden_channels": [12, 12], "activation": "relu"},
        "log_scale_net": {"type": "mlp", "hidden_channels": [12, 12], "activation": "relu"},
    }
    schema.insert(acls[1], {"type": "flip"})
    schema.insert(acls[1], {"type": "rand-channel-perm"})
    return schema


SCHEMAS = {"miniboone-cut": small_schema, "rich-chain": _rich_schema}


def _program_outputs(name, seed):
    jd, jv, td = build_pair(SCHEMAS[name](), seed=seed)
    x = batch(6, seed=seed)
    pv0 = {"params": jv["params"]["prior"], "state": jv["state"]["prior"]}
    info, pstate = jd.prior.elbo(pv0, x, rng=None, train=True)
    z = np.asarray(info["low_dim_x"])
    pv = {"params": jv["params"]["prior"], "state": pstate}
    rec_j, jac_j = jax_extract(jd)(pv, z, train=True)
    program = extract_dense_decode_program(td)
    assert program is not None
    with torch.no_grad():
        rec_t, jac_t = program(t(z))
    return td, z, (rec_t, jac_t), (np.asarray(rec_j), np.asarray(jac_j))


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_program_matches_jax(name):
    _, _, (rec_t, jac_t), (rec_j, jac_j) = _program_outputs(name, seed=1)
    assert jac_t.shape == jac_j.shape == (5, 6, DIM)
    np.testing.assert_allclose(rec_t.numpy(), rec_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(jac_t.numpy(), jac_j, rtol=1e-4, atol=TOL)


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_program_matches_jacfwd_of_plain_decode(name):
    td, z, (rec_t, jac_t), _ = _program_outputs(name, seed=2)

    def decode_one(zi):
        return td.decode(zi[None]).reshape(-1)

    with torch.no_grad():
        rec = td.decode(t(z)).reshape(len(z), -1)
    np.testing.assert_allclose(rec_t.numpy(), rec.numpy(), rtol=TOL, atol=TOL)
    for b in range(len(z)):
        J = torch.func.jacfwd(decode_one)(t(z[b]))  # (D, d)
        np.testing.assert_allclose(jac_t[:, b, :].numpy(), J.T.detach().numpy(), rtol=1e-4, atol=TOL)


def test_exact_logdet_matches_brute_force():
    """log|JᵀJ| of the head's exact path against slogdet of the full
    autodiff Jacobian of the decode (tests/test_nonsquare.py's oracle)."""
    _, _, td = build_pair(small_schema(), seed=3)
    x = t(batch(4, seed=3))
    with torch.no_grad():
        z = td.prior.elbo(x)["low_dim_x"]
        log_det, _, _ = td._exact_log_det(z)
    for b in range(len(z)):
        J = torch.func.jacfwd(lambda zi: td.decode(zi[None]).reshape(-1))(z[b]).detach().double()
        np.testing.assert_allclose(
            float(log_det[b]), float(torch.linalg.slogdet(J.T @ J)[1]), rtol=1e-4, atol=1e-4
        )


def test_unsupported_chain_gives_none():
    """A chain the program does not cover gives None, as in the JAX package."""
    from types import SimpleNamespace

    from cmf_tpu_torch.densities import DiagonalGaussianDensity

    assert extract_dense_decode_program(SimpleNamespace(prior=DiagonalGaussianDensity((3,)))) is None


# ------------------------------------------------------------- conv stages
#
# The multiscale image chain of tests/test_decode_jac.py:146-158: mnist's
# non-square schema at x_shape (1, 8, 8) with ResNet couplers [4, 4] and
# d = 4 (checkerboard couplings, the squeeze, split-channel couplings, the
# non-square split, checkerboard couplings, the tail).

IMAGE_SHAPE = (1, 8, 8)


@pytest.fixture(autouse=True)
def fp32_policies():
    """Both packages' compute-dtype policies back to fp32 after each test:
    other test files run in the same process."""
    yield
    jax_set_compute_dtype("float32")
    set_compute_dtype("float32")


def image_config(**overrides):
    config = expand_grid(jax_get_config("mnist", "non-square", use_baseline=False))[0]
    config.update({"seed": 0, "g_hidden_channels": [4, 4], "prior_num_density_layers": 2,
                   "prior_hidden_channels": [8], "latent_dimension": 4})
    config.update(overrides)
    return config


def _jax_head(density, variables=None):
    """The JAX package's non-square head under ``density`` and, with
    ``variables``, its variables."""
    from cmf_tpu.densities import NonSquareHeadDensity as JaxHead

    node, hv = density, variables
    while not isinstance(node, JaxHead):
        key = "density" if hasattr(node, "density") else "prior"
        node = getattr(node, key)
        if hv is not None:
            hv = {"params": hv["params"][key], "state": hv["state"][key]}
    return node, hv


def _port_head(td):
    return next(m for m in td.modules() if isinstance(m, NonSquareHeadDensity))


def image_pair(**overrides):
    """(JAX head, its variables, the port's head) of the small image chain,
    the JAX weights carried across."""
    schema = jax_get_schema(image_config(**overrides))
    jd = jax_get_density(schema, x_shape=IMAGE_SHAPE)
    jv = jd.init(jax.random.PRNGKey(0))
    td = get_density(schema, x_shape=IMAGE_SHAPE, device="cpu")
    variables_from_jax(td, to_numpy(jv))
    jh, hv = _jax_head(jd, jv)
    return jh, hv, _port_head(td)


@pytest.fixture(scope="module")
def image():
    """One pair for the file: the JAX package's first eager calls on a
    model cost seconds each."""
    return image_pair()


def _jax_program_outputs(jh, hv, x, train):
    pv0 = {"params": hv["params"]["prior"], "state": hv["state"]["prior"]}
    info, pstate = jh.prior.elbo(pv0, jnp.asarray(x), rng=None, train=train)
    z = np.asarray(info["low_dim_x"])
    program = jax_extract(jh)
    assert program is not None and program.has_conv
    rec, cols = program({"params": hv["params"]["prior"], "state": pstate}, jnp.asarray(z), train=train)
    return z, np.asarray(rec), np.asarray(cols)


def _port_program_outputs(head, z):
    program = extract_dense_decode_program(head)
    assert program is not None and program.has_conv
    with torch.no_grad():
        rec, cols = program(t(z))
    return rec.numpy(), cols.numpy()


def _log_dets(cols):
    from cmf_tpu_torch.ops.chol import cholesky_logdet
    from cmf_tpu_torch.ops.gram import gram_from_columns

    return cholesky_logdet(gram_from_columns(t(cols)))[0].numpy()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_conv_program_matches_jax(image, train):
    """The conv program against the JAX package's on the multiscale chain,
    at the JAX package's own limits for its program against linearize+vmap
    (tests/test_decode_jac.py:161-187)."""
    jh, hv, head = image
    x = np.random.default_rng(3).uniform(0, 1, (3, *IMAGE_SHAPE)).astype(np.float32)
    z, rec_j, cols_j = _jax_program_outputs(jh, hv, x, train)
    rec_t, cols_t = _port_program_outputs(head, z)
    assert cols_t.shape == cols_j.shape == (4, 3, 64)
    np.testing.assert_allclose(rec_t, rec_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cols_t, cols_j, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_log_dets(cols_t), _log_dets(cols_j), rtol=1e-3, atol=1e-3)
    # The port's own decode agrees through the vmap of JVPs.
    with torch.no_grad():
        rec_g, cols_g = head._generic_jacobian(t(z))
    np.testing.assert_allclose(cols_t, cols_g.numpy(), rtol=1e-4, atol=TOL)


def test_conv_program_gradient_matches_jax(image):
    """Gradients of log-det plus reconstruction through the conv program
    (the encoder's forward in training mode, then the program), at the JAX
    package's limits
    (tests/test_decode_jac.py:190-220)."""
    from cmf_tpu.ops import cholesky_logdet as jax_cholesky_logdet
    from cmf_tpu.ops import gram_from_columns as jax_gram
    from cmf_tpu_torch.ops.chol import cholesky_logdet
    from cmf_tpu_torch.ops.gram import gram_from_columns

    jh, hv, head = image
    x = np.random.default_rng(4).uniform(0, 1, (2, *IMAGE_SHAPE)).astype(np.float32)
    program = jax_extract(jh)

    def loss(params):
        pv0 = {"params": params["prior"], "state": hv["state"]["prior"]}
        info, pstate = jh.prior.elbo(pv0, jnp.asarray(x), rng=None, train=True)
        rec, cols = program({"params": params["prior"], "state": pstate}, info["low_dim_x"], train=True)
        ld, _ = jax_cholesky_logdet(jax_gram(cols))
        return jnp.sum(ld) + jnp.sum((rec - x.reshape(len(x), -1)) ** 2)

    val_j, grads_j = jax.jit(jax.value_and_grad(loss))(hv["params"])
    head.zero_grad(set_to_none=True)
    with batch_statistics(head):
        z = head.prior.elbo(t(x))["low_dim_x"]
        rec, cols = extract_dense_decode_program(head)(z)
    val = cholesky_logdet(gram_from_columns(cols))[0].sum() + ((rec - t(x).reshape(len(x), -1)) ** 2).sum()
    val.backward()
    np.testing.assert_allclose(val.item(), float(val_j), rtol=1e-4)
    grads = torch_grads(head)
    scale = max(np.abs(g).max() for g in grads.values())
    assert scale > 0
    assert_trees_close(grads, grads_j, rtol=5e-3, atol=5e-4)


def _count_calls(monkeypatch, obj, name):
    calls = []
    original = getattr(obj, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(obj, name, counted)
    return calls


def test_has_conv_routes_the_head(image, monkeypatch):
    """On a conv chain 'auto' resolves to CG and the exact log-det takes the
    vmap of JVPs, as in the JAX package (nonsquare.py:220,285); an explicit
    'gram' decodes its columns through the conv program."""
    from cmf_tpu_torch.ops.decode_jac import DenseDecodeProgram

    head = image[2]
    assert head._dense_decode_program().has_conv
    assert head._resolved_hutch_solver(4) == "cg"
    program_calls = _count_calls(monkeypatch, DenseDecodeProgram, "__call__")
    generic_calls = _count_calls(monkeypatch, head, "_generic_jacobian")
    x = t(np.random.default_rng(5).uniform(0, 1, (2, *IMAGE_SHAPE)).astype(np.float32))
    with torch.no_grad():
        z = head.prior.elbo(x)["low_dim_x"]
        log_det, _, _ = head._exact_log_det(z)
    assert (len(program_calls), len(generic_calls)) == (0, 1) and torch.isfinite(log_det).all()
    monkeypatch.setattr(head, "hutchinson_solver", "gram")
    assert head._resolved_hutch_solver(4) == "gram"
    eps = torch.randn(2, 4, 1, generator=torch.Generator().manual_seed(0))
    approx, _, _ = head._approx_log_det(z, eps=eps)
    assert (len(program_calls), len(generic_calls)) == (1, 1)
    np.testing.assert_allclose(approx.detach().numpy(), log_det.numpy(), rtol=1e-4, atol=1e-4)


def _image_densities(**overrides):
    """Both packages' image densities, uninitialised: the walks read the
    layers, not the weights."""
    schema = jax_get_schema(image_config(**overrides))
    return jax_get_density(schema, x_shape=IMAGE_SHAPE), get_density(schema, x_shape=IMAGE_SHAPE, device="cpu")


def _flat_pair(**overrides):
    jd, _, td = build_pair(small_schema(**overrides))
    return jd, td


# Chains both walks must judge alike: (id, a maker of (JAX density, port
# density), whether a program covers it, whether it has conv stages).
WALK_CASES = [
    ("miniboone", lambda: _flat_pair(), True, False),
    ("miniboone-batch_norm", lambda: _flat_pair(batch_norm=True), True, False),
    ("mnist", lambda: _image_densities(), True, True),
    ("mnist-resnet_batchnorm", lambda: _image_densities(resnet_batchnorm=True), False, None),
]


@pytest.mark.parametrize("case", WALK_CASES, ids=[c[0] for c in WALK_CASES])
def test_walks_agree_on_which_chains_a_program_covers(case):
    _, make, covered, has_conv = case
    jd, td = make()
    jax_program = jax_extract(_jax_head(jd)[0])
    program = extract_dense_decode_program(_port_head(td))
    assert (jax_program is not None, program is not None) == (covered, covered)
    if covered:
        assert jax_program.has_conv == program.has_conv == has_conv
        assert [s["kind"] for s in jax_program.steps] == [s["kind"] for s in program.steps]


def test_conv_program_under_bf16_matches_jax(image):
    """Under the bf16 policy both programs round the same tensors (every
    conv's operands and output, the whole augmented batch): the port within
    1e-2 of the JAX package's columns, and closer to them than the JAX
    package's own bf16 columns are to its fp32 ones."""
    jh, hv, head = image
    x = np.random.default_rng(6).uniform(0, 1, (3, *IMAGE_SHAPE)).astype(np.float32)
    z, rec32, cols32 = _jax_program_outputs(jh, hv, x, False)
    with jax_compute_dtype("bfloat16"):
        program = jax_extract(jh)
        rec_j, cols_j = program({"params": hv["params"]["prior"], "state": hv["state"]["prior"]},
                                jnp.asarray(z), train=False)
    rec_j, cols_j = np.asarray(rec_j), np.asarray(cols_j)
    with compute_dtype("bfloat16"):
        rec_t, cols_t = _port_program_outputs(head, z)
    for got, want, fp32 in ((rec_t, rec_j, rec32), (cols_t, cols_j, cols32)):
        scale = np.abs(want).max()
        diff, gap = np.abs(got - want).max(), np.abs(fp32 - want).max()
        assert diff <= 1e-2 * scale and diff < gap, (diff, gap, scale)
