"""The port's dense augmented-batch decode program
(``cmf_tpu_torch/ops/decode_jac.py``) against the JAX package's
``extract_dense_decode_program`` on the same weights, and against
``torch.func.jacfwd`` of the port's plain decode as an independent oracle."""

import numpy as np
import pytest
import torch

from cmf_tpu.ops.decode_jac import extract_dense_decode_program as jax_extract
from cmf_tpu_torch.ops.decode_jac import extract_dense_decode_program

from _torch_parity import DIM, batch, build_pair, small_schema, t

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
