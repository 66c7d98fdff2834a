"""Batch-norm in a non-square model: the port against the JAX package's
functions on the same weights (carried by ``interop``) and the same inputs.
The decode of a training elbo reads the statistics the encoder's forward
just took and differentiates through them; a coupler's batch-norm
normalises the decode's own inputs by their batch statistics and moves its
running statistics once a step, in the forward.

* ``cmf_tpu``'s own decode-path model (``tests/test_nonsquare.py:287``:
  D = 4, d = 2, a per-element batch-norm with the affine, momentum 0.1);
* a flat chain of two couplings built by the schema with ``batch_norm=True``,
  in snapshot mode (under the passthrough wrapper: its refresh and an
  evaluation elbo too) and in running-average mode with the affine, each with
  ``ignore_batch_effects`` off and on.

The image chain with batch-norm ResNet couplers is
``tests/test_torch_nonsquare_batchnorm_image.py``.

Each compares the training elbo, the gradient of its mean in every
parameter, and the state the step leaves (the post-forward statistics).
The JAX side's exact log-det takes its plain Gram and Cholesky on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.bijections.batchnorm import BatchNormBijection as JaxBatchNormBijection
from cmf_tpu.bijections.coupling import AlternatingChannelwiseCouplingBijection as JaxACL
from cmf_tpu.config import get_schema
from cmf_tpu.couplers import ChunkedSharedCoupler as JaxChunkedSharedCoupler
from cmf_tpu.densities.exact import BijectionDensity as JaxBijectionDensity
from cmf_tpu.densities.gaussian import DiagonalGaussianDensity as JaxDiagonalGaussianDensity
from cmf_tpu.densities.nonsquare import NonSquareHeadDensity as JaxHead
from cmf_tpu.densities.nonsquare import NonSquareTailDensity as JaxTail
from cmf_tpu.nets.core import MLP as JaxMLP
from cmf_tpu_torch.bijections import BatchNormBijection
from cmf_tpu_torch.bijections.coupling import AlternatingChannelwiseCouplingBijection
from cmf_tpu_torch.couplers import ChunkedSharedCoupler
from cmf_tpu_torch.densities import (
    BijectionDensity,
    DiagonalGaussianDensity,
    NonSquareHeadDensity,
    NonSquareTailDensity,
    PassthroughBeforeEvalDensity,
)
from cmf_tpu_torch.interop import variables_from_jax
from cmf_tpu_torch.nets import MLP, batch_statistics

from _torch_nonsquare_bn import (
    ELBO_TOL,
    assert_grads,
    assert_state,
    head_of,
    jax_train_step,
    port_train_elbo,
    rel_err,
)
from _torch_parity import build_pair, small_config, t, to_numpy

# The dense program against the vmap of JVPs, in the port alone.
PROGRAM_TOL = 1e-5


def assert_program_matches_jvp(td, x):
    """Inside ``batch_statistics`` after a training forward (the live
    statistics) and outside it (the running ones): the dense program's
    primal and Jacobian columns against the vmap of JVPs of the flat
    decode."""
    head = head_of(td)
    program = head._dense_decode_program()
    assert program is not None and any(s["kind"] == "bn" for s in program.steps)
    for train in (True, False):
        with torch.no_grad():
            if train:
                with batch_statistics(td):
                    z = head.prior.elbo(t(x))["low_dim_x"]
                    got, want = program(z), head._generic_jacobian(z)
            else:
                z = head.prior.elbo(t(x))["low_dim_x"]
                got, want = program(z), head._generic_jacobian(z)
        for g, w in zip(got, want):
            assert rel_err(g.numpy(), w.numpy()) <= PROGRAM_TOL


# ---------------------------------------------------------------- cmf_tpu's own model

D, LATENT = 4, 2


def _decode_path_pair():
    """``tests/test_nonsquare.py::test_batchnorm_in_decode_path``'s model in
    both packages."""

    def jax_coupler(n_pass):
        return JaxChunkedSharedCoupler(JaxMLP(n_pass, [8], 2 * (D - n_pass), jnp.tanh))

    def port_coupler(n_pass):
        return ChunkedSharedCoupler(MLP(n_pass, [8], 2 * (D - n_pass), torch.tanh))

    bn = dict(x_shape=(D,), per_channel=False, apply_affine=True, momentum=0.1)
    jd = JaxHead(
        prior=JaxBijectionDensity(
            bijection=JaxACL((D,), jax_coupler, reverse_mask=False),
            prior=JaxBijectionDensity(
                bijection=JaxBatchNormBijection(**bn),
                prior=JaxTail(prior=JaxDiagonalGaussianDensity((LATENT,)), x_shape=(D,),
                              latent_dimension=LATENT, detach_before_prior=False),
            ),
        ),
        regularization_param=1.0, log_jacobian_method="cholesky", x_shape=(D,), latent_dimension=LATENT,
    )
    td = NonSquareHeadDensity(
        BijectionDensity(
            AlternatingChannelwiseCouplingBijection((D,), port_coupler, reverse_mask=False),
            BijectionDensity(
                BatchNormBijection(**bn),
                NonSquareTailDensity(DiagonalGaussianDensity((LATENT,)), x_shape=(D,),
                                     latent_dimension=LATENT, detach_before_prior=False),
            ),
        ),
        regularization_param=1.0, log_jacobian_method="cholesky", x_shape=(D,), latent_dimension=LATENT,
    )
    jv = jd.init(jax.random.PRNGKey(0))
    variables_from_jax(td, to_numpy(jv))
    return jd, jv, td


def test_cmf_tpus_decode_path_model_matches_jax():
    jd, jv, td = _decode_path_pair()
    x = (np.random.default_rng(37).normal(size=(16, D)) * 2 + 1).astype(np.float32)
    elbo_j, grads_j, state_j = jax_train_step(jd, jv, x)
    elbo_t = port_train_elbo(td, x)
    assert np.isfinite(elbo_t).all()
    assert rel_err(elbo_t, elbo_j) <= ELBO_TOL
    assert_grads(td, grads_j)
    assert_state(td, state_j)
    # The decode read the forward's statistics with their graph.
    bn = next(m for m in td.modules() if isinstance(m, BatchNormBijection))
    assert all(s.grad_fn is not None for s in bn.live_stats)
    assert_program_matches_jvp(td, x)


# ------------------------------------------------------- the schema's flat chain

BATCH = 32
FLAT_CASES = {
    # id: (config overrides)
    "snapshot": {},
    "snapshot-ignore": {"ignore_batch_effects": True},
    "running-affine": {"batch_norm_use_running_averages": True, "batch_norm_momentum": 0.1,
                       "batch_norm_apply_affine": True},
    "running-affine-ignore": {"batch_norm_use_running_averages": True, "batch_norm_momentum": 0.1,
                              "batch_norm_apply_affine": True, "ignore_batch_effects": True},
}


def _flat_schema(**overrides):
    schema = get_schema(small_config(batch_norm=True, num_density_layers=2, **overrides))
    types = [layer["type"] for layer in schema]
    assert types.count("batch-norm") >= 2 and "non-square-head" in types
    return schema


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_chain_matches_jax(case):
    overrides = FLAT_CASES[case]
    schema = _flat_schema(**overrides)
    snapshot = schema[0]["type"] == "passthrough-before-eval"
    assert snapshot == (case.startswith("snapshot"))
    jd, jv, td = build_pair(schema, seed=3)
    x = (1.0 + 1.5 * np.random.default_rng(4).normal(size=(BATCH, 11))).astype(np.float32)
    elbo_j, grads_j, state_j = jax_train_step(jd, jv, x)
    elbo_t = port_train_elbo(td, x)
    assert rel_err(elbo_t, elbo_j) <= ELBO_TOL
    assert_grads(td, grads_j)
    assert_state(td, state_j)
    detach = overrides.get("ignore_batch_effects", False)
    for bn in (m for m in td.modules() if isinstance(m, BatchNormBijection)):
        assert all((s.grad_fn is None) == detach for s in bn.live_stats)
    assert_program_matches_jvp(td, x)


def test_snapshot_refresh_and_evaluation_match_jax():
    """Under the passthrough wrapper: the refresh over the stored rows runs
    the non-square head's training elbo (its decode too) and snapshots the
    statistics; an evaluation elbo then reads them. Both against the JAX
    wrapper's ``refresh_state`` and evaluation elbo."""
    jd, jv, td = build_pair(_flat_schema(), seed=5)
    assert isinstance(td, PassthroughBeforeEvalDensity)
    rows = (0.5 + 1.5 * np.random.default_rng(6).normal(size=(200, 11))).astype(np.float32)
    variables = jd.attach_data({"params": jv["params"], "state": dict(jv["state"])}, jnp.asarray(rows))
    state_j = jax.jit(lambda v: jd.refresh_state(v))(variables)
    td.attach_data(t(rows))
    td.refresh_state()
    assert_state(td, state_j)
    x = (np.random.default_rng(7).normal(size=(BATCH, 11))).astype(np.float32)
    info_j, _ = jax.jit(lambda v, xx: jd.elbo(v, xx, train=False))(
        {"params": jv["params"], "state": state_j}, jnp.asarray(x))
    with torch.no_grad():
        elbo_t = td.elbo(t(x))["elbo"]
    assert rel_err(elbo_t.numpy(), info_j["elbo"]) <= ELBO_TOL
