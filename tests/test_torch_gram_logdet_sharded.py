"""Kernel 4, ``fused_gram_logdet_sharded`` (``cmf_tpu_torch/ops/gram_logdet.py``,
from ``cmf_tpu/ops/pallas/gram_logdet.py:212-268``), and the non-square
head under a column partition, on the CPU: one group of gloo ranks
(``tests/_torch_mesh_worker.py``) runs a (2 data × 2 model) mesh at world 4,
then a (1 × 2) mesh at world 2, while this process runs cmf_tpu's sharded
wrapper in interpret mode on the conftest's 8-device CPU mesh and the
unpartitioned port.

Tolerances: kernel 4 against the unsharded plain version and cmf_tpu at
``tests/test_ops.py:261-310``'s, rtol/atol 1e-4 on the Gram and the
log-det and 1e-3 on the gradient; the partitioned head against the
unpartitioned one, 1e-6 relative on the loss and 1e-5 of the model's
largest gradient on the gradients (the same arithmetic, summed in another
order).
"""

import numpy as np
import pytest
import torch

from cmf_tpu_torch.models import get_density
from cmf_tpu_torch.ops.gram_logdet import fused_gram_logdet, fused_gram_logdet_sharded_available
from cmf_tpu_torch.parallel import ColumnSpec, Mesh

from _torch_mesh_worker import build, group_results, make_trainer, once_per_session, start_group, step_result
from _torch_parity import small_config, small_schema

D_LATENT, BATCH, D_AMBIENT = 6, 24, 11
GROUP_TIMEOUT = 180.0


def _kernel_loss(gram, logdet):
    return logdet.sum() + gram.abs().sum()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return once_per_session(tmp_path_factory, "torch_gram_logdet_sharded", _make_setup)


def _make_setup(tmp):
    """The inputs, the group (started first) and, while its ranks run, the
    unpartitioned step of the head."""
    cols = np.random.default_rng(0).normal(size=(D_LATENT, BATCH, D_AMBIENT)).astype(np.float32)
    head_cfg = small_config(latent_dimension=4)
    td = get_density(small_schema(latent_dimension=4), x_shape=(11,), device="cpu",
                     generator=torch.Generator().manual_seed(2))
    head = {"schema": small_schema(latent_dimension=4), "x_shape": (11,),
            "state": {k: v.numpy().copy() for k, v in td.state_dict().items()}}
    payload = {
        "cols": cols,
        "head": head,
        "head_config": head_cfg,
        "head_x": np.random.default_rng(1).normal(size=(8, 11)).astype(np.float32),
    }
    group = start_group(4, "sharded_cases", payload, tmp, GROUP_TIMEOUT)
    try:
        head_single = step_result(make_trainer(build(head), head_cfg), payload["head_x"])
        results, error = group_results(group)
    finally:
        group.close()
    return {"payload": payload, "head_single": head_single, "results": results, "group_error": error}


def _results(setup):
    if setup["group_error"] is not None:
        raise RuntimeError(setup["group_error"])
    return setup["results"]


def _assembled(results, key):
    """The four ranks' kernel-4 outputs put back in their global places."""
    gram = np.zeros((BATCH, D_LATENT, D_LATENT), np.float32)
    logdet = np.zeros((BATCH,), np.float32)
    grad = np.zeros((D_LATENT, BATCH, D_AMBIENT), np.float32)
    for r in results.values():
        k = r[key]
        (r0, r1), (c0, c1) = k["rows"], k["columns"]
        gram[r0:r1], logdet[r0:r1] = k["gram"], k["logdet"]
        grad[c0:c1, r0:r1] = k["grad"]
    return gram, logdet, grad


def test_kernel4_matches_the_unsharded_plain_version(setup):
    """Kernel 4 on a (2 × 2) mesh: every model rank of a row holds the same
    Gram and log-det, and the reduce-scatter returns each column its
    gradient of Σ logdet + Σ|G|."""
    results = _results(setup)
    for i in range(2):  # the two model ranks of each data row agree exactly
        a, b = results[2 * i]["kernel4"], results[2 * i + 1]["kernel4"]
        np.testing.assert_array_equal(a["gram"], b["gram"])
        np.testing.assert_array_equal(a["logdet"], b["logdet"])
    gram, logdet, grad = _assembled(results, "kernel4")
    cols = torch.tensor(setup["payload"]["cols"], requires_grad=True)
    gram_u, logdet_u = fused_gram_logdet(cols)
    _kernel_loss(gram_u, logdet_u).backward()
    np.testing.assert_allclose(gram, gram_u.detach().numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logdet, logdet_u.detach().numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(grad, cols.grad.numpy(), rtol=1e-3, atol=1e-3)


def test_kernel4_matches_cmf_tpu(setup, monkeypatch):
    """Against cmf_tpu's ``fused_gram_logdet_sharded`` in interpret mode on a
    (2 × 2) mesh of the CPU devices, P("model", "data", None)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

    monkeypatch.setenv("CMF_TPU_PALLAS_INTERPRET", "1")
    from cmf_tpu.ops.pallas.gram_logdet import fused_gram_logdet_sharded as jax_sharded

    mesh = JaxMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    sharding = NamedSharding(mesh, P("model", "data", None))
    cols = jax.device_put(jnp.asarray(setup["payload"]["cols"]), sharding)

    def loss(c):
        g, ld = jax_sharded(c, sharding, interpret=True)
        return jnp.sum(ld) + jnp.sum(jnp.abs(g)), (g, ld)

    (_, (gram_j, logdet_j)), grad_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(cols)
    gram, logdet, grad = _assembled(_results(setup), "kernel4")
    np.testing.assert_allclose(gram, np.asarray(gram_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logdet, np.asarray(logdet_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(grad, np.asarray(grad_j), rtol=1e-3, atol=1e-3)


def test_kernel4_gate():
    """gram_logdet.py:259-268: the columns and the global batch divide over
    their axes, D unsharded, inside kernels 1-2's gate."""
    spec = ColumnSpec(Mesh(2, 2, torch.device("cpu")))
    assert fused_gram_logdet_sharded_available(D_LATENT, BATCH, D_AMBIENT, spec)
    assert not fused_gram_logdet_sharded_available(5, BATCH, D_AMBIENT, spec)  # d % 2
    assert not fused_gram_logdet_sharded_available(D_LATENT, 25, D_AMBIENT, spec)  # B % 2
    assert not fused_gram_logdet_sharded_available(34, BATCH, D_AMBIENT, spec)  # d > 32
    assert not fused_gram_logdet_sharded_available(D_LATENT, BATCH, 129, spec)  # D > 128
    assert fused_gram_logdet_sharded_available(5, 25, D_AMBIENT, ColumnSpec(spec.mesh, None, None))
    assert spec.columns(D_LATENT) == (0, 3)


@pytest.mark.parametrize("case, n_model, rows", [("head22", 2, 4), ("head12", 2, 8), ("head12_vmap", 2, 8)])
def test_partitioned_head_matches_the_unpartitioned_head(setup, case, n_model, rows):
    """A trainer step of a small non-square model (d = 4, the exact log-det)
    with the Jacobian columns over the model axis: each rank pushes only
    its d/n_model basis tangents (the dense program's, and with the program
    off the vmap of JVPs), and its loss and parameter gradients (the mean
    over the whole world) equal the unpartitioned step's."""
    single = setup["head_single"]
    top = max(np.abs(g).max() for g in single["grads"].values())
    results = _results(setup)
    for rank in range(4 if case == "head22" else 2):
        got = results[rank][case]
        assert got["column_shapes"] == [(4 // n_model, rows, 11)]
        assert abs(got["loss"] - single["loss"]) <= 1e-6 * abs(single["loss"])
        assert set(got["grads"]) == set(single["grads"])
        for k, w in single["grads"].items():
            assert np.abs(got["grads"][k] - w).max() <= 1e-5 * top, k
