"""The port's data parallelism (``cmf_tpu_torch/parallel/mesh.py``, the
trainer's step and evaluation under a mesh, the CLI's ``--mesh``) on the
CPU: one group of gloo ranks (``tests/_torch_mesh_worker.py``) runs every
case at world 4, then at world 2, while this process runs the JAX side on
the conftest's 8-device CPU mesh and the single-process port.

The invariant, after ``tests/test_distributed.py``: a step of N data ranks
computes what one rank computes, up to the order of the all-reduce's sums.
Tolerances: the port at world N against world 1, 1e-6 relative on losses
and evaluation means, 1e-5 of the model's largest gradient on gradients;
against cmf_tpu, ``tests/test_distributed.py``'s (rtol 1e-4, atol 1e-5 on
gradients; 1e-5 and 1e-6 on evaluation means), and for the batch-norm
model ``tests/_torch_nonsquare_bn.py``'s (1e-5 on the loss and the
statistics, 1e-4 on gradients).

cmf_tpu's CG count is not observable (a ``lax.while_loop``), and its
gradient of a forced fallback is NaN where the port's is finite (ROADMAP,
"Deliberate differences"): there the port's ranks are held to one rank of
the port, which ``tests/test_torch_nonsquare_batchnorm_image.py`` and
``tests/test_torch_nonsquare.py`` tie to cmf_tpu.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.config import expand_grid, get_config, get_schema
from cmf_tpu.models import get_density as jax_get_density
from cmf_tpu_torch.interop import flatten_tree, jax_path, variables_from_jax
from cmf_tpu_torch.main import make_mesh, parse_mesh
from cmf_tpu_torch.models import get_density as torch_get_density
from cmf_tpu_torch.training import setup_experiment

from _torch_mesh_worker import (
    _run_cli,
    build,
    cli_argv,
    eval_means,
    fallback_step,
    group_results,
    hutchinson_bn_step,
    make_trainer,
    once_per_session,
    start_group,
    step_result,
)
from _torch_nonsquare_bn import GRAD_TOL as BN_GRAD_TOL
from _torch_nonsquare_bn import STATE_TOL, rel_err
from _torch_parity import small_config, to_numpy

LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
GROUP_TIMEOUT = 240.0


def _state(td):
    return {k: v.detach().numpy().copy() for k, v in td.state_dict().items()}


def _sphere_config():
    cfg = expand_grid(get_config("sphere", "non-square", use_baseline=False))[0]
    cfg.update({"seed": 0, "num_density_layers": 2, "coupler_hidden_channels": [8, 8]})
    return cfg


def _image_bn_config():
    cfg = expand_grid(get_config("mnist", "non-square", use_baseline=False))[0]
    cfg.update(g_hidden_channels=[8], prior_hidden_channels=[8], resnet_batchnorm=True, smaller_realnvp=True,
               prior_num_density_layers=2, hutchinson_solver="cg", cg_tolerance=0.01)
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return once_per_session(tmp_path_factory, "torch_mesh", _make_setup)


def _make_setup(tmp):
    """The models and inputs; the group, started first; then, while its
    ranks run, the references: the single-process port, cmf_tpu, and a
    world-1 CLI run of one epoch, resumed for a second. The batch-norm
    model's weights are cmf_tpu's, carried by interop."""
    sphere_cfg = _sphere_config()
    schema = get_schema(sphere_cfg)
    jd = jax_get_density(schema, x_shape=(3,))
    jv = jd.init(jax.random.PRNGKey(0))
    td = torch_get_density(schema, x_shape=(3,), device="cpu")
    variables_from_jax(td, to_numpy(jv))
    rng = np.random.default_rng(0)
    bn_cfg = small_config(batch_norm=True)
    bn_image_cfg = _image_bn_config()
    gen = torch.Generator().manual_seed(1)
    bn_flat = torch_get_density(get_schema(bn_cfg), x_shape=(11,), device="cpu", generator=gen)
    bn_jd = jax_get_density(get_schema(bn_cfg), x_shape=(11,))
    bn_jv = bn_jd.init(jax.random.PRNGKey(1))
    variables_from_jax(bn_flat, to_numpy(bn_jv))
    bn_image = torch_get_density(get_schema(bn_image_cfg), x_shape=(1, 8, 8), device="cpu", generator=gen)
    sphere = {"schema": schema, "x_shape": (3,), "state": _state(td), "config": sphere_cfg}
    payload = {
        "sphere": sphere,
        "sphere_x": rng.normal(size=(64, 3)).astype(np.float32),
        # Three batches each rank splits, one (9 rows) computed whole.
        "eval_batches": [rng.normal(size=(n, 3)).astype(np.float32) for n in (16, 16, 16, 9)],
        "bn_flat": {"schema": get_schema(bn_cfg), "x_shape": (11,), "state": _state(bn_flat)},
        "bn_flat_config": bn_cfg,
        "bn_flat_x": rng.normal(size=(8, 11)).astype(np.float32),
        "poison_row": 5,
        "bn_image": {"schema": get_schema(bn_image_cfg), "x_shape": (1, 8, 8), "state": _state(bn_image)},
        "bn_image_config": bn_image_cfg,
        "bn_image_x": rng.integers(0, 256, size=(8, 1, 8, 8)).astype(np.float32),
        "runs_dir": str(tmp / "runs"),
    }
    group = start_group(4, "mesh_cases", payload, tmp, GROUP_TIMEOUT)
    try:
        (one,) = _run_cli(cli_argv(str(tmp / "world1"), ["--config", "max_epochs=1"]))
        refs = {
            "sphere": step_result(make_trainer(build(sphere), sphere_cfg), payload["sphere_x"]),
            "jax_sphere": {n: _jax_sharded_step(jd, jv, payload["sphere_x"], n)[:2] for n in (2, 4)},
            "eval": eval_means(build(sphere), sphere_cfg, payload["eval_batches"]),
            "jax_eval": _jax_run_eval(jd, jv, payload["eval_batches"]),
            "bn_flat": step_result(make_trainer(build(payload["bn_flat"]), bn_cfg), payload["bn_flat_x"]),
            "jax_bn_flat": _jax_sharded_step(bn_jd, bn_jv, payload["bn_flat_x"], 2),
            "fallback": fallback_step(payload),
            "jax_fallback": _jax_sharded_step(bn_jd, bn_jv, payload["bn_flat_x"], 2, payload["poison_row"]),
            "hutch_bn": hutchinson_bn_step(payload),
            "world1_history": one["trainer"].history,
            "world1_resumed": _resume_to_epoch_two(one["writer"].logdir),
        }
        results, error = group_results(group)
    finally:
        group.close()
    return {"payload": payload, "refs": refs, "results": results, "group_error": error}


def _rank(setup, rank=0):
    if setup["group_error"] is not None:
        raise RuntimeError(setup["group_error"])
    return setup["results"][rank]


def _close(got, want, rtol=LOSS_RTOL):
    return abs(got - want) <= rtol * abs(want)


def _assert_grads(got, want):
    """Each of ``got``'s gradients within GRAD_TOL of the largest of ``want``."""
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= GRAD_TOL * top, k


def _jax_sharded_step(jd, jv, x, n, poison_row=None):
    """cmf_tpu's loss, gradients and the state its forward leaves, with the
    batch over ``get_mesh(data=n)``. With ``poison_row``, its head takes
    the fused route with a NaN log-det at that global row, a forced
    fallback, and only the loss is taken (its gradient is NaN there)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cmf_tpu.densities import nonsquare as jax_nonsquare
    from cmf_tpu.ops import cholesky_logdet, gram_from_columns
    from cmf_tpu.parallel import get_mesh

    def loss(params, x):
        info, state = jd.elbo({"params": params, "state": jv["state"]}, x, train=True)
        return -jnp.mean(info["elbo"]), state

    def poisoned(jac_cols):
        gram = gram_from_columns(jac_cols)
        return gram, cholesky_logdet(gram)[0].at[poison_row].set(jnp.nan)

    mesh = get_mesh(data=n, devices=jax.devices()[:n])
    x = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
    params = jax.device_put(jv["params"], NamedSharding(mesh, P()))
    if poison_row is not None:
        real = jax_nonsquare.fused_gram_logdet_available, jax_nonsquare.fused_gram_logdet
        jax_nonsquare.fused_gram_logdet_available, jax_nonsquare.fused_gram_logdet = lambda d, D: True, poisoned
        try:
            with mesh:
                value, _ = jax.jit(loss)(params, x)
        finally:
            jax_nonsquare.fused_gram_logdet_available, jax_nonsquare.fused_gram_logdet = real
        return float(value)
    with mesh:
        (value, state), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, x)
    return float(value), flatten_tree(to_numpy(grads)), flatten_tree(to_numpy(state))


def _jax_run_eval(jd, jv, batches):
    """cmf_tpu's single-device ``Trainer._run_eval`` of the metrics."""
    import optax

    from cmf_tpu.eval import metrics as jax_metrics
    from cmf_tpu.training.objectives import SquareObjective
    from cmf_tpu.training.trainer import Trainer as JaxTrainer
    from cmf_tpu.training.writer import DummyWriter

    trainer = JaxTrainer(
        density=jd, variables=jv, objective=SquareObjective(), optimizers=[optax.adam(1e-3)],
        lr_schedules=[lambda s: 1e-3], train_loader=None, valid_loader=None, test_loader=None,
        writer=DummyWriter(), visualizer=None, max_epochs=1, early_stopping=False, max_bad_valid_epochs=1,
        valid_frequency=1, epochs_per_test=1, rng=jax.random.PRNGKey(7), batch_sharding=None,
    )
    return trainer._run_eval(lambda d, v, x, r: jax_metrics(d, v, x, num_elbo_samples=1, rng=None), "m",
                             [jnp.asarray(b) for b in batches])


def _resume_to_epoch_two(run_dir):
    """``--resume`` of ``run_dir`` at world 1 with ``max_epochs`` 2: the
    parameters it ends with."""
    with open(os.path.join(run_dir, "config.json")) as f:
        config = json.load(f)
    config["max_epochs"] = 2
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(config, f)
    (resumed,) = _run_cli(["--resume", run_dir, "--device", "cpu"])
    assert resumed["trainer"].restored_from == "latest" and resumed["trainer"].epoch == 2
    return {n: p.detach() for n, p in resumed["density"].named_parameters()}


@pytest.mark.parametrize("n", [2, 4])
def test_sphere_step_matches_one_rank_and_cmf_tpu(setup, n):
    """The sphere non-square step at n data ranks: its loss and gradients
    against the single-process port and cmf_tpu's under get_mesh(data=n)
    (tests/test_distributed.py:22-60)."""
    single = setup["refs"]["sphere"]
    jax_loss, jax_grads = setup["refs"]["jax_sphere"][n]
    for rank in range(n):
        got = _rank(setup, rank)[f"sphere{n}"]
        assert _close(got["loss"], single["loss"])
        _assert_grads(got["grads"], single["grads"])
        # Every rank holds the same updated parameters.
        for k, v in got["params"].items():
            np.testing.assert_array_equal(v, _rank(setup, 0)[f"sphere{n}"]["params"][k])
    got = _rank(setup)[f"sphere{n}"]
    np.testing.assert_allclose(got["loss"], jax_loss, rtol=1e-5)
    mapped = {jax_path(k): v for k, v in got["grads"].items()}
    assert set(mapped) == set(jax_grads)
    for k, v in jax_grads.items():
        np.testing.assert_allclose(mapped[k], v, rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_run_eval_sharded_matches_single(setup, n):
    """``Trainer._run_eval`` at n data ranks against one rank and against
    cmf_tpu's single-device ``_run_eval`` (tests/test_distributed.py:62-110);
    the 9-row batch is computed whole on every rank and counted once."""
    single, want = setup["refs"]["eval"], setup["refs"]["jax_eval"]
    for rank in range(n):
        got = _rank(setup, rank)[f"eval{n}"]
        assert set(got) == set(single) == set(want) and len(got) >= 3
        for k in single:
            assert _close(got[k], single[k]), k
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_helpers(setup, n):
    """The mesh's layout, ``shard_batch``, ``replicate``, ``psum_stats``, the
    draws and the batch statistics under backward, jvp and vmap
    (tests/test_distributed.py:144-153)."""
    for rank in range(n):
        h = _rank(setup, rank)[f"helpers{n}"]
        assert h["shape"] == {"data": n, "model": 1}
        assert (h["data_index"], h["model_index"]) == (rank, 0)
        x = np.arange(8 * n, dtype=np.float32).reshape(4 * n, 2)
        np.testing.assert_array_equal(h["shard"], x[4 * rank : 4 * rank + 4])
        assert h["indivisible_rows"] is None
        np.testing.assert_array_equal(h["replicated"], np.zeros(3))
        sums, counts = h["psum"]
        np.testing.assert_array_equal(sums, [n * (n + 1) / 2, 2.0 * n])
        np.testing.assert_array_equal(counts, [n, n * (n - 1) // 2])
        assert "ranks" in h["bad_mesh"]
        assert h["draw_ok"]
        assert h["jvp_err"] <= 1e-6 and h["grad_err"] <= 1e-5


def test_batch_norm_model_two_ranks_match_one(setup):
    """A ``batch_norm=True`` non-square model (the exact log-det) at 2 data
    ranks against 1: the loss, the gradients through the global batch
    statistics, and the statistics the step leaves in the buffers."""
    single = setup["refs"]["bn_flat"]
    stats = [k for k in single["buffers"] if k.endswith(("running_mean", "running_var", "batch_mean", "batch_var"))]
    assert stats
    for rank in range(2):
        got = _rank(setup, rank)["bn_flat"]
        assert _close(got["loss"], single["loss"])
        _assert_grads(got["grads"], single["grads"])
        for k in stats:
            np.testing.assert_allclose(got["buffers"][k], single["buffers"][k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_batch_norm_model_matches_cmf_tpu(setup):
    """The same ``batch_norm=True`` model at 2 data ranks against cmf_tpu
    under ``get_mesh(data=2)`` on the same weights: the loss, the gradients
    through the global batch statistics, and the statistics the forward
    leaves in the state."""
    jax_loss, jax_grads, jax_state = setup["refs"]["jax_bn_flat"]
    top = max(np.abs(w).max() for w in jax_grads.values())
    for rank in range(2):
        got = _rank(setup, rank)["bn_flat"]
        assert abs(got["loss"] - jax_loss) <= 1e-5 * abs(jax_loss)
        grads = {jax_path(k): v for k, v in got["grads"].items()}
        assert set(grads) == set(jax_grads)
        for k, w in jax_grads.items():
            # _torch_nonsquare_bn.assert_grads's rule for a vanishing gradient.
            scale = np.abs(w).max()
            if scale < BN_GRAD_TOL * top:
                scale = top
            assert np.abs(grads[k] - w).max() <= BN_GRAD_TOL * scale, k
        buffers = {jax_path(k): v for k, v in got["buffers"].items()}
        common = set(buffers) & set(jax_state)
        assert any(k.endswith(("batch_mean", ".mean")) for k in common)
        for k in common:
            assert rel_err(buffers[k], jax_state[k]) <= STATE_TOL, k


def test_forced_fallback_is_taken_on_every_rank(setup):
    """A NaN kernel log-det on one row of rank 1 only: the all-reduced
    predicate sends both ranks down the jitter fallback, once each, as one
    rank with the same row does, and the loss is cmf_tpu's under
    ``get_mesh(data=2)`` with the same row poisoned (finite only where its
    ``lax.cond`` took the fallback)."""
    single = setup["refs"]["fallback"]
    jax_loss = setup["refs"]["jax_fallback"]
    assert single["fallbacks"] == 1 and np.isfinite(jax_loss)
    for rank in range(2):
        got = _rank(setup, rank)["fallback"]
        assert got["fallbacks"] == 1
        assert _close(got["loss"], single["loss"])
        _assert_grads(got["grads"], single["grads"])
        assert abs(got["loss"] - jax_loss) <= 1e-5 * abs(jax_loss)


def test_hutchinson_cg_with_batch_norm_couplers_runs_the_same_iterations(setup):
    """The Hutchinson + CG step of an 8×8 image model with batch-norm ResNet
    couplers, whose matvecs take global batch statistics: both ranks run
    the same number of CG matvecs (as one rank does), so none waits in a
    collective, and the step matches one rank's."""
    single = setup["refs"]["hutch_bn"]
    assert single["num_bn"] > 0 and single["matvecs"] > 1
    got = [_rank(setup, rank)["hutch_bn"] for rank in range(2)]
    assert got[0]["matvecs"] == got[1]["matvecs"] == single["matvecs"]
    for g in got:
        assert _close(g["loss"], single["loss"])
        _assert_grads(g["grads"], single["grads"])


def test_cli_at_world_two_then_resume_at_world_one(setup):
    """``--mesh data=2`` for one epoch of sphere: only rank 0 writes a run
    dir, and its epoch's losses are one rank's; ``--resume`` from it at
    world 1 restores its checkpoint bit-equal and trains the next epoch as
    the resume of a world-1 run dir does (tests/test_multihost.py:167). A
    resume, in both packages, restarts the loader's shuffle count, so the
    world-1 run it is held to is one resumed at the same epoch."""
    r0, r1 = _rank(setup, 0), _rank(setup, 1)
    for r in (r0, r1):
        assert "launcher started 2" in r["cli_bad_world"]
    assert r0["cli"]["writer"] == "Writer" and r1["cli"]["writer"] == "DummyWriter"
    run_dir = r0["cli"]["logdir"]
    sphere_runs = os.path.join(setup["payload"]["runs_dir"], "sphere")
    assert [os.path.join(sphere_runs, r) for r in os.listdir(sphere_runs)] == [run_dir]
    assert r0["cli"]["history"] == r1["cli"]["history"]

    with open(os.path.join(run_dir, "config.json")) as f:
        config = json.load(f)
    saved = torch.load(os.path.join(run_dir, "checkpoints", "latest.pt"), weights_only=True)
    restored = setup_experiment(config, resume_dir=run_dir, testing=True, write_to_disk=False, device="cpu")
    for n, p in restored["density"].named_parameters():
        assert torch.equal(p.detach(), saved["params"][n]), n
        np.testing.assert_array_equal(p.detach().numpy(), r0["cli"]["params"][n])

    history = setup["refs"]["world1_history"]
    assert len(history) == len(r0["cli"]["history"])
    for (_, l2, _, _), (_, l1, _, _) in zip(r0["cli"]["history"], history):
        assert _close(l2, l1)
    got = _resume_to_epoch_two(run_dir)
    want = setup["refs"]["world1_resumed"]
    top = max(v.abs().max().item() for v in want.values())
    for n, v in want.items():
        assert (got[n] - v).abs().max().item() <= 1e-5 * top, n


def test_cli_mesh_without_a_launcher():
    """``--mesh data=N`` with N > 1 and no launcher raises naming torchrun;
    ``data=1`` and no ``--mesh`` run alone; only a data axis parses."""
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        make_mesh("data=2", device="cpu")
    assert make_mesh("data=1", device="cpu") is None
    assert make_mesh(None, device="cpu") is None
    assert parse_mesh("data=8") == 8
    for bad in ("model=2", "data=0", "data", "data=x"):
        with pytest.raises(ValueError, match="only a data axis"):
            parse_mesh(bad)
