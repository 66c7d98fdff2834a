"""The rank processes of ``tests/test_torch_mesh.py`` and
``tests/test_torch_gram_logdet_sharded.py``: the port's mesh over gloo on
the CPU, with no JAX (the test process holds the JAX side and the
single-process port runs).

``start_group`` spawns one group of ranks (``torch.multiprocessing``, spawn
context, ``init_method="file://..."``: no port is bound) that runs one of
the case functions below and sends each rank's results back as numpy;
``Group.results`` waits for them with a timeout and kills every rank on
expiry, so a hung collective fails its tests and not the suite. Each case
function runs its cases at world 4, then, where it has some, at world 2 on
ranks 0 and 1 over a new process group. ``once_per_session`` makes a test
file's group and references once per test session, however pytest-xdist
spreads the file's tests over its workers.
"""

import fcntl
import os
import pickle
import queue
import sys
import time
import traceback

import torch
import torch.distributed as dist

from cmf_tpu_torch.densities import nonsquare
from cmf_tpu_torch.models import get_density
from cmf_tpu_torch.nets import BatchNorm2d
from cmf_tpu_torch.ops import gram_logdet
from cmf_tpu_torch.parallel import mesh as pmesh
from cmf_tpu_torch.training.objectives import get_objective
from cmf_tpu_torch.training.optim import make_optimizer
from cmf_tpu_torch.training.trainer import Trainer

# The flags of a likelihood step of a non-square model.
LIKELIHOOD_FLAGS = {
    "optimizer_index": 0,
    "likelihood_wt": 1.0,
    "metric_wt": 1.0,
    "skip_likelihood": False,
    "add_reconstruction": True,
    "add_diagonal_metric_reg": False,
    "add_offdiagonal_metric_reg": False,
}


# ------------------------------------------------------------ the group
class Group:
    def __init__(self, procs, results_queue, timeout):
        self._procs, self._queue = procs, results_queue
        self._deadline = time.monotonic() + timeout
        self._results = None

    def results(self):
        """{rank: the case function's dict}; raises where a rank failed or
        the group outlived its timeout (every rank is then killed)."""
        if self._results is not None:
            return self._results
        results, failures = {}, []
        try:
            while len(results) + len(failures) < len(self._procs):
                remaining = self._deadline - time.monotonic()
                try:
                    rank, ok, value = self._queue.get(timeout=max(remaining, 0.1))
                except queue.Empty:
                    raise TimeoutError(f"ranks {sorted(set(range(len(self._procs))) - set(results))} "
                                       "did not finish in time") from None
                if ok:
                    results[rank] = value
                else:
                    failures.append(f"rank {rank}:\n{value}")
                    break
            for p in self._procs:
                p.join(timeout=max(self._deadline - time.monotonic(), 1.0))
        finally:
            self.close()
        if failures:
            raise RuntimeError("\n".join(failures))
        self._results = results
        return results

    def close(self):
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(5)


def start_group(world, case_fn, payload, tmp_dir, timeout):
    """Spawn ``world`` gloo ranks running ``case_fn`` (a name in this module)
    on ``payload``."""
    ctx = torch.multiprocessing.get_context("spawn")
    results_queue = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, args=(rank, world, case_fn, payload, str(tmp_dir), results_queue),
                    daemon=True)
        for rank in range(world)
    ]
    for p in procs:
        p.start()
    return Group(procs, results_queue, timeout)


def _init(rank, world, tmp_dir):
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp_dir, f'init_world{world}')}", rank=rank, world_size=world
    )


def _rank_main(rank, world, case_fn, payload, tmp_dir, results_queue):
    torch.set_num_threads(1)
    try:
        _init(rank, world, tmp_dir)
        value = globals()[case_fn](rank, payload, tmp_dir)
        results_queue.put((rank, True, value))
    except BaseException:
        results_queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _to_world_two(rank, tmp_dir):
    """Leave the world-4 group; ranks 0 and 1 join a world-2 one. Returns
    whether this rank goes on."""
    dist.destroy_process_group()
    if rank >= 2:
        return False
    _init(rank, 2, tmp_dir)
    return True


def once_per_session(tmp_path_factory, name, produce):
    """``produce(work_dir)``'s value, made once per test session: the first
    process to ask makes it under a file lock in the session's temporary
    directory (the one every xdist worker shares) and pickles it; the
    others wait on the lock and read it. Where ``produce`` raised, every
    process raises with its traceback."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / f"{name}.pkl"
    with open(base / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            work_dir = base / name
            work_dir.mkdir()
            try:
                made = (True, produce(work_dir))
            except Exception:
                made = (False, traceback.format_exc())
            with open(f"{path}.part", "wb") as f:
                pickle.dump(made, f)
            os.replace(f"{path}.part", path)
        with open(path, "rb") as f:
            ok, value = pickle.load(f)
    if not ok:
        raise RuntimeError(f"{name} failed where it was made:\n{value}")
    return value


def group_results(group):
    """``group.results()``, or the error it raised as a string (kept so
    that each test that reads the group fails, and the others pass)."""
    try:
        return group.results(), None
    except Exception:
        return None, traceback.format_exc()


# ------------------------------------------------------------- helpers
def build(model):
    """The port's density of ``model`` = {"schema", "x_shape", "state"}."""
    td = get_density(model["schema"], x_shape=model["x_shape"], device="cpu")
    td.load_state_dict({k: torch.as_tensor(v) for k, v in model["state"].items()})
    return td


def make_trainer(td, config, mesh=None, seed=3):
    """A trainer of ``td`` with no loaders, its generator seeded with
    ``seed``; under ``mesh`` its batch sharding."""
    params = [p for p in td.parameters() if p.requires_grad]
    return Trainer(
        density=td,
        objective=get_objective(config),
        optimizers=[make_optimizer(config, params, 1)],
        train_loader=None,
        max_epochs=1,
        generator=torch.Generator().manual_seed(seed),
        batch_sharding=None if mesh is None else pmesh.data_sharding(mesh),
    )


def step_result(trainer, x, flags=LIKELIHOOD_FLAGS):
    """One eager step: its loss and grad norm, every parameter's gradient
    (before the update) by name, the parameters and buffers after it."""
    loss, norm = trainer.eager_step(torch.as_tensor(x), flags)
    names = [n for n, p in trainer.density.named_parameters() if p.requires_grad]
    return {
        "loss": float(loss),
        "grad_norm": float(norm),
        "grads": {n: g.detach().numpy().copy() for n, g in zip(names, trainer._grads)},
        "params": {n: p.detach().numpy().copy() for n, p in trainer.density.named_parameters()},
        "buffers": {n: b.detach().numpy().copy() for n, b in trainer.density.named_buffers()},
    }


def eval_means(td, config, batches, mesh=None):
    """``Trainer._run_eval`` of the importance-sampled metrics (one sample)
    over ``batches``."""
    from cmf_tpu_torch.eval.metrics import metrics

    trainer = make_trainer(td, config, mesh)
    return trainer._run_eval(lambda d, x, g: metrics(d, x, 1), [torch.as_tensor(b) for b in batches])


def poisoned_logdet(row):
    """``fused_gram_logdet`` with a NaN log-det at global batch row ``row``
    (on the rank that holds it): a forced fallback."""
    real = gram_logdet.fused_gram_logdet

    def fused(jac_cols):
        gram, ld = real(jac_cols)
        split = pmesh._SPLIT[0]
        start = 0 if split is None else split.start
        local = row - start
        if 0 <= local < ld.shape[0]:
            hit = torch.zeros_like(ld, dtype=torch.bool)
            hit[local] = True
            ld = torch.where(hit, torch.full_like(ld, float("nan")), ld)
        return gram, ld

    return fused


def counted_cg(counts):
    """``batched_cg`` whose matvecs append to ``counts``."""
    real = nonsquare.batched_cg

    def cg(matvec, rhs, *args, **kw):
        def counted(v):
            counts.append(1)
            return matvec(v)

        return real(counted, rhs, *args, **kw)

    return cg


def hutchinson_bn_step(payload, mesh=None):
    """The Hutchinson + CG step of the batch-norm-coupler image model, its
    CG matvecs counted."""
    td = build(payload["bn_image"])
    counts = []
    nonsquare.batched_cg, real = counted_cg(counts), nonsquare.batched_cg
    try:
        out = step_result(make_trainer(td, payload["bn_image_config"], mesh), payload["bn_image_x"])
    finally:
        nonsquare.batched_cg = real
    out["matvecs"] = len(counts)
    out["num_bn"] = sum(isinstance(m, BatchNorm2d) for m in td.modules())
    return out


def fallback_step(payload, mesh=None):
    td = build(payload["bn_flat"])
    nonsquare.reset_logdet_fallbacks()
    nonsquare.fused_gram_logdet, real = poisoned_logdet(payload["poison_row"]), nonsquare.fused_gram_logdet
    try:
        out = step_result(make_trainer(td, payload["bn_flat_config"], mesh), payload["bn_flat_x"])
    finally:
        nonsquare.fused_gram_logdet = real
    out["fallbacks"] = nonsquare.logdet_fallbacks()
    return out


def _run_cli(argv):
    """``python -m cmf_tpu_torch argv`` in this process, TensorBoard
    blocked, the streams put back after the writer's tee."""
    from cmf_tpu_torch.main import main

    sys.modules["torch.utils.tensorboard"] = None
    out, err = sys.stdout, sys.stderr
    try:
        return main(argv)
    finally:
        sys.stdout, sys.stderr = out, err


def cli_argv(runs_dir, extra=()):
    return ["--model", "non-square", "--dataset", "sphere", "--device", "cpu", "--logdir-root", runs_dir,
            "--config", "seed=0", *extra]


# --------------------------------------------------- the mesh test cases
def _helpers(rank, mesh):
    world = mesh.size
    out = {"shape": mesh.shape, "data_index": mesh.data_index, "model_index": mesh.model_index}
    x = torch.arange(8 * world, dtype=torch.float32).reshape(4 * world, 2)
    out["shard"] = pmesh.shard_batch(mesh, x).numpy()
    out["indivisible_rows"] = pmesh.data_sharding(mesh).rows(4 * world + 1)
    t = torch.full((3,), float(rank))
    pmesh.replicate(mesh, [t])
    out["replicated"] = t.numpy()
    sums, counts = pmesh.psum_stats(torch.tensor([rank + 1.0, 2.0]), torch.tensor([1, rank]), mesh)
    out["psum"] = (sums.numpy(), counts.numpy())
    try:
        pmesh.get_mesh(data=world + 1)
        out["bad_mesh"] = None
    except ValueError as e:
        out["bad_mesh"] = str(e)
    # A draw inside a split is the global draw's rows.
    g = torch.Generator().manual_seed(5)
    whole = torch.randn((4 * world, 3), generator=g)
    g.manual_seed(5)
    with pmesh.batch_split(pmesh.data_sharding(mesh), x) as rows:
        drawn = pmesh.draw_rows(lambda s: torch.randn(s, generator=g), (rows.shape[0], 3))
    out["draw_ok"] = bool(torch.equal(drawn, pmesh.shard_batch(mesh, whole)))

    # Batch-global statistics under backward, jvp and vmap: x minus its
    # batch mean over this rank's rows of the global batch equals the
    # rows of the same on the whole batch.
    def centred(v):
        return v - pmesh.batch_mean(v, (0,), keepdim=True)

    y = torch.randn((4 * world, 3), generator=torch.Generator().manual_seed(7))
    tangents = torch.randn((2, 4 * world, 3), generator=torch.Generator().manual_seed(8))

    def jvps(v, ts):
        return torch.func.vmap(lambda t: torch.func.jvp(centred, (v,), (t,))[1])(ts)

    def weighted_grad(v):
        v = v.clone().requires_grad_(True)
        (centred(v) ** 3).sum().backward()
        return v.grad

    lo, hi = pmesh.data_sharding(mesh).rows(4 * world)
    want_jvp = jvps(y, tangents)[:, lo:hi]
    want_grad = weighted_grad(y)[lo:hi]
    with pmesh.batch_split(pmesh.data_sharding(mesh), y) as rows:
        got_jvp = jvps(rows, tangents[:, lo:hi])
        got_grad = weighted_grad(rows)
    out["jvp_err"] = float((got_jvp - want_jvp).abs().max())
    out["grad_err"] = float((got_grad - want_grad).abs().max())
    return out


def mesh_cases(rank, payload, tmp_dir):
    """World 4 (data=4): the sphere step, the evaluation, the helpers. World
    2 (data=2): the sphere step, the evaluation, the batch-norm model, the
    forced fallback, the Hutchinson step with batch-norm couplers, the CLI."""
    out = {}
    mesh = pmesh.get_mesh(data=4)
    sphere = payload["sphere"]
    out["sphere4"] = step_result(make_trainer(build(sphere), sphere["config"], mesh), payload["sphere_x"])
    out["eval4"] = eval_means(build(sphere), sphere["config"], payload["eval_batches"], mesh)
    out["helpers4"] = _helpers(rank, mesh)
    if not _to_world_two(rank, tmp_dir):
        return out
    mesh = pmesh.get_mesh(data=2)
    out["sphere2"] = step_result(make_trainer(build(sphere), sphere["config"], mesh), payload["sphere_x"])
    out["eval2"] = eval_means(build(sphere), sphere["config"], payload["eval_batches"], mesh)
    out["helpers2"] = _helpers(rank, mesh)
    out["bn_flat"] = step_result(make_trainer(build(payload["bn_flat"]), payload["bn_flat_config"], mesh),
                                 payload["bn_flat_x"])
    out["fallback"] = fallback_step(payload, mesh)
    out["hutch_bn"] = hutchinson_bn_step(payload, mesh)
    try:
        _run_cli(cli_argv(payload["runs_dir"], ["--mesh", "data=3"]))
        out["cli_bad_world"] = None
    except ValueError as e:
        out["cli_bad_world"] = str(e)
    (setup,) = _run_cli(cli_argv(payload["runs_dir"], ["--mesh", "data=2", "--config", "max_epochs=1"]))
    out["cli"] = {
        "logdir": getattr(setup["writer"], "logdir", None),
        "writer": type(setup["writer"]).__name__,
        "history": setup["trainer"].history,
        "params": {n: p.detach().numpy().copy() for n, p in setup["density"].named_parameters()},
    }
    return out


# ------------------------------------------- the kernel 4 test cases
def _kernel4(payload, mesh):
    spec = pmesh.ColumnSpec(mesh)
    cols = torch.as_tensor(payload["cols"])
    d, b, _ = cols.shape
    c0, c1 = spec.columns(d)
    r0, r1 = pmesh.data_sharding(mesh).rows(b)
    local = cols[c0:c1, r0:r1].clone().requires_grad_(True)
    gram, ld = gram_logdet.fused_gram_logdet_sharded(local, spec)
    # Each model rank's share of Σ logdet + Σ|G| over its rows: the global
    # loss is the sum over the ranks, whose gradient each rank's columns get.
    ((ld.sum() + gram.abs().sum()) / mesh.shape["model"]).backward()
    return {"rows": (r0, r1), "columns": (c0, c1), "gram": gram.detach().numpy(), "logdet": ld.detach().numpy(),
            "grad": local.grad.numpy()}


def _partitioned_head_step(payload, mesh, generic=False):
    """A trainer step of the small flat model with the columns over the
    model axis; the shape of the columns each rank pushed."""
    td = build(payload["head"])
    if generic:
        head = next(m for m in td.modules() if isinstance(m, nonsquare.NonSquareHeadDensity))
        head._program, head._program_checked = None, True
    shapes = []
    real = nonsquare.fused_gram_logdet_sharded

    def recorded(jac_cols, spec):
        shapes.append(tuple(jac_cols.shape))
        return real(jac_cols, spec)

    nonsquare.fused_gram_logdet_sharded = recorded
    try:
        with pmesh.jacobian_column_partition(pmesh.ColumnSpec(mesh)):
            out = step_result(make_trainer(td, payload["head_config"], mesh), payload["head_x"])
    finally:
        nonsquare.fused_gram_logdet_sharded = real
    out["column_shapes"] = shapes
    return out


def sharded_cases(rank, payload, tmp_dir):
    """World 4, a (2 data × 2 model) mesh: kernel 4 and the partitioned
    head's step. World 2, a (1 × 2) mesh: the head's step by the dense
    program and by the vmap of JVPs."""
    out = {}
    mesh = pmesh.get_mesh(data=2, model=2)
    out["kernel4"] = _kernel4(payload, mesh)
    out["head22"] = _partitioned_head_step(payload, mesh)
    if not _to_world_two(rank, tmp_dir):
        return out
    mesh = pmesh.get_mesh(data=1, model=2)
    out["head12"] = _partitioned_head_step(payload, mesh)
    out["head12_vmap"] = _partitioned_head_step(payload, mesh, generic=True)
    return out
