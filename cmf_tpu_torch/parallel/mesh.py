"""Device mesh and collectives over ``torch.distributed``: the port's copy of
``cmf_tpu/parallel/mesh.py``.

``cmf_tpu`` places the batch with ``NamedSharding(P("data"))`` and lets GSPMD
insert every cross-device reduction inside its jitted step. The port has no
compiler to do that: each reduction that is global under GSPMD is an
explicit collective here, which every rank calls in the same order.

* The mesh (``get_mesh``): ranks laid out (data, model) row-major, as
  ``cmf_tpu`` reshapes its devices; one process group a data row (the model
  group: the ranks that hold the same batch rows) and one a model column
  (the data group: the ranks that hold different rows). The backend follows
  the device (``initialize_multihost``): NCCL on the card, gloo on the CPU.
* The batch: every rank walks the same seeded permutation and holds the
  global batch; ``batch_split(data_sharding(mesh), x)`` keeps this rank's
  contiguous rows (``shard_batch``) and, for the length of the block, makes
  the batch-global operations global over the data group: the draws take
  the global shape from the shared generator and keep this rank's rows
  (``draw_rows``: the dequantization noise, the Hutchinson probes, a CIF's
  u), the batch-norm statistics are sums over the data group
  (``batch_mean``, ``batch_var_mean``, differentiable), the all-finite
  predicates (the head's fallback, the jitter ladder's tries) are a MIN
  (``batch_all``) and CG's batch-mean residual is a sum and a count, so
  every rank takes the same branch and runs the same number of
  iterations. A batch whose size the data axis does not divide is computed
  whole on every rank, as ``cmf_tpu`` replicates it (trainer.py:225): no
  split and no collective inside the block.
* The gradients (``all_reduce_gradients``): one all-reduce over the world a
  dtype, a mean over data × model; every rank then holds the gradient of
  the global batch's mean loss. ``psum_stats`` sums an evaluation's sums
  and counts over the data group.
* The Jacobian columns: inside ``jacobian_column_partition(ColumnSpec(mesh))``
  the non-square head pushes only this rank's d/n_model basis tangents
  through its decode and kernel 4
  (``ops/gram_logdet.py::fused_gram_logdet_sharded``) all-gathers them over
  the model group. Every model rank then computes the same Gram, and the
  gradient mean over the world counts each replicated term once.

Outside a process group (one process, no launcher) a mesh has one rank and
every helper is the identity.
"""

import contextlib
import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device

# What ``torchrun`` sets for every rank it launches.
LAUNCHER_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def launched():
    """Whether this process was started by a launcher (``torchrun``)."""
    return all(k in os.environ for k in LAUNCHER_ENV)


def initialize_multihost(coordinator_address=None, num_processes=None, process_id=None, device=None):
    """Join the process group (``torch.distributed.init_process_group``).

    A no-op returning False when no coordinator is given and the
    launcher's environment is absent (mesh.py:48-62); True where a group
    exists already or was made here. ``coordinator_address`` is an
    ``init_method`` URL (``tcp://host:port``, ``file:///path``) or a bare
    ``host:port``. The backend follows ``device`` (``None`` for the card):
    NCCL for ``cuda``, where rank r takes ``cuda:{LOCAL_RANK}``, and gloo
    for ``cpu``."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and num_processes is None:
        if not launched():
            return False
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("initialize_multihost needs the coordinator, the process count and this process's id")
        init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world, rank=rank)
    return True


class Mesh:
    """Ranks on a (data, model) grid: rank = data_index · model + model_index.
    ``group(axis)`` is the process group along ``axis`` that holds this rank
    (None outside a process group); ``device`` is where its collectives'
    tensors live."""

    def __init__(self, data, model, device):
        self.shape = {"data": data, "model": model}
        self.size = data * model
        self.device = device
        self.distributed = dist.is_initialized()
        self.rank = dist.get_rank() if self.distributed else 0
        self.data_index, self.model_index = divmod(self.rank, model)
        self._groups = {"data": None, "model": None}
        if self.distributed:
            # Every rank makes every group, in the same order.
            for i in range(data):
                g = dist.new_group([i * model + j for j in range(model)])
                if i == self.data_index:
                    self._groups["model"] = g
            for j in range(model):
                g = dist.new_group([i * model + j for i in range(data)])
                if j == self.model_index:
                    self._groups["data"] = g

    def group(self, axis):
        return self._groups[axis]

    def axis_index(self, axis):
        return self.data_index if axis == "data" else self.model_index

    @property
    def is_first(self):
        """Rank 0: the one that writes the run dir."""
        return self.rank == 0

    def __repr__(self):
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']}, rank={self.rank})"


def get_mesh(data=None, model=1, device=None):
    """The (data, model) mesh of every rank of the process group (one rank
    outside a group); ``data=None`` means world size // model
    (mesh.py:65-71). ``device`` defaults to the backend's: the current card
    under NCCL, the CPU under gloo. Every rank must call it, in the same
    order: it makes the groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks; the process group has {world}")
    if device is None:
        nccl = dist.is_initialized() and dist.get_backend() == "nccl"
        device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    return Mesh(data, model, torch.device(device))


def _sum_over(tensor, group):
    """In-place Σ of ``tensor`` over ``group``."""
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def _mean_over(tensor, group, n):
    """In-place mean of ``tensor`` over ``group`` of ``n`` ranks: NCCL's AVG
    (the division inside the collective's kernel, which NCCL launches even
    for one rank), else a sum and a division (gloo has no AVG)."""
    if dist.get_backend(group) == "nccl":
        dist.all_reduce(tensor, op=dist.ReduceOp.AVG, group=group)
        return tensor
    return _sum_over(tensor, group).div_(n)


def replicate(mesh, tensors):
    """Broadcast ``tensors`` (a module's parameters and buffers, or a list
    of tensors) from rank 0 in place; returns them."""
    if isinstance(tensors, torch.nn.Module):
        tensors = list(tensors.parameters()) + list(tensors.buffers())
    if mesh.distributed:
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=0)
    return tensors


def all_reduce_gradients(mesh, grads):
    """The mean over the whole world (data × model) of ``grads``, in place:
    one flat buffer a dtype, one all-reduce each. A mean over the world, not
    the data axis: the model ranks of a column partition each
    backpropagate the same replicated terms, which the mean counts once,
    while their columns' cotangents come back summed to their owners."""
    if not mesh.distributed:
        return grads
    groups = {}
    for i, g in enumerate(grads):
        groups.setdefault(g.dtype, []).append(i)
    with torch.no_grad():
        for idx in groups.values():
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            _mean_over(flat, None, mesh.size)
            parts = flat.split([grads[i].numel() for i in idx])
            torch._foreach_copy_([grads[i] for i in idx], [p.view_as(grads[i]) for p, i in zip(parts, idx)])
    return grads


def psum_stats(sums, counts, mesh):
    """Σ over the data group of an evaluation's ``sums`` and ``counts``
    (tensors), in place (mesh.py:94-100); on the mesh's device for the
    collective (NCCL takes no host tensor), wherever they live."""
    if mesh.distributed:
        for t in (sums, counts):
            t.copy_(_sum_over(t.to(mesh.device, copy=True), mesh.group("data")))
    return sums, counts


# ----------------------------------------------------------------- batch
class DataSharding:
    """Rows of a batch over the mesh's data axis: the counterpart of
    ``NamedSharding(mesh, P("data"))``."""

    def __init__(self, mesh):
        self.mesh = mesh

    def rows(self, n):
        """(start, stop) of this rank's rows of a global batch of ``n``, or
        None where the data axis does not divide it (then every rank holds
        the whole batch)."""
        n_data = self.mesh.shape["data"]
        if n % n_data:
            return None
        per = n // n_data
        return self.mesh.data_index * per, (self.mesh.data_index + 1) * per


def data_sharding(mesh):
    """The batch placement the trainer takes."""
    return DataSharding(mesh)


def shard_batch(mesh, x):
    """This rank's contiguous rows of the global batch ``x`` (all of it
    where the data axis does not divide it)."""
    rows = DataSharding(mesh).rows(x.shape[0])
    return x if rows is None else x[rows[0] : rows[1]]


@dataclass(frozen=True)
class _Split:
    mesh: Mesh
    start: int
    stop: int
    n: int


# The split of the step or evaluation running: set by ``batch_split``.
_SPLIT = [None]


@contextlib.contextmanager
def batch_split(sharding, x):
    """Yield this rank's rows of the global batch ``x``. For the length of
    the block the draws and the batch-global reductions are global over the
    data group; with no sharding, or a batch the data axis does not divide,
    the block sees ``x`` whole and no collective."""
    rows = None if sharding is None else sharding.rows(x.shape[0])
    if rows is None:
        yield x
        return
    old = _SPLIT[0]
    _SPLIT[0] = _Split(sharding.mesh, rows[0], rows[1], x.shape[0])
    try:
        yield x[rows[0] : rows[1]]
    finally:
        _SPLIT[0] = old


def global_rows(n_local):
    """The global batch size of a block whose rank holds ``n_local`` rows."""
    split = _SPLIT[0]
    return n_local if split is None else split.n


def draw_rows(draw, shape):
    """``draw(shape)`` for a batch-first ``shape`` of this rank's rows:
    inside a split, the global batch's draw from the shared generator, this
    rank's rows of it, so that N ranks draw what one rank draws."""
    split = _SPLIT[0]
    shape = tuple(shape)
    if split is None:
        return draw(shape)
    if shape[0] != split.stop - split.start:
        raise ValueError(f"a draw of {shape[0]} rows inside a split of {split.stop - split.start}")
    return draw((split.n,) + shape[1:])[split.start : split.stop]


class _SumOverGroup(torch.autograd.Function):
    """Σ over a process group. Its derivative, its tangent and its batched
    form are the same sum, so it runs under ``backward`` (twice, for the
    Hutchinson surrogate), ``torch.func.jvp``/``vjp`` and ``vmap``."""

    @staticmethod
    def forward(x, group):
        return _sum_over(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _SumOverGroup.apply(grad, ctx.group), None

    @staticmethod
    def jvp(ctx, tangent, _):
        return _SumOverGroup.apply(tangent, ctx.group)

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _SumOverGroup.apply(x, group), in_dims[0]


def _data_split():
    split = _SPLIT[0]
    return split if split is not None and split.mesh.distributed else None


def batch_mean(x, dims, keepdim=False):
    """The mean of ``x`` over ``dims`` (the batch axis 0 among them), over
    the global batch inside a split: a differentiable sum over the data
    group over the global count."""
    split = _data_split()
    if split is None:
        return x.mean(dim=dims, keepdim=keepdim)
    count = math.prod(x.shape[d] for d in dims) // (split.stop - split.start) * split.n
    return _SumOverGroup.apply(x.sum(dim=dims, keepdim=keepdim), split.mesh.group("data")) / count


def batch_var_mean(x, dims):
    """(biased variance, mean) over ``dims`` (``torch.var_mean`` with
    ``correction=0``), over the global batch inside a split: the mean, then
    the mean squared deviation from it, each a sum over the data group."""
    if _data_split() is None:
        return torch.var_mean(x, dim=dims, correction=0)
    mean = batch_mean(x, dims, keepdim=True)
    var = batch_mean((x - mean) ** 2, dims, keepdim=True)
    return var.flatten(), mean.flatten()


def mean_over_data(t):
    """Inside a split, the mean over the data group of ``t``, a mean over
    this rank's rows (equal on every rank): the global batch's mean."""
    split = _data_split()
    if split is None:
        return t
    return _mean_over(t.clone(), split.mesh.group("data"), split.mesh.shape["data"])


def batch_all(flags):
    """``flags`` (bool, each already reduced over this rank's rows) AND-ed
    over the data group inside a split: an all-reduce MIN."""
    split = _data_split()
    if split is None:
        return flags
    t = flags.to(torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=split.mesh.group("data"))
    return t.bool()


# ------------------------------------------------------ Jacobian columns
@dataclass(frozen=True)
class ColumnSpec:
    """(mesh, column axis, batch axis) of the non-square head's (d, B, D)
    Jacobian columns, in place of ``NamedSharding(mesh, P("model", "data",
    None))``: the d axis over ``column_axis``, the rows over ``batch_axis``
    (the axis the caller split the batch over, or None), D unsharded."""

    mesh: Mesh
    column_axis: str = "model"
    batch_axis: str = "data"

    def axis_size(self, axis):
        return 1 if axis is None else self.mesh.shape[axis]

    def columns(self, d):
        """(start, stop) of this rank's columns of d."""
        n = self.axis_size(self.column_axis)
        per = d // n
        i = 0 if self.column_axis is None else self.mesh.axis_index(self.column_axis)
        return i * per, (i + 1) * per


# The partition the head reads at call time; None ⇒ no partition.
_JAC_COLUMN_SPEC = [None]


def set_jacobian_column_spec(spec):
    _JAC_COLUMN_SPEC[0] = spec


def jacobian_column_spec():
    return _JAC_COLUMN_SPEC[0]


@contextlib.contextmanager
def jacobian_column_partition(spec):
    old = _JAC_COLUMN_SPEC[0]
    _JAC_COLUMN_SPEC[0] = spec
    try:
        yield
    finally:
        _JAC_COLUMN_SPEC[0] = old
