"""Fused JᵀJ Gram + Cholesky + log-det, forward and backward
(``cmf_tpu/ops/pallas/gram_logdet.py`` in torch).

The two kernels are CUDA C++ for Hopper in ``csrc/gram_logdet.cu`` (the
source says which TPU kernel each replaces and what bounds it). Beside them
are their plain PyTorch versions: ``gram_logdet_plain`` (``gram_from_columns``
+ an un-jittered Cholesky log-det) and ``gram_logdet_bwd_plain`` (the same dJ
formula in torch ops). ``gram_logdet_fwd_panels_emulated`` and
``gram_logdet_bwd_solves_emulated`` repeat the kernels' own algorithms (the
Gram in one order and the factor in 4-column panels; two triangular solves
in place of G⁻¹) for the CPU tests; no path of the port calls them.

``fused_gram_logdet`` dispatches on the tensor's device only: on a CUDA
tensor it launches the kernels or raises; on a CPU tensor it takes the plain
versions. Each wrapper counts its launches on the device, one add on the
launch's stream right after the kernel, so a run can show that its main path
went through them; ``launch_counts`` reads the counts on the host.

``fused_gram_logdet_sharded`` (kernel 4, ``gram_logdet.py:212-268``) is the
multi-rank wrapper, no kernel body of its own: under a column partition
(``parallel/mesh.py``) each rank all-gathers the (d/n_model, B/n_data, D)
column shards of its model group (NCCL on the card, as ``cmf_tpu``'s are
XLA's), runs kernels 1-2 on its rows and sends the backward's dJ back by a
reduce-scatter (SUM), the transpose of the all-gather. Its launches are
counted apart (``sharded_launch_counts``); the kernels it runs count
theirs too.

Both kernels can be captured in a CUDA graph: they launch on
``torch.cuda.current_stream()`` (the autograd backward runs on the stream of
its forward, the capture stream), take every buffer from torch's allocator,
and the C entries set the shared-memory opt-in at a device's first launch,
which an eager step makes before any capture. The graph captures each
count's add with its kernel, so a replay counts its launches too.
"""

import ctypes

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from .chol import _cholesky
from .gram import gram_from_columns

# Size gate of the kernels (gram_logdet.py:44-45): shared-memory tiles are
# sized for it. The caller routes larger shapes to the plain Gram + jittered
# Cholesky, as cmf_tpu does (nonsquare.py:248-266).
MAX_D_LATENT = 32
MAX_D_AMBIENT = 128

# Device → int64 (2,): launches of the forward and of the backward kernel.
# Made at a device's first eager launch, before any capture.
_LAUNCHES = {}
# The same for kernel 4's forward and backward (each launches kernel 1 or 2).
_SHARDED_LAUNCHES = {}


def _read(counters):
    counts = [c.tolist() for c in counters.values()]
    return tuple(sum(c[i] for c in counts) for i in range(2))


def launch_counts():
    """(forward, backward) kernel launches so far on every device (a host
    read)."""
    return _read(_LAUNCHES)


def sharded_launch_counts():
    """(forward, backward) launches of kernel 4 so far (a host read)."""
    return _read(_SHARDED_LAUNCHES)


def reset_launch_counts():
    """Zero the counts in place: a captured graph keeps its counter."""
    for c in list(_LAUNCHES.values()) + list(_SHARDED_LAUNCHES.values()):
        c.zero_()


def _count_launch(device, which, counters=_LAUNCHES):
    if device not in counters:
        counters[device] = torch.zeros(2, dtype=torch.int64, device=device)
    counters[device][which].add_(1)


def fused_gram_logdet_available(d, big_d):
    return 1 <= d <= MAX_D_LATENT and 1 <= big_d <= MAX_D_AMBIENT


# ------------------------------------------------------------ plain versions
def gram_logdet_plain(jac_cols):
    """(d, B, D) → (gram (B,d,d), logdet (B,), L (B,d,d)); differentiable
    torch ops, NaN where the Gram is not PD."""
    gram = gram_from_columns(jac_cols)
    L = _cholesky(gram)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(dim=-1)
    return gram, logdet, L


def gram_logdet_bwd_plain(jac_cols, L, gbar, ldbar):
    """dJ[i] = Σ_j (Ḡ[i,j] + Ḡ[j,i] + 2·ḡ_ld·G⁻¹[i,j]) · J[j], G⁻¹ from L.
    Where ḡ_ld is 0 the G⁻¹ term is dropped, as in the kernel."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
    X = torch.linalg.solve_triangular(L, eye, upper=False)
    ginv = X.transpose(-1, -2) @ X
    ld = ldbar[:, None, None]
    M = gbar + gbar.transpose(-1, -2) + torch.where(ld != 0, 2.0 * ld * ginv, torch.zeros_like(ginv))
    return torch.einsum("bij,jbD->ibD", M, jac_cols)


def gram_logdet_fwd_panels_emulated(jac_cols):
    """The forward kernel's algorithm in fp32 torch ops, for the tests only:
    (d, B, D) → (gram (B,d,d), logdet (B,), L (B,d,d)). The Gram is summed
    over k in order; A = G padded to dp = d rounded up to 4, with 1 on the
    pad diagonal; then Cholesky-Banachiewicz in 4-column panels: each row's
    four panel entries less the columns left of the panel, then the panel's
    4×4 triangle column by column, q = rsqrt(s), L[j][j] = s·q, L[i][j] = t·q.
    The kernel fuses the multiply-adds, which changes only the rounding.
    A pivot s ≤ 0 gives NaN or -inf, never a clamp."""
    d, b, big_d = jac_cols.shape
    dp = -(-d // 4) * 4
    J = torch.zeros((b, dp, big_d), dtype=torch.float32, device=jac_cols.device)
    J[:, :d] = jac_cols.permute(1, 0, 2)
    G = torch.zeros((b, dp, dp), dtype=torch.float32, device=jac_cols.device)
    for k in range(big_d):
        G = G + J[:, :, k, None] * J[:, None, :, k]
    A = G.clone()
    pad = torch.arange(d, dp)
    A[:, pad, pad] = 1.0
    logdet = torch.zeros((b,), dtype=torch.float32, device=jac_cols.device)
    for j0 in range(0, dp, 4):
        a = A[:, j0:, j0 : j0 + 4].clone()  # rows j0.. of the panel's columns
        for k in range(j0):
            a = a - A[:, j0:, k, None] * A[:, None, j0 : j0 + 4, k]
        panel = torch.zeros_like(a)
        for c in range(4):
            t = a[:, :, c]
            for m in range(c):
                t = t - panel[:, :, m] * panel[:, c : c + 1, m]
            s = t[:, c]
            q = torch.rsqrt(s)
            logdet = logdet + torch.log(s)
            col = t * q[:, None]
            col[:, c] = s * q
            col[:, :c] = 0.0
            panel[:, :, c] = col
        A[:, j0:, j0 : j0 + 4] = panel
    return G[:, :d, :d], logdet, torch.tril(A[:, :d, :d])


def gram_logdet_bwd_solves_emulated(jac_cols, L, gbar, ldbar):
    """The backward kernel's algorithm in fp32 torch ops, for the tests only:
    dJ = M·J + 2·ḡ_ld·Z with M = Ḡ + Ḡᵀ and Z = L⁻ᵀ(L⁻¹J) by forward, then
    back substitution, G⁻¹ never formed. Row by row here; the kernel takes
    the rows four at a time, which changes only the order of the sums. Reads
    only the lower triangle of L, and only where ḡ_ld ≠ 0 (the solves are
    skipped elsewhere, so a NaN factor there leaves the gradient finite)."""
    d = jac_cols.shape[0]
    J = jac_cols.permute(1, 0, 2)  # (B, d, D)
    out = (gbar + gbar.transpose(-1, -2)) @ J
    solve = ldbar != 0
    if bool(solve.any()):
        Ls = L[solve]
        W = J[solve].clone()
        for i in range(d):  # Y[i] = L[i][i]⁻¹(J[i] − Σ_{m<i} L[i][m]·Y[m])
            acc = W[:, i] - (Ls[:, i, :i, None] * W[:, :i]).sum(1)
            W[:, i] = acc * (1.0 / Ls[:, i, i, None])
        for i in reversed(range(d)):  # Z[i] = L[i][i]⁻¹(Y[i] − Σ_{m>i} L[m][i]·Z[m])
            acc = W[:, i] - (Ls[:, i + 1 :, i, None] * W[:, i + 1 :]).sum(1)
            W[:, i] = acc * (1.0 / Ls[:, i, i, None])
        out[solve] = out[solve] + 2.0 * ldbar[solve, None, None] * W
    return out.permute(1, 0, 2).contiguous()


# ------------------------------------------------------------- CUDA kernels
def _lib():
    from .cuda_build import load_library

    lib = load_library("gram_logdet")
    # Without argtypes ctypes passes a Python int as a 32-bit C int, which
    # cuts a device pointer.
    if lib.cmf_gram_logdet_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cmf_gram_logdet_fwd.argtypes = [p, p, p, p, i, i, i, p]
        lib.cmf_gram_logdet_fwd.restype = ctypes.c_int
        lib.cmf_gram_logdet_bwd.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.cmf_gram_logdet_bwd.restype = ctypes.c_int
    return lib


def _check(name, t, shape):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _shape(jac_cols):
    if jac_cols.dim() != 3:
        raise ValueError(f"jac_cols: expected (d, B, D), got {tuple(jac_cols.shape)}")
    d, b, big_d = jac_cols.shape
    if not fused_gram_logdet_available(d, big_d) or b < 1:
        raise ValueError(
            f"gram_logdet kernel takes 1 ≤ d ≤ {MAX_D_LATENT}, 1 ≤ D ≤ {MAX_D_AMBIENT}, "
            f"B ≥ 1; got d={d}, B={b}, D={big_d}"
        )
    return d, b, big_d


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {rc}")


def gram_logdet_fwd_cuda(jac_cols):
    """Kernel 1: (d, B, D) → (gram (B,d,d), logdet (B,), L (B,d,d))."""
    d, b, big_d = _shape(jac_cols)
    _check("jac_cols", jac_cols, (d, b, big_d))
    gram = torch.empty((b, d, d), dtype=torch.float32, device=jac_cols.device)
    L = torch.empty_like(gram)
    logdet = torch.empty((b,), dtype=torch.float32, device=jac_cols.device)
    lib = _lib()
    with torch.cuda.device(jac_cols.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cmf_gram_logdet_fwd(
            jac_cols.data_ptr(), gram.data_ptr(), logdet.data_ptr(), L.data_ptr(),
            d, b, big_d, stream,
        )
    _raise_on(rc, "gram_logdet forward")
    _count_launch(jac_cols.device, 0)
    return gram, logdet, L


def gram_logdet_bwd_cuda(jac_cols, L, gbar, ldbar):
    """Kernel 2: dJ (d, B, D) from J, the saved L, Ḡ (B,d,d) and ḡ_ld (B,)."""
    d, b, big_d = _shape(jac_cols)
    _check("jac_cols", jac_cols, (d, b, big_d))
    _check("L", L, (b, d, d))
    _check("gbar", gbar, (b, d, d))
    _check("ldbar", ldbar, (b,))
    djac = torch.empty_like(jac_cols)
    lib = _lib()
    with torch.cuda.device(jac_cols.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cmf_gram_logdet_bwd(
            jac_cols.data_ptr(), L.data_ptr(), gbar.data_ptr(), ldbar.data_ptr(),
            djac.data_ptr(), d, b, big_d, stream,
        )
    _raise_on(rc, "gram_logdet backward")
    _count_launch(jac_cols.device, 1)
    return djac


class _FusedGramLogdet(torch.autograd.Function):
    """Forward launches kernel 1 and saves (J, L); backward launches
    kernel 2. On CPU tensors both take the plain versions."""

    @staticmethod
    def forward(ctx, jac_cols):
        if jac_cols.is_cuda:
            gram, logdet, L = gram_logdet_fwd_cuda(jac_cols)
        else:
            gram, logdet, L = gram_logdet_plain(jac_cols)
        ctx.save_for_backward(jac_cols, L)
        return gram, logdet

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar, ldbar):
        jac_cols, L = ctx.saved_tensors
        gbar, ldbar = gbar.contiguous(), ldbar.contiguous()
        if jac_cols.is_cuda:
            return gram_logdet_bwd_cuda(jac_cols, L, gbar, ldbar)
        return gram_logdet_bwd_plain(jac_cols, L, gbar, ldbar)


def fused_gram_logdet(jac_cols):
    """(d, B, D) Jacobian columns → (gram (B,d,d), logdet (B,)).

    Same semantics as ``gram_from_columns`` + one un-jittered Cholesky
    log-det: NaN where the Gram is not PD. The caller keeps the jitter
    fallback (densities/nonsquare.py)."""
    return _FusedGramLogdet.apply(jac_cols)


# ---------------------------------------------------- kernel 4: sharded
def fused_gram_logdet_sharded_available(d, batch, big_d, spec):
    """The gate of kernel 4 (gram_logdet.py:259-268): the columns and the
    global batch divide evenly over their axes of ``spec`` (a
    ``parallel.mesh.ColumnSpec``, whose D axis is never sharded), inside
    kernels 1-2's gate."""
    if d % spec.axis_size(spec.column_axis) or batch % spec.axis_size(spec.batch_axis):
        return False
    return fused_gram_logdet_available(d, big_d)


class _ShardedGramLogdet(torch.autograd.Function):
    """Forward: all-gather the column shards over the model group, kernel 1
    on (d, B_local, D); backward: kernel 2, then a reduce-scatter (SUM) of
    dJ over the model group, each rank keeping its columns' rows. On CPU
    tensors (gloo) the plain versions take the kernels' place."""

    @staticmethod
    def forward(ctx, jac_local, group, n):
        full = jac_local.contiguous()
        if group is not None:
            full = jac_local.new_empty((n * jac_local.shape[0],) + tuple(jac_local.shape[1:]))
            dist.all_gather_into_tensor(full, jac_local.contiguous(), group=group)
        if full.is_cuda:
            gram, logdet, L = gram_logdet_fwd_cuda(full)
            _count_launch(full.device, 0, _SHARDED_LAUNCHES)
        else:
            gram, logdet, L = gram_logdet_plain(full)
        ctx.save_for_backward(full, L)
        ctx.group, ctx.local_shape = group, tuple(jac_local.shape)
        return gram, logdet

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar, ldbar):
        full, L = ctx.saved_tensors
        gbar, ldbar = gbar.contiguous(), ldbar.contiguous()
        if full.is_cuda:
            dfull = gram_logdet_bwd_cuda(full, L, gbar, ldbar)
            _count_launch(full.device, 1, _SHARDED_LAUNCHES)
        else:
            dfull = gram_logdet_bwd_plain(full, L, gbar, ldbar)
        if ctx.group is None:
            return dfull, None, None
        djac = dfull.new_empty(ctx.local_shape)
        dist.reduce_scatter_tensor(djac, dfull.contiguous(), op=dist.ReduceOp.SUM, group=ctx.group)
        return djac, None, None


def fused_gram_logdet_sharded(jac_cols, spec):
    """``fused_gram_logdet`` under a column partition (gram_logdet.py:
    212-256): ``jac_cols`` is this rank's (d/n_model, B_local, D) shard of
    the columns, laid out by ``spec`` (a ``parallel.mesh.ColumnSpec``).
    Returns this rank's rows' (gram (B_local,d,d), logdet (B_local,)), the
    same on every rank of a model group. Each model rank backpropagates the
    same Gram, so the reduce-scatter returns n_model times each column's
    cotangent to its owner; the trainer's gradient mean over the whole
    world (data × model, ``parallel.mesh.all_reduce_gradients``) divides it
    back, and counts the replicated terms once."""
    n = spec.axis_size(spec.column_axis)
    group = spec.mesh.group(spec.column_axis) if spec.column_axis is not None else None
    return _ShardedGramLogdet.apply(jac_cols, group, n)
