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

Both kernels can be captured in a CUDA graph: they launch on
``torch.cuda.current_stream()`` (the autograd backward runs on the stream of
its forward, the capture stream), take every buffer from torch's allocator,
and the C entries set the shared-memory opt-in at a device's first launch,
which an eager step makes before any capture. The graph captures each
count's add with its kernel, so a replay counts its launches too.
"""

import ctypes

import torch
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


def launch_counts():
    """(forward, backward) kernel launches so far on every device (a host
    read)."""
    counts = [c.tolist() for c in _LAUNCHES.values()]
    return tuple(sum(c[i] for c in counts) for i in range(2))


def reset_launch_counts():
    """Zero the counts in place: a captured graph keeps its counter."""
    for c in _LAUNCHES.values():
        c.zero_()


def _count_launch(device, which):
    if device not in _LAUNCHES:
        _LAUNCHES[device] = torch.zeros(2, dtype=torch.int64, device=device)
    _LAUNCHES[device][which].add_(1)


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
