"""Non-square (injective) flow engine (``cmf_tpu/densities/nonsquare.py`` in
torch).

* Exact path (``log_jacobian_method="cholesky"``, and every ``train=False``
  elbo): the decoder's d Jacobian columns come from the dense augmented-batch
  program (ops/decode_jac.py) where it covers the chain and has no conv
  stages (flat chains, nonsquare.py:220), else
  from ``torch.func.jvp`` of the flat decode under ``torch.func.vmap`` over
  the d basis tangents (nonsquare.py:225-228). Inside the kernels' size gate
  (d ≤ 32, D ≤ 128) the fused Gram + Cholesky + log-det
  (ops/gram_logdet.py) gives G and log|G|; outside it, the plain Gram and the
  jittered Cholesky (ops/chol.py), as cmf_tpu routes them.
* Stochastic path (``"hutch_with_cg"`` with ``train=True``,
  nonsquare.py:302-392): Hutchinson probes ε (B, d, S), a detached solve of
  (JᵀJ)⁻¹ε, and the surrogate mean_S Σ_d sg[(JᵀJ)⁻¹ε] ⊙ (JᵀJε) whose
  gradient is that of log|JᵀJ|. JᵀJv is a JVP of the flat decode and then a
  VJP (``torch.func.jvp`` / ``torch.func.vjp``); the gradient flows through
  JᵀJε into the decoder's parameters, a second-order gradient. The solve is
  the exact-Gram one (``hutchinson_solver="gram"``, which ``"auto"`` picks
  on flat chains with d ≤ 64): the detached Jacobian columns, their Gram
  and ``spd_solve``, whose factor gives the exact log-det as the value
  (the surrogate keeps the gradient); or the reference's iterative CG.
* CMF metric regularisers (non_square.py:87-99): L1 of diag(JᵀJ) (g_kk,
  Hutchinson-estimated on the stochastic path) and of its off-diagonal
  entries (g_ij, exact path only).
* Batch-norm (nonsquare.py:104-114): the decode of a training elbo reads
  the statistics its encoder's forward just took, through their graph
  (``BatchNormBijection.live_stats``); the couplers' ``BatchNorm2d`` layers
  normalise the decode's own inputs by their batch statistics and leave
  their running statistics as the forward moved them
  (``nets.running_statistics_held``).
* The M-flow baseline head (``ManifoldFlowHeadDensity``,
  nonsquare.py:429-465): a training step takes no log-det at all, only the
  latent prior's elbo on the detached latent and the reconstruction term;
  evaluation and ``ood`` take the exact log-det as above.
"""

import math
import warnings

import torch

from .base import Density
from .elbo import GRAPH_SAFE_GENERATORS
from ..nets import running_statistics_held
from ..ops.cg import batched_cg
from ..ops.chol import cholesky_logdet, spd_solve
from ..ops.gram import gram_from_columns
from ..ops.gram_logdet import (
    fused_gram_logdet,
    fused_gram_logdet_available,
    fused_gram_logdet_sharded,
    fused_gram_logdet_sharded_available,
)
from ..parallel.mesh import batch_all, draw_rows, global_rows, jacobian_column_spec

_VALID_METHODS = ("cholesky", "hutch_with_cg")
_VALID_SOLVERS = ("auto", "gram", "cg")
# 'auto' takes the exact-Gram solver on flat chains up to this d
# (nonsquare.py:63).
_GRAM_SOLVER_MAX_D = 64

# Device → a 0-dim int64 count of the exact log-dets whose fused value was
# not all finite and was replaced by the jittered Cholesky on the kernel's
# Gram. Counted on the device, so a CUDA graph counts on every replay; read
# by ``logdet_fallbacks`` (the trainer at each epoch's end, chip_smoke.py).
LOGDET_FALLBACKS = {}


def logdet_fallbacks():
    """The fallbacks counted so far on every device (a host read)."""
    return sum(int(c) for c in LOGDET_FALLBACKS.values())


def reset_logdet_fallbacks():
    """Zero the counts in place: a captured graph keeps its counter."""
    for c in LOGDET_FALLBACKS.values():
        c.zero_()


def _fallback_counter(device):
    if device not in LOGDET_FALLBACKS:
        LOGDET_FALLBACKS[device] = torch.zeros((), dtype=torch.int64, device=device)
    return LOGDET_FALLBACKS[device]


def exact_log_det_from_columns(jac_cols):
    """(gram (B,d,d), log_det (B,)) of (d, B, D) Jacobian columns, as
    cmf_tpu routes them (nonsquare.py:248-266). Inside the kernels' gate the
    fused Gram + Cholesky + log-det, with the jitter fallback
    (``_kernel_or_fallback``); outside it, the plain Gram and the jittered
    Cholesky."""
    d, big_d = jac_cols.shape[0], jac_cols.shape[-1]
    if not fused_gram_logdet_available(d, big_d):
        gram = gram_from_columns(jac_cols)
        return gram, cholesky_logdet(gram)[0]
    return _kernel_or_fallback(*fused_gram_logdet(jac_cols))


def _kernel_or_fallback(gram, kernel_log_det):
    """Where the kernel's log-det is not all finite, the jittered Cholesky
    of its Gram takes its place, so the gradient flows back into the
    backward kernel through Ḡ. The reference's ``lax.cond`` is a select on
    the device here: the fallback is computed every call, on the identity
    where it is not taken, so that no NaN of an unselected branch reaches
    the gradient as 0·NaN. Under a mesh the predicate is the global batch's
    (an all-reduce MIN), so every rank takes the same branch."""
    d = gram.shape[-1]
    ok = batch_all(torch.isfinite(kernel_log_det).all())
    eye = torch.eye(d, dtype=gram.dtype, device=gram.device)
    fallback_log_det, _ = cholesky_logdet(torch.where(ok, eye, gram))
    _fallback_counter(ok.device).add_(~ok)
    return gram, torch.where(ok, kernel_log_det, fallback_log_det)


class NonSquareHeadDensity(Density):
    def __init__(
        self,
        prior,
        regularization_param,
        log_jacobian_method,
        x_shape,
        hutchinson_distribution="normal",
        num_hutchinson_samples=1,
        max_cg_iterations=None,
        cg_tolerance=1.0,
        latent_dimension=None,
        hutchinson_solver="auto",
    ):
        super().__init__()
        if log_jacobian_method not in _VALID_METHODS:
            raise ValueError(f"{log_jacobian_method} not a valid Jacobian calculation method")
        if hutchinson_solver not in _VALID_SOLVERS:
            raise ValueError(f"{hutchinson_solver} not a valid hutchinson solver")
        self.prior = prior
        self.regularization_param = regularization_param
        self.log_jacobian_method = log_jacobian_method
        self.x_shape = tuple(x_shape)
        self.hutchinson_distribution = hutchinson_distribution
        self.num_hutchinson_samples = num_hutchinson_samples
        self.max_cg_iterations = max_cg_iterations
        self.cg_tolerance = cg_tolerance
        self.latent_dimension = latent_dimension
        self.hutchinson_solver = hutchinson_solver
        self._program = None
        self._program_checked = False

    def decode(self, u):
        return self.prior.decode(u)

    @property
    def step_capturable(self):
        """The exact log-det reads nothing on the host. The Hutchinson
        estimate draws its probes from the caller's generator: with the
        exact-Gram solver it is capturable where that generator can be
        registered with the graph (as a CIF's u); the CG loop reads a flag
        each iteration."""
        if self.log_jacobian_method == "hutch_with_cg":
            gram = self._resolved_hutch_solver(self.latent_dimension) == "gram"
            if not (gram and GRAPH_SAFE_GENERATORS):
                return False
        return super().step_capturable

    def _decode_flat(self, u):
        """The decode of a step: its couplers' batch-norm layers leave their
        running statistics as the step's forward moved them."""
        with running_statistics_held(self.prior):
            return self.prior.decode(u).reshape(u.shape[0], -1)

    def _sample(self, num_samples, generator=None):
        return self.prior._sample(num_samples, generator)

    def _fixed_sample(self, noise=None):
        return self.prior._fixed_sample(noise)

    def elbo(
        self,
        x,
        train=False,
        generator=None,
        hutchinson_eps=None,
        u_noise=None,
        likelihood_wt=1.0,
        metric_wt=1.0,
        add_reconstruction=True,
        add_diagonal_metric_reg=False,
        add_offdiagonal_metric_reg=False,
        skip_likelihood=False,
        ood=False,
    ):
        """``generator`` draws the Hutchinson probes ε (B, d, S) unless the
        caller passes them as ``hutchinson_eps``, and the u of a CIF layer
        in the low-dimensional prior unless the caller passes its ε as
        ``u_noise`` (``cmf_tpu`` hands its ``rng`` to the prior). With
        ``ood`` the likelihood term and the reconstruction error, unweighted
        (nonsquare.py:141-188)."""
        if ood:
            assert self.log_jacobian_method == "cholesky" or not train
        prior_info = self.prior.elbo(x, generator=generator, u_noise=u_noise)
        z = prior_info["low_dim_x"]                 # (B, d)
        low_dim_elbo = prior_info["low_dim_elbo"]   # (B,)
        batch = x.shape[0]
        x_flat = x.reshape(batch, -1)

        metric_l1 = 0.0
        if not skip_likelihood:
            if not train or self.log_jacobian_method == "cholesky":
                log_det, recon_flat, gram = self._exact_log_det(z)
                if add_diagonal_metric_reg:
                    metric_l1 = torch.diagonal(gram, dim1=-2, dim2=-1).abs().sum(dim=1)
                elif add_offdiagonal_metric_reg:
                    d = gram.shape[-1]
                    off = gram * (1.0 - torch.eye(d, dtype=gram.dtype, device=gram.device))
                    metric_l1 = off.abs().sum(dim=(1, 2))
            else:
                assert not add_offdiagonal_metric_reg, (
                    "g_ij regularisation needs the exact Gram: use "
                    "log_jacobian_method='cholesky'"
                )
                log_det, recon_flat, diag_est = self._approx_log_det(z, generator, hutchinson_eps)
                if add_diagonal_metric_reg:
                    metric_l1 = diag_est.abs().sum(dim=1)
            likelihood_term = low_dim_elbo - log_det / 2.0
        else:
            # Warmup fast path (non_square.py:105-109): no log-det at all.
            likelihood_term = 0.0
            recon_flat = self._decode_flat(z)

        recon_loss = ((recon_flat - x_flat) ** 2).sum(dim=-1) if add_reconstruction else 0.0
        if ood:
            return {"likelihood": likelihood_term, "reconstruction-error": recon_loss}
        elbo = (
            likelihood_wt * likelihood_term
            - self.regularization_param * recon_loss
            - metric_wt * metric_l1
        )
        return {"elbo": elbo}

    def ood(self, x):
        """The OOD features of ``x`` through the exact log-det
        (nonsquare.py:411-413)."""
        return self.elbo(x, train=False, ood=True)

    def extract_latent(self, x, earliest=False):
        """The d coordinates the tail keeps (nonsquare.py:403-409); with
        ``earliest``, the latent prior's own latent."""
        if earliest:
            return self.prior.extract_latent(x, earliest=True)
        return self.prior.elbo(x)["low_dim_x"]

    def pullback_log_jac_jac_transpose(self, x):
        """log(J_enc J_encᵀ) of a 1-D latent, the pullback density
        correction of the 2-D visualisers (nonsquare.py:415-432): the
        encoder's gradient at each example by ``torch.func.grad`` under
        ``torch.func.vmap``."""

        def encode(xi):
            return self.prior.elbo(xi[None])["low_dim_x"][0, 0]

        jac = torch.func.vmap(torch.func.grad(encode))(x).reshape(x.shape[0], -1)
        return torch.log((jac * jac).sum(dim=1))

    def _dense_decode_program(self):
        """The dense decode program of the chain, or None (cached)."""
        if not self._program_checked:
            from ..ops.decode_jac import extract_dense_decode_program

            self._program = extract_dense_decode_program(self)
            self._program_checked = True
        return self._program

    def _generic_jacobian(self, z, columns=None):
        """(recon_flat (B, D), jac_cols (k, B, D)): a JVP of the flat decode
        for each of the basis tangents ``columns`` = (start, stop) of d (all
        d by default), batched by ``torch.func.vmap``."""
        batch, d = z.shape
        start, stop = (0, d) if columns is None else columns
        basis = torch.eye(d, dtype=z.dtype, device=z.device)[start:stop]

        def column(e):
            return torch.func.jvp(self._decode_flat, (z,), (e.expand(batch, d),))

        return torch.func.vmap(column, out_dims=(None, 0))(basis)

    def _exact_log_det(self, z):
        """(non_square.py:262-311) d basis-tangent pushforwards → Gram →
        Cholesky log-det. Returns (log_det, recon_flat, gram). A program
        with conv stages is not taken here (nonsquare.py:211-220).

        Under a column partition (``parallel.mesh.jacobian_column_partition``,
        nonsquare.py:228-262) inside kernel 4's gate, this rank pushes only
        its d/n_model basis tangents and kernel 4 all-gathers the columns
        over the model group; outside the gate every rank pushes all d for
        its own rows and takes the unpartitioned route, rows 1-2 inside
        their gate."""
        batch, d = z.shape
        spec = jacobian_column_spec()
        sharded = spec is not None and fused_gram_logdet_sharded_available(
            d, global_rows(batch), math.prod(self.x_shape), spec
        )
        columns = spec.columns(d) if sharded else None
        program = self._dense_decode_program()
        if program is not None and not program.has_conv:
            recon_flat, jac_cols = program(z, columns)
        else:
            recon_flat, jac_cols = self._generic_jacobian(z, columns)
        if sharded:
            gram, log_det = _kernel_or_fallback(*fused_gram_logdet_sharded(jac_cols, spec))
        else:
            gram, log_det = exact_log_det_from_columns(jac_cols)
        return log_det, recon_flat, gram

    def _resolved_hutch_solver(self, d):
        """'auto' picks the exact-Gram solver where a dense decode program
        without conv stages covers the chain and d is small, else the
        reference's iterative CG (nonsquare.py:270-300), warning once that
        the CG settings are inert when it picks the Gram. The conv chains of
        the image models take CG."""
        if self.hutchinson_solver != "auto":
            return self.hutchinson_solver
        program = self._dense_decode_program()
        resolved = "cg"
        if d is not None and d <= _GRAM_SOLVER_MAX_D and program is not None and not program.has_conv:
            resolved = "gram"
        if (
            resolved == "gram"
            and not getattr(self, "_warned_inert_cg", False)
            and (self.max_cg_iterations is not None or self.cg_tolerance != 1.0)
        ):
            self._warned_inert_cg = True
            warnings.warn(
                "hutchinson_solver='auto' resolved to the exact-Gram solver; "
                "max_cg_iterations/cg_tolerance are inert. Set "
                "hutchinson_solver='cg' for the reference's iterative CG.",
                stacklevel=2,
            )
        return resolved

    def _approx_log_det(self, z, generator=None, eps=None):
        """(non_square.py:203-258) Hutchinson surrogate log-det with a
        detached solve, by the exact Gram or by CG. Returns (log_det,
        recon_flat, diag_est)."""
        batch, d = z.shape
        S = self.num_hutchinson_samples
        if eps is None:
            shape = (batch, d, S)
            # Under a mesh: the global batch's draw, this rank's rows.
            if self.hutchinson_distribution == "normal":
                eps = draw_rows(
                    lambda s: torch.randn(s, generator=generator, dtype=z.dtype, device=z.device), shape
                )
            elif self.hutchinson_distribution == "rademacher":
                bits = draw_rows(lambda s: torch.randint(0, 2, s, generator=generator, device=z.device), shape)
                eps = (2 * bits - 1).to(z.dtype)
            else:
                raise ValueError(f"Unknown hutchinson distribution {self.hutchinson_distribution}")

        decode_flat = self._decode_flat
        recon_flat, vjp_fn = torch.func.vjp(decode_flat, z)

        def jtj(v):  # JᵀJv, (B, d, S) → (B, d, S)
            cols = []
            for s in range(v.shape[-1]):
                _, jv = torch.func.jvp(decode_flat, (z,), (v[..., s],))
                cols.append(vjp_fn(jv)[0])
            return torch.stack(cols, dim=-1)

        jtj_eps = jtj(eps)  # the gradient flows through this factor
        gram = None
        if self._resolved_hutch_solver(d) == "gram":
            # The d columns of the decoder's Jacobian, detached from the
            # weights and from z, in one batched fan-out; the Gram; and its
            # jittered Cholesky, which solves for (JᵀJ)⁻¹ε and gives the
            # exact log-det (nonsquare.py:343-357).
            program = self._dense_decode_program()
            with torch.no_grad():
                if program is not None:
                    _, jac_cols = program(z.detach())
                else:
                    _, jac_cols = self._generic_jacobian(z.detach())
                gram = gram_from_columns(jac_cols)
                jtj_inv_eps, chol_l = spd_solve(gram, eps.detach())
                exact_log_det = 2.0 * torch.log(torch.diagonal(chol_l, dim1=-2, dim2=-1)).sum(dim=-1)
        else:
            # Reference CG semantics (non_square.py:241-247): a detached
            # solve whose first matvec is JᵀJε, so at cg_tolerance=1 the
            # loop usually runs none; further matvecs reuse the
            # linearisation without a graph.
            with torch.no_grad():
                jtj_inv_eps = batched_cg(
                    jtj,
                    eps.detach(),
                    max_iter=self.max_cg_iterations or d,
                    tolerance=self.cg_tolerance,
                    first_matvec=jtj_eps.detach(),
                )

        surrogate = (jtj_inv_eps * jtj_eps).sum(dim=1).mean(dim=-1)
        # Unbiased Hutchinson estimate of diag(JᵀJ) for the g_kk regulariser.
        diag_est = (eps * jtj_eps).mean(dim=-1)
        if gram is None:
            return surrogate, recon_flat, diag_est
        # Value correction (nonsquare.py:384-391): the exact log-det and the
        # exact diagonal as the values, the surrogate's and the estimate's
        # gradients kept.
        log_det = exact_log_det + surrogate - surrogate.detach()
        diag_est = torch.diagonal(gram, dim1=-2, dim2=-1) + diag_est - diag_est.detach()
        return log_det, recon_flat, diag_est


class ManifoldFlowHeadDensity(NonSquareHeadDensity):
    """The M-flow baseline head (nonsquare.py:429-465). With ``train`` and
    not ``ood``: ``likelihood_wt · low_dim_elbo − regularization_param ·
    Σ (decode(z) − x)²`` with z the tail's kept coordinates, the likelihood
    term 0 under ``skip_likelihood`` and the reconstruction term 0 without
    ``add_reconstruction``; no log-det and no metric term. The tail detaches
    z before its prior (``detach_before_prior``), so the likelihood term
    trains the latent prior alone. Otherwise the parent's elbo. The JAX head
    decodes z even without the reconstruction term and XLA drops the
    unused result; here that decode is skipped."""

    @property
    def step_capturable(self):
        """A training step draws no probes and reads nothing on the host,
        whatever ``log_jacobian_method`` says: as capturable as the
        densities it holds."""
        return Density.step_capturable.fget(self)

    def elbo(self, x, train=False, ood=False, likelihood_wt=1.0, add_reconstruction=True,
             skip_likelihood=False, generator=None, u_noise=None, **kw):
        if not train or ood:
            return super().elbo(x, train=train, ood=ood, likelihood_wt=likelihood_wt,
                                add_reconstruction=add_reconstruction, skip_likelihood=skip_likelihood,
                                generator=generator, u_noise=u_noise, **kw)
        prior_info = self.prior.elbo(x, generator=generator, u_noise=u_noise)
        batch = x.shape[0]
        likelihood_term = 0.0 if skip_likelihood else prior_info["low_dim_elbo"]
        recon_loss = 0.0
        if add_reconstruction:
            recon_flat = self._decode_flat(prior_info["low_dim_x"])
            recon_loss = ((recon_flat - x.reshape(batch, -1)) ** 2).sum(dim=-1)
        return {"elbo": likelihood_wt * likelihood_term - self.regularization_param * recon_loss}


class NonSquareTailDensity(Density):
    """Projection to the first d (permuted) coordinates + low-dim prior
    (non_square.py:367-421). The random permutation is state: drawn from the
    generator here, loaded from the JAX tree by interop."""

    def __init__(self, prior, x_shape, latent_dimension, detach_before_prior, generator=None):
        super().__init__()
        self.prior = prior
        self.x_shape = tuple(x_shape)
        self.latent_dimension = latent_dimension
        self.detach_before_prior = detach_before_prior
        self.flattened_dims = 1
        for s in self.x_shape:
            self.flattened_dims *= s
        perm = torch.randperm(self.flattened_dims, generator=generator)
        self.register_buffer("permutation", perm)
        self.register_buffer("inverse_permutation", torch.argsort(perm))

    def elbo(self, x, **kw):
        flat = x.reshape(x.shape[0], -1)
        low_dim_x = flat[:, self.permutation][:, : self.latent_dimension]
        prior_in = low_dim_x.detach() if self.detach_before_prior else low_dim_x
        prior_info = self.prior.elbo(prior_in, **kw)
        return {
            "elbo": prior_info["elbo"],
            "low_dim_x": low_dim_x,
            "low_dim_elbo": prior_info["elbo"],
        }

    def decode(self, u):
        """Zero-pad to D, inverse-permute, reshape (non_square.py:397-404)."""
        batch = u.shape[0]
        padded = torch.cat([u, u.new_zeros(batch, self.flattened_dims - self.latent_dimension)], dim=1)
        return padded[:, self.inverse_permutation].reshape(batch, *self.x_shape)

    def _sample(self, num_samples, generator=None):
        return self.decode(self.prior._sample(num_samples, generator))

    def _fixed_sample(self, noise=None):
        return self.decode(self.prior._fixed_sample(noise))

    def extract_latent(self, x, earliest=False):
        """The projection to the d kept coordinates, then the latent prior's
        latent (nonsquare.py:526-535)."""
        flat = x.reshape(x.shape[0], -1)
        low_dim = flat[:, self.permutation][:, : self.latent_dimension]
        return self.prior.extract_latent(low_dim, earliest=earliest)
