"""Non-square (injective) flow engine, exact log-det path
(``cmf_tpu/densities/nonsquare.py`` in torch).

* The decoder's d Jacobian columns come from the dense augmented-batch
  program (ops/decode_jac.py) over the flat chain.
* Inside the kernels' size gate (d ≤ 32, D ≤ 128) the fused Gram + Cholesky +
  log-det (ops/gram_logdet.py) gives G and log|G|; outside it, the plain Gram
  and the jittered Cholesky (ops/chol.py), as cmf_tpu routes them.
* CMF metric regularisers (non_square.py:87-99): L1 of diag(JᵀJ) (g_kk) and
  of its off-diagonal entries (g_ij).

Waiting for later slices, and raising when asked for: the Hutchinson + CG
log-det (``log_jacobian_method="hutch_with_cg"``) and the generic
(non-dense) Jacobian for chains the dense program does not cover.
"""

import torch

from .base import Density
from ..ops.chol import cholesky_logdet
from ..ops.gram import gram_from_columns
from ..ops.gram_logdet import fused_gram_logdet, fused_gram_logdet_available

_VALID_METHODS = ("cholesky", "hutch_with_cg")

# Steps whose fused log-det was not all finite and was recomputed with the
# jittered Cholesky on the kernel's Gram. Read by chip_smoke.py.
LOGDET_FALLBACKS = 0


class NonSquareHeadDensity(Density):
    def __init__(self, prior, regularization_param, log_jacobian_method, x_shape, latent_dimension=None):
        super().__init__()
        if log_jacobian_method not in _VALID_METHODS:
            raise ValueError(f"{log_jacobian_method} not a valid Jacobian calculation method")
        if log_jacobian_method == "hutch_with_cg":
            raise NotImplementedError(
                "log_jacobian_method='hutch_with_cg' (Hutchinson + CG) waits for a "
                "later slice of the port; use 'cholesky'"
            )
        self.prior = prior
        self.regularization_param = regularization_param
        self.log_jacobian_method = log_jacobian_method
        self.x_shape = tuple(x_shape)
        self.latent_dimension = latent_dimension
        self._program = None

    def decode(self, u):
        return self.prior.decode(u)

    def elbo(
        self,
        x,
        likelihood_wt=1.0,
        metric_wt=1.0,
        add_reconstruction=True,
        add_diagonal_metric_reg=False,
        add_offdiagonal_metric_reg=False,
        skip_likelihood=False,
    ):
        prior_info = self.prior.elbo(x)
        z = prior_info["low_dim_x"]                 # (B, d)
        low_dim_elbo = prior_info["low_dim_elbo"]   # (B,)
        batch = x.shape[0]
        x_flat = x.reshape(batch, -1)

        metric_l1 = 0.0
        if not skip_likelihood:
            log_det, recon_flat, gram = self._exact_log_det(z)
            if add_diagonal_metric_reg:
                metric_l1 = torch.diagonal(gram, dim1=-2, dim2=-1).abs().sum(dim=1)
            elif add_offdiagonal_metric_reg:
                d = gram.shape[-1]
                off = gram * (1.0 - torch.eye(d, dtype=gram.dtype, device=gram.device))
                metric_l1 = off.abs().sum(dim=(1, 2))
            likelihood_term = low_dim_elbo - log_det / 2.0
        else:
            # Warmup fast path (non_square.py:105-109): no log-det at all.
            likelihood_term = 0.0
            recon_flat = self.prior.decode(z).reshape(batch, -1)

        recon_loss = ((recon_flat - x_flat) ** 2).sum(dim=-1) if add_reconstruction else 0.0
        elbo = (
            likelihood_wt * likelihood_term
            - self.regularization_param * recon_loss
            - metric_wt * metric_l1
        )
        return {"elbo": elbo}

    def _dense_decode_program(self):
        if self._program is None:
            from ..ops.decode_jac import extract_dense_decode_program

            self._program = extract_dense_decode_program(self)
            if self._program is None:
                raise NotImplementedError(
                    "this decode chain is not covered by the dense decode program; "
                    "the generic Jacobian path waits for a later slice of the port"
                )
        return self._program

    def _exact_log_det(self, z):
        """(non_square.py:262-311) d basis-tangent pushforwards → Gram →
        Cholesky log-det. Returns (log_det, recon_flat, gram)."""
        global LOGDET_FALLBACKS
        recon_flat, jac_cols = self._dense_decode_program()(z)
        d, big_d = jac_cols.shape[0], jac_cols.shape[-1]
        if fused_gram_logdet_available(d, big_d):
            gram, log_det = fused_gram_logdet(jac_cols)
            # A non-PD Gram gives a non-finite log-det: recompute it with the
            # jittered Cholesky on the kernel's Gram, so the gradient flows
            # back into the backward kernel through Ḡ. One host sync a step.
            if not bool(torch.isfinite(log_det).all()):
                LOGDET_FALLBACKS += 1
                log_det, _ = cholesky_logdet(gram)
        else:
            gram = gram_from_columns(jac_cols)
            log_det, _ = cholesky_logdet(gram)
        return log_det, recon_flat, gram


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
