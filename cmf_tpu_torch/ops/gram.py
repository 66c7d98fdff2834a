"""JᵀJ Gram construction from decoder Jacobian columns
(``cmf_tpu/ops/gram.py`` in torch). fp32: the entry points pin TF32 off
(``device.pin_fp32``)."""

import torch


def gram_from_columns(jac_cols):
    """(d, B, D) Jacobian columns → (B, d, d) Gram matrices JᵀJ.

    ``jac_cols[i, b, :]`` is J e_i for batch element b.
    """
    return torch.einsum("ibD,jbD->bij", jac_cols, jac_cols)
