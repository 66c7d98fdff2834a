"""The fused Gram + Cholesky + log-det pair at (d, B, D): B Jacobians of
D rows and d columns, fp32."""

F32 = 4


def forward(d, b, big_d):
    """(FLOPs, bytes): the symmetric Gram JᵀJ, its Cholesky factor and the
    log-det; J read, the Gram, the factor and the log-dets written."""
    flops = b * (big_d * d * (d + 1) + d**3 / 3 + d)
    nbytes = F32 * (d * b * big_d + 2 * b * d * d + b)
    return flops, nbytes


def backward(d, b, big_d):
    """(FLOPs, bytes): dJ = J·(Ḡ + Ḡᵀ + 2·ḡ_ld·G⁻¹), G⁻¹ from the factor;
    J, the factor, Ḡ and ḡ_ld read, dJ written."""
    flops = b * (2 * big_d * d * d + 2 * d**3 / 3 + 2 * d * d)
    nbytes = F32 * (2 * d * b * big_d + 2 * b * d * d + b)
    return flops, nbytes
