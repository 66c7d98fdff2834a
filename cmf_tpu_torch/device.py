"""Device selection and the fp32 precision pin for the port's entry points."""

import torch


def resolve_device(device=None):
    """``None`` means the card. Without one, raise: an entry point never
    carries on on the CPU unless the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
            "to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def pin_fp32():
    """Full-fp32 matmuls and convolutions. The JAX package forces
    fp32-HIGHEST for the Gram / Cholesky maths (cmf_tpu/ops/gram.py,
    cmf_tpu/ops/chol.py); TF32 would keep about three decimal digits of a
    matrix that is about to be Cholesky-factorised."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
