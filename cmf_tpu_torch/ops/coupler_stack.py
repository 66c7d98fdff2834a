"""Fused ResNet-coupler forward (``cmf_tpu/ops/pallas/coupler_stack.py`` in
torch).

``fused_resnet_coupler(x, params)`` computes ``ResNet.apply`` of the
batchnorm-free coupler net — bias-free 3×3 ``conv_in``; K × (relu → 3×3
conv+b → relu → 3×3 conv+b, plus the skip); relu → 1×1 conv+b →
``head_w·tanh(·) + head_b`` — from ``params``, the JAX ``ResNet`` params tree
(weights OIHW), on x (B, C_in, H, W) fp32. It is the default arithmetic of the
TPU kernel (``bf16=False``, ``stack_taps=False``).

The kernel is CUDA C++ for Hopper in ``csrc/coupler_stack.cu`` (the source
says which TPU kernel it replaces and what bounds it). Beside it is its plain
PyTorch version, ``coupler_stack_plain``, which repeats the TPU kernel's
arithmetic — each 3×3 conv as a sum of 9 shifted, zero-padded (C_out, C_in)
matmuls — and not ``F.conv2d``, so the oracle shares nothing with cuDNN.

The wrapper dispatches on the tensor's device only: on a CUDA tensor it
launches the kernel or raises; on a CPU tensor it takes the plain version.
``LAUNCHES`` counts kernel launches; ``CALLS`` counts calls on any device, so
a CPU test can see which route a caller took.
"""

import ctypes

import torch
import torch.nn.functional as F

LAUNCHES = 0
CALLS = 0


def reset_launch_counts():
    global LAUNCHES, CALLS
    LAUNCHES = 0
    CALLS = 0


def flops(batch, c_in, hidden, c_out, num_blocks, h, w):
    """Multiply-adds ×2 of one coupler call, from the shapes: the 3×3 convs,
    the 1×1 conv and the head's scale-and-shift."""
    p = h * w
    conv33 = 2 * 9 * hidden * p
    per_image = conv33 * c_in + 2 * num_blocks * conv33 * hidden + 2 * hidden * c_out * p + 2 * c_out * p
    return batch * per_image


# ------------------------------------------------------------ plain version
def _conv3x3_taps(h, w, b=None):
    """(B, I, H, W) → (B, O, H, W): Σ over the 9 taps of w[:, :, ky, kx] times
    the map shifted by (ky-1, kx-1), zero outside the image."""
    height, width = h.shape[-2:]
    padded = F.pad(h, (1, 1, 1, 1))
    acc = None
    for ky in range(3):
        for kx in range(3):
            shifted = padded[:, :, ky : ky + height, kx : kx + width]
            term = torch.einsum("oi,bihw->bohw", w[:, :, ky, kx], shifted)
            acc = term if acc is None else acc + term
    if b is not None:
        acc = acc + b[None, :, None, None]
    return acc


def coupler_stack_plain(x, params):
    h = _conv3x3_taps(x, params["conv_in"]["w"])
    for bp in params["blocks"]:
        t = _conv3x3_taps(torch.relu(h), bp["conv1"]["w"], bp["conv1"]["b"])
        t = _conv3x3_taps(torch.relu(t), bp["conv2"]["w"], bp["conv2"]["b"])
        h = h + t
    y = torch.einsum("oi,bihw->bohw", params["conv_out"]["w"][:, :, 0, 0], torch.relu(h))
    y = y + params["conv_out"]["b"][None, :, None, None]
    return params["head_w"][None] * torch.tanh(y) + params["head_b"][None]


# --------------------------------------------------------------- CUDA kernel
def _lib():
    from .cuda_build import load_library

    lib = load_library("coupler_stack")
    # Without argtypes ctypes passes a Python int as a 32-bit C int, which
    # cuts a device pointer.
    if lib.cmf_coupler_stack_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cmf_coupler_stack_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        lib.cmf_coupler_stack_fwd.restype = ctypes.c_int
    return lib


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def pack_weights(params, c_in, hidden, c_out, device):
    """The kernel's weight buffer: each 3×3 conv as [input channel][tap]
    [output channel], then the 1×1 conv as [input][output], its bias and the
    head (``csrc/coupler_stack.cu``). Checks every shape on the way."""

    def taps(name, w, i):
        _check(name, w, (hidden, i, 3, 3), device)
        return w.permute(1, 2, 3, 0).reshape(-1)

    def vec(name, v, n):
        _check(name, v, (n,), device)
        return v

    parts = [taps("conv_in.w", params["conv_in"]["w"], c_in)]
    for k, bp in enumerate(params["blocks"]):
        parts += [
            taps(f"blocks.{k}.conv1.w", bp["conv1"]["w"], hidden),
            vec(f"blocks.{k}.conv1.b", bp["conv1"]["b"], hidden),
            taps(f"blocks.{k}.conv2.w", bp["conv2"]["w"], hidden),
            vec(f"blocks.{k}.conv2.b", bp["conv2"]["b"], hidden),
        ]
    w_out = params["conv_out"]["w"]
    _check("conv_out.w", w_out, (c_out, hidden, 1, 1), device)
    _check("head_w", params["head_w"], (c_out, 1, 1), device)
    _check("head_b", params["head_b"], (c_out, 1, 1), device)
    parts += [
        w_out[:, :, 0, 0].t().reshape(-1),
        vec("conv_out.b", params["conv_out"]["b"], c_out),
        params["head_w"].reshape(-1),
        params["head_b"].reshape(-1),
    ]
    return torch.cat([p.reshape(-1) for p in parts])


def coupler_stack_cuda(x, params):
    """The kernel: x (B, C_in, H, W) CUDA fp32 → (B, C_out, H, W)."""
    global LAUNCHES
    if x.dim() != 4:
        raise ValueError(f"x: expected (B, C_in, H, W), got {tuple(x.shape)}")
    if not x.is_cuda:
        raise ValueError(f"x: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"x: expected float32, got {x.dtype}")
    batch, c_in, h, w = x.shape
    hidden = params["conv_in"]["w"].shape[0]
    c_out = params["conv_out"]["w"].shape[0]
    num_blocks = len(params["blocks"])
    if batch < 1 or hidden < 8 or hidden % 8:
        raise ValueError(f"coupler_stack kernel takes B ≥ 1 and a hidden width that is a "
                         f"positive multiple of 8; got B={batch}, hidden={hidden}")
    x = x.contiguous()
    weights = pack_weights(params, c_in, hidden, c_out, x.device).contiguous()
    out = torch.empty((batch, c_out, h, w), dtype=torch.float32, device=x.device)
    # Two maps per image, the residual stream and one temporary, sized from
    # this call's batch. `weights` and `scratch` are freed when this returns,
    # before the kernel has run; the caching allocator hands their memory
    # only to later work on the same stream, which runs after the kernel.
    scratch = torch.empty((batch, 2, hidden, h, w), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cmf_coupler_stack_fwd(
            x.data_ptr(), weights.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            batch, c_in, h, w, hidden, num_blocks, c_out, stream,
        )
    if rc != 0:
        raise RuntimeError(f"coupler_stack kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out


def fused_resnet_coupler(x, params):
    """Coupler output (B, C_out, H, W), the same function as ``ResNet.apply``
    of the batchnorm-free net. Forward only: it has no derivative rule, so
    callers route only inference through it (``nets/core.py``)."""
    global CALLS
    CALLS += 1
    if x.is_cuda:
        return coupler_stack_cuda(x, params)
    return coupler_stack_plain(x, params)
