"""Fused ResNet-coupler forward (``cmf_tpu/ops/pallas/coupler_stack.py`` in
torch).

``fused_resnet_coupler(x, params)`` computes ``ResNet.apply`` of the
batchnorm-free coupler net — bias-free 3×3 ``conv_in``; K × (relu → 3×3
conv+b → relu → 3×3 conv+b, plus the skip); relu → 1×1 conv+b →
``head_w·tanh(·) + head_b`` — from ``params``, the JAX ``ResNet`` params tree
(weights OIHW), on x (B, C_in, H, W) fp32. It is the default arithmetic of the
TPU kernel (``bf16=False``): fp32 in, fp32 out, fp32 sums.

The kernel is CUDA C++ for Hopper in ``csrc/coupler_stack.cu`` (the source
says which TPU kernel it replaces, what bounds it and what its design does
about it): one thread-block cluster per image, the feature maps in shared
memory, every hidden×hidden 3×3 conv on the tensor cores in 3×TF32. This
module holds what surrounds it in Python, where the CPU tests reach it: the
launch plan (``plan_launch``, and the shape gate
``coupler_kernel_available``), the TF32 split of the weights (``tf32_round``,
``split_tf32``) and their packing in mma fragment order (``pack_weights``).

Beside it is its plain PyTorch version, ``coupler_stack_plain``, which repeats
the TPU kernel's arithmetic — each 3×3 conv as a sum of 9 shifted,
zero-padded (C_out, C_in) matmuls, in fp32 — and not ``F.conv2d``, so the
oracle shares nothing with cuDNN.

The wrapper dispatches on the tensor's device only: on a CUDA tensor it
launches the kernel or raises; on a CPU tensor it takes the plain version.
``LAUNCHES`` counts kernel launches; ``CALLS`` counts calls on any device, so
a CPU test can see which route a caller took.
"""

import ctypes
import weakref
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.autograd import forward_ad

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


def tensor_core_flops(batch, hidden, num_blocks, h, w):
    """The part of ``flops`` that the kernel runs on the tensor cores: the
    2K hidden×hidden 3×3 convs. 3×TF32 issues each of them three times."""
    return batch * 2 * num_blocks * 2 * 9 * hidden * hidden * h * w


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


# ------------------------------------------------------------- TF32 split
def tf32_round(x):
    """fp32 → the nearest TF32 value (10 mantissa bits), ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds: add 0x1000 to the bits and clear the low
    13. Subnormals round the same way, ±0 and ±inf stay, a value that
    rounds past the largest TF32 becomes inf, NaN stays NaN."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2**31, r - 2**32, r).to(torch.int32).view(torch.float32)
    return torch.where(torch.isnan(x), x, r)


def split_tf32(x):
    """x = hi + lo + O(2⁻²²·|x|), both TF32: the operands of 3×TF32."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


# ------------------------------------------------------------- launch plan
SMEM_LIMIT = 232_448      # dynamic shared memory one H100 block may have
MAX_CLUSTER = 16          # non-portable thread-block cluster size
WARPS_N = 8               # warps along a band's pixels (and 2 along the channels)
MAX_TILES = 4             # n-tiles of 8 pixels a warp
MAX_BAND_PIXELS = WARPS_N * MAX_TILES * 8
MAX_HIDDEN = 64           # 2 warps × 2 m-tiles of 16 output channels
RING_STAGES = 3
# Clusters an H100 SXM (132 SMs) runs at once with one CTA an SM, by cluster
# size, as cudaOccupancyMaxActiveClusters reports them (chip_smoke.py prints
# it for every plan it runs): a cluster lives inside one GPC, so clusters of
# 3 or more leave SMs idle.
ACTIVE_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 7, 10: 7,
                   11: 7, 12: 7, 13: 7, 14: 7, 15: 7, 16: 7}


def padded_hidden(hidden):
    """The kernel's hidden width: 32 or 64 (2 warps × 1 or 2 m-tiles of 16),
    padded with zero weights."""
    return -(-hidden // 32) * 32


def tiles_per_warp(rows, w):
    """n-tiles of 8 pixels each warp runs for a band of ``rows`` rows."""
    tiles = -(-rows * w // 8)
    return -(-tiles // WARPS_N)


def map_stride(rows, w):
    """Floats per channel of a band map: rows+2 rows (the halos) of W+1
    (one shared zero column), a leading zero, rounded up to 8 floats with
    stride ≡ 8 or 24 (mod 32), so 4 channels × 8 pixels hit 32 banks."""
    s = -(-((rows + 2) * (w + 1) + 1) // 8) * 8
    return s if s % 32 in (8, 24) else s + 8


def smem_bytes(hidden_p, stride, kc):
    """Two band maps (h and t) and a ring of weight chunks, each chunk one
    tap × kc input channels × hidden_p outputs, hi and lo."""
    return 4 * (2 * hidden_p * stride + RING_STAGES * kc * hidden_p * 2)


@dataclass(frozen=True)
class LaunchPlan:
    cluster: int      # CTAs an image, one band of rows each
    rows: int         # rows of the tallest band
    stride: int       # floats a channel of a band map
    hidden: int       # hidden width padded to 32 or 64
    kc: int           # input channels a weight chunk
    smem_bytes: int
    tiles: int        # n-tiles a warp

    def bands(self, h):
        """(first row, rows) of each CTA's band, as the kernel cuts them."""
        starts = [r * h // self.cluster for r in range(self.cluster + 1)]
        return [(a, b - a) for a, b in zip(starts[:-1], starts[1:])]


def _plans(c_in, hidden, h, w):
    """Every plan the kernel can run for this shape, one per band height.
    Weight chunks are 32 input channels deep, or 16 where only that fits
    (hidden 64 at 256-pixel bands, the 64×64 images)."""
    hidden_p = padded_hidden(hidden)
    if hidden < 1 or hidden_p > MAX_HIDDEN or not 1 <= c_in <= hidden_p:
        return
    last_rows = None
    for cluster in range(1, min(MAX_CLUSTER, h) + 1):
        rows = -(-h // cluster)
        # A larger cluster with the same tallest band only adds CTAs.
        if rows * w > MAX_BAND_PIXELS or rows == last_rows:
            continue
        last_rows = rows
        stride, tiles = map_stride(rows, w), tiles_per_warp(rows, w)
        for kc in (32, 16):
            smem = smem_bytes(hidden_p, stride, kc)
            if smem <= SMEM_LIMIT and (kc == 32 or (hidden_p == 64 and tiles == MAX_TILES)):
                yield LaunchPlan(cluster, rows, stride, hidden_p, kc, smem, tiles)
                break


def coupler_kernel_available(c_in, hidden, h, w):
    """Whether the kernel takes a coupler of this shape (any batch): hidden
    width at most 64, C_in at most the padded hidden width, and a band of at
    most 256 pixels whose two maps and weight ring fit 232,448 B of shared
    memory with at most 16 CTAs an image. ``ResNet.forward`` asks this before
    it routes a coupler to the kernel."""
    return next(_plans(c_in, hidden, h, w), None) is not None


def _cost(batch, plan):
    """Relative time of a plan: the waves of clusters the card runs at once,
    times the n-tiles each warp runs plus a fixed part for what a CTA does
    whatever its band (the weight stream, the barriers, the halos). At each
    of the four mnist coupler shapes it picks the plan that ran fastest on
    an H100."""
    waves = -(-batch // ACTIVE_CLUSTERS[plan.cluster])
    return waves * (plan.tiles + 2)


def plan_launch(batch, c_in, hidden, h, w):
    """The launch plan for a call: the cheapest by ``_cost``, ties to the
    smaller cluster."""
    plans = list(_plans(c_in, hidden, h, w))
    if not plans:
        raise ValueError(
            f"coupler_stack kernel has no launch plan for C_in={c_in}, hidden={hidden}, {h}x{w}"
        )
    return min(plans, key=lambda p: (_cost(batch, p), p.cluster))


# --------------------------------------------------------------- CUDA kernel
def _lib():
    from .cuda_build import load_library

    lib = load_library("coupler_stack")
    # Without argtypes ctypes passes a Python int as a 32-bit C int, which
    # cuts a device pointer.
    if lib.cmf_coupler_stack_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cmf_coupler_stack_fwd.argtypes = [p, p, p, p] + [i] * 10 + [p]
        lib.cmf_coupler_stack_fwd.restype = ctypes.c_int
        lib.cmf_coupler_stack_max_clusters.argtypes = [i] * 6 + [ctypes.POINTER(ctypes.c_int)]
        lib.cmf_coupler_stack_max_clusters.restype = ctypes.c_int
    return lib


def max_active_clusters(plan, h, w):
    """How many clusters of ``plan`` for an h×w image the current card holds
    at once (``cudaOccupancyMaxActiveClusters``)."""
    n = ctypes.c_int(0)
    rc = _lib().cmf_coupler_stack_max_clusters(h, w, plan.hidden, plan.cluster, plan.stride,
                                               plan.kc, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with CUDA error {rc}")
    return n.value


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def mma_fragments(w, kc):
    """Hidden×hidden 3×3 weights (n, O, I, 3, 3), O = I a multiple of 16 and
    of kc, → the kernel's weight stream: per conv, per tap, per chunk of kc
    input channels, per k-step of 8, per m-tile of 16 outputs, hi then lo,
    the 32 lanes' A fragments of ``mma.m16n8k8.tf32`` (lane = 4·gid + tig
    holds W[o][k], W[o+8][k], W[o][k+4], W[o+8][k+4] with o = 16·m + gid,
    k = tig)."""
    n, o, i = w.shape[:3]
    t = w.permute(0, 3, 4, 2, 1)  # (n, ky, kx, I, O)
    # I → (chunk, k-step, k+4, tig); O → (m-tile, o+8, gid)
    t = t.reshape(n, 9, i // kc, kc // 8, 2, 4, o // 16, 2, 8)
    t = t.permute(0, 1, 2, 3, 6, 8, 5, 4, 7)  # (n, tap, chunk, k-step, m, gid, tig, k+4, o+8)
    hi, lo = split_tf32(t.contiguous())
    return torch.stack([hi, lo], dim=5).reshape(-1)


def pack_weights(params, c_in, hidden, c_out, device, kc=32):
    """The kernel's two weight buffers, checking every shape on the way.

    ``frags``: the 2K hidden×hidden convs (conv1, conv2 of each block in
    order) as ``mma_fragments``, hidden padded to 32 or 64 with zeros.
    ``small``: conv_in as [C_in][tap][hidden], the 2K biases [2K][hidden],
    the 1×1 conv as [hidden][C_out], its bias, head_w and head_b, fp32 as
    they are (``csrc/coupler_stack.cu``). ``kc`` is the plan's chunk depth,
    32 or 16."""
    hp = padded_hidden(hidden)
    pad = hp - hidden

    def vec(name, v, n):
        _check(name, v, (n,), device)
        return v

    w_in = params["conv_in"]["w"]
    _check("conv_in.w", w_in, (hidden, c_in, 3, 3), device)
    convs, biases = [], []
    for k, bp in enumerate(params["blocks"]):
        for name in ("conv1", "conv2"):
            _check(f"blocks.{k}.{name}.w", bp[name]["w"], (hidden, hidden, 3, 3), device)
            convs.append(bp[name]["w"])
            biases.append(vec(f"blocks.{k}.{name}.b", bp[name]["b"], hidden))
    w_out = params["conv_out"]["w"]
    _check("conv_out.w", w_out, (c_out, hidden, 1, 1), device)
    _check("head_w", params["head_w"], (c_out, 1, 1), device)
    _check("head_b", params["head_b"], (c_out, 1, 1), device)
    b_out = vec("conv_out.b", params["conv_out"]["b"], c_out)

    if convs:
        w = F.pad(torch.stack(convs), (0, 0, 0, 0, 0, pad, 0, pad))
        frags = mma_fragments(w, kc)
        bias = F.pad(torch.stack(biases), (0, pad)).reshape(-1)
    else:
        frags = torch.zeros(4, dtype=torch.float32, device=device)
        bias = torch.zeros(0, dtype=torch.float32, device=device)
    small = torch.cat([
        F.pad(w_in, (0, 0, 0, 0, 0, 0, 0, pad)).permute(1, 2, 3, 0).reshape(-1),
        bias,
        F.pad(w_out[:, :, 0, 0].t(), (0, 0, 0, pad)).reshape(-1),
        b_out,
        params["head_w"].reshape(-1),
        params["head_b"].reshape(-1),
    ])
    return frags.contiguous(), small.contiguous()


# Packed weights of recent parameter sets: sampling calls every coupler with
# the same weights again and again, and packing costs ~0.5 ms of host time.
# An entry holds weak references to the tensors it was packed from and their
# version counters, so a tensor that was freed or changed in place (an
# optimizer step, load_state_dict) misses.
_PACKED = {}
_PACKED_MAX = 64


def _param_tensors(params):
    blocks = [bp[c][k] for bp in params["blocks"] for c in ("conv1", "conv2") for k in ("w", "b")]
    return [params["conv_in"]["w"], *blocks, params["conv_out"]["w"], params["conv_out"]["b"],
            params["head_w"], params["head_b"]]


def packed_weights(params, c_in, hidden, c_out, device, kc):
    """``pack_weights``, from the cache where the same tensors, unchanged,
    were packed before."""
    tensors = _param_tensors(params)
    if any(t.is_inference() for t in tensors):  # no version counter to check
        return pack_weights(params, c_in, hidden, c_out, device, kc)
    key = (str(device), kc, c_in, hidden, c_out, tuple(id(t) for t in tensors))
    versions = tuple(t._version for t in tensors)
    hit = _PACKED.get(key)
    if hit is not None and hit[1] == versions and all(r() is t for r, t in zip(hit[0], tensors)):
        return hit[2]
    for k in [k for k, v in _PACKED.items() if any(r() is None for r in v[0])]:
        del _PACKED[k]
    if len(_PACKED) >= _PACKED_MAX:
        del _PACKED[next(iter(_PACKED))]
    packed = pack_weights(params, c_in, hidden, c_out, device, kc)
    _PACKED[key] = ([weakref.ref(t) for t in tensors], versions, packed)
    return packed


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
    if batch < 1:
        raise ValueError(f"coupler_stack kernel takes B ≥ 1; got B={batch}")
    plan = plan_launch(batch, c_in, hidden, h, w)
    x = x.contiguous()
    frags, small = packed_weights(params, c_in, hidden, c_out, x.device, plan.kc)
    out = torch.empty((batch, c_out, h, w), dtype=torch.float32, device=x.device)
    # A packed buffer that leaves the cache while the kernel is queued is
    # safe: the caching allocator hands its memory only to later work on the
    # same stream, which runs after the kernel.
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cmf_coupler_stack_fwd(
            x.data_ptr(), frags.data_ptr(), small.data_ptr(), out.data_ptr(),
            batch, c_in, h, w, plan.hidden, num_blocks, c_out, plan.cluster, plan.stride,
            plan.kc, stream,
        )
    if rc != 0:
        raise RuntimeError(f"coupler_stack kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out


def fused_resnet_coupler(x, params):
    """Coupler output (B, C_out, H, W), the same function as ``ResNet.apply``
    of the batchnorm-free net. Forward only: it has no derivative rule, so
    callers route only inference through it (``nets/core.py``), and only
    shapes ``coupler_kernel_available`` admits. A tensor that carries a
    forward-mode tangent or sits inside a ``torch.func`` transform (a JVP,
    a vmap) raises on every device, rather than losing its tangent in the
    kernel."""
    global CALLS
    if torch._C._functorch.is_functorch_wrapped_tensor(x) or forward_ad.unpack_dual(x).tangent is not None:
        raise RuntimeError(
            "fused_resnet_coupler has no forward-mode or batching rule: run JVPs and vmaps of a "
            "ResNet coupler outside torch.inference_mode(), where it takes the conv modules"
        )
    CALLS += 1
    if x.is_cuda:
        return coupler_stack_cuda(x, params)
    return coupler_stack_plain(x, params)
