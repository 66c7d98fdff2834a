"""Fused ResNet-coupler forward (``cmf_tpu/ops/pallas/coupler_stack.py`` in
torch).

``fused_resnet_coupler(x, params)`` computes ``ResNet.apply`` of the
batchnorm-free coupler net — bias-free 3×3 ``conv_in``; K × (relu → 3×3
conv+b → relu → 3×3 conv+b, plus the skip); relu → 1×1 conv+b →
``head_w·tanh(·) + head_b`` — from ``params``, the JAX ``ResNet`` params tree
(weights OIHW), on x (B, C_in, H, W) fp32, in either arithmetic of the TPU
kernel: ``bf16=False``, fp32 in, fp32 out, fp32 sums; or ``bf16=True``
(coupler_stack.py:83-147), where every 3×3 conv, ``conv_in`` included, takes
its shifted map and its weight rounded to bf16 and sums the products in
fp32, while the residual stream, the biases, the 1×1 ``conv_out`` and the
head stay fp32.

The kernels are CUDA C++ for Hopper in ``csrc/coupler_stack.cu`` (the source
says which TPU kernel they replace, what bounds them and what their designs
do about it): one thread-block cluster per image, the feature maps in shared
memory, every hidden×hidden 3×3 conv on the tensor cores — in 3×TF32 with
``mma.sync``, or for ``bf16=True`` in one bf16 pass with ``wgmma`` on bf16
maps and weight tiles streamed by bulk copies. This module holds what
surrounds them in Python, where the CPU tests reach it: the launch plans
(``plan_launch``, ``plan_launch_bf16``, and the shape gate
``coupler_kernel_available``), the TF32 split of the weights
(``tf32_round``, ``split_tf32``) and their packing (``pack_weights``:
``mma_fragments`` in mma fragment order, or ``wgmma_tiles`` as the bf16
kernel's A descriptors read them).

Beside it is its plain PyTorch version, ``coupler_stack_plain``, which repeats
the TPU kernel's arithmetic — each 3×3 conv as a sum of 9 shifted,
zero-padded (C_out, C_in) matmuls, with fp32 sums and, for ``bf16=True``,
bf16-rounded operands — and not ``F.conv2d``, so the oracle shares nothing
with cuDNN.

The wrapper dispatches on the tensor's device only: on a CUDA tensor it
launches the kernel or raises; on a CPU tensor it takes the plain version.
``LAUNCHES`` counts kernel launches; ``CALLS`` counts calls on any device, so
a CPU test can see which route a caller took; both count both arithmetics,
and ``BF16_LAUNCHES`` and ``BF16_CALLS`` count the bf16 ones apart.
"""

import ctypes
import weakref
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.autograd import forward_ad

from ..tracing import span

LAUNCHES = 0
CALLS = 0
BF16_LAUNCHES = 0
BF16_CALLS = 0


def reset_launch_counts():
    global LAUNCHES, CALLS, BF16_LAUNCHES, BF16_CALLS
    LAUNCHES = 0
    CALLS = 0
    BF16_LAUNCHES = 0
    BF16_CALLS = 0


def flops(batch, c_in, hidden, c_out, num_blocks, h, w):
    """Multiply-adds ×2 of one coupler call, from the shapes: the 3×3 convs,
    the 1×1 conv and the head's scale-and-shift."""
    p = h * w
    conv33 = 2 * 9 * hidden * p
    per_image = conv33 * c_in + 2 * num_blocks * conv33 * hidden + 2 * hidden * c_out * p + 2 * c_out * p
    return batch * per_image


def tensor_core_flops(batch, hidden, num_blocks, h, w):
    """The part of ``flops`` that the kernel runs on the tensor cores: the
    2K hidden×hidden 3×3 convs. 3×TF32 issues each of them three times,
    bf16 once."""
    return batch * 2 * num_blocks * 2 * 9 * hidden * hidden * h * w


# ------------------------------------------------------------ plain version
def bf16_round(x):
    """fp32 → the nearest bf16 value, ties to even, as fp32 (``astype``)."""
    return x.to(torch.bfloat16).float()


def _conv3x3_taps(h, w, b=None, bf16=False):
    """(B, I, H, W) → (B, O, H, W): Σ over the 9 taps of w[:, :, ky, kx] times
    the map shifted by (ky-1, kx-1), zero outside the image; with ``bf16``
    both operands rounded to bf16 (exact products), fp32 sums."""
    height, width = h.shape[-2:]
    if bf16:
        h, w = bf16_round(h), bf16_round(w)
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


def coupler_stack_plain(x, params, bf16=False):
    h = _conv3x3_taps(x, params["conv_in"]["w"], bf16=bf16)
    for bp in params["blocks"]:
        t = _conv3x3_taps(torch.relu(h), bp["conv1"]["w"], bp["conv1"]["b"], bf16)
        t = _conv3x3_taps(torch.relu(t), bp["conv2"]["w"], bp["conv2"]["b"], bf16)
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
    it routes a coupler to the kernel, in either arithmetic: the bf16 kernel
    has a plan for every shape it admits (``plan_launch_bf16``)."""
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


# ---------------------------------------------------------- bf16 launch plan
# The bf16 kernel: two warpgroups, each on a fixed run of n of the
# band's padded pixels (rows of W+1) with wgmma m64nNk16; n is one of the
# compiled widths (csrc/coupler_stack.cu::CMF_BF16_DISPATCH).
BF16_WIDTHS = (32, 64, 104, 112, 136, 160, 184, 208, 232, 256)
BF16_WARPGROUPS = 2
BF16_MAX_STAGES = 9       # weight ring: one conv's 9 taps
BF16_STAGE_BYTES = 128 * 64  # a tap's 64 × 64 bf16 weight tile
BF16_HEAD_BYTES = 640     # the ring's mbarriers, a zero block, a trash slot
# Fixed part of a CTA's time in pixels, for what a CTA does whatever its
# band (the epilogues' latency, the cluster barriers, conv_in and the head).
BF16_FIXED = 200


def bf16_hidden(hidden):
    """Channels the bf16 kernel's maps hold: the hidden width padded to 16,
    a k-step of its wgmma. Its weight tiles are padded to 64 × 64; a k-step
    past the map's channels reads zeros."""
    return -(-hidden // 16) * 16


def bf16_map_pixels(n, w):
    """Pixels a bf16 map holds: a leading zero, the halo row above, the
    warpgroups' 2n padded pixels, the halo row below and the last tap's reach
    (one pixel), rounded up to 8."""
    return -(-(BF16_WARPGROUPS * n + 2 * (w + 1) + 2) // 8) * 8


def bf16_smem_bytes(c_in, cm, n, map_px, stages):
    """The mbarriers, zero block and trash slot; the ring of weight tiles;
    the bf16 maps H and T (T also holds the bf16 input, C_in channels,
    before conv 0); h in fp32 over the warpgroups' 2n pixels."""
    return (BF16_HEAD_BYTES + stages * BF16_STAGE_BYTES + 2 * cm * map_px + 2 * max(cm, c_in) * map_px
            + 4 * cm * BF16_WARPGROUPS * n)


@dataclass(frozen=True)
class Bf16Plan:
    cluster: int      # CTAs an image, one band of rows each
    rows: int         # rows of the tallest band
    n: int            # padded pixels a warpgroup (its wgmma N)
    map_px: int       # pixels a bf16 map
    cm: int           # channels a map (hidden padded to 16)
    hidden: int       # hidden width padded to 32 or 64 (the small buffer's stride)
    stages: int       # weight ring stages
    smem_bytes: int

    def bands(self, h):
        """(first row, rows) of each CTA's band, as the kernel cuts them."""
        starts = [r * h // self.cluster for r in range(self.cluster + 1)]
        return [(a, b - a) for a, b in zip(starts[:-1], starts[1:])]


def _bf16_plans(c_in, hidden, h, w):
    """Every bf16 plan for this shape, one per band height: the narrowest
    compiled width that covers the band, and the deepest ring that fits."""
    if not coupler_kernel_available(c_in, hidden, h, w):
        return
    cm, hidden_p = bf16_hidden(hidden), padded_hidden(hidden)
    last_rows = None
    for cluster in range(1, min(MAX_CLUSTER, h) + 1):
        rows = -(-h // cluster)
        if rows == last_rows:
            continue
        last_rows = rows
        n = next((n for n in BF16_WIDTHS if BF16_WARPGROUPS * n >= rows * (w + 1)), None)
        if n is None:
            continue
        map_px = bf16_map_pixels(n, w)
        for stages in range(BF16_MAX_STAGES, 1, -1):
            smem = bf16_smem_bytes(c_in, cm, n, map_px, stages)
            if smem <= SMEM_LIMIT:
                yield Bf16Plan(cluster, rows, n, map_px, cm, hidden_p, stages, smem)
                break


def _bf16_cost(batch, plan):
    """Relative time of a bf16 plan: the waves of clusters the card runs at
    once (one CTA an SM), times the pixels a CTA runs plus a fixed part. At
    three of the four mnist coupler shapes it picks the plan that ran
    fastest on an H100 (``tools/coupler_bf16_compare.py --plans``); at B=50,
    2->4 channels, 14x14 cluster 4 ran 6% faster than its pick, cluster 2:
    its small CTAs fit two an SM, which the model does not count."""
    waves = -(-batch // ACTIVE_CLUSTERS[plan.cluster])
    return waves * (BF16_WARPGROUPS * plan.n + BF16_FIXED)


def plan_launch_bf16(batch, c_in, hidden, h, w):
    """The bf16 kernel's launch plan for a call: the cheapest by
    ``_bf16_cost``, ties to the smaller cluster."""
    plans = list(_bf16_plans(c_in, hidden, h, w))
    if not plans:
        raise ValueError(
            f"coupler_stack bf16 kernel has no launch plan for C_in={c_in}, hidden={hidden}, {h}x{w}"
        )
    return min(plans, key=lambda p: (_bf16_cost(batch, p), p.cluster))


# --------------------------------------------------------------- CUDA kernel
def _lib():
    from .cuda_build import load_library

    lib = load_library("coupler_stack")
    # Without argtypes ctypes passes a Python int as a 32-bit C int, which
    # cuts a device pointer.
    if lib.cmf_coupler_stack_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cmf_coupler_stack_fwd.argtypes = [p, p, p, p] + [i] * 10 + [p]
        lib.cmf_coupler_stack_fwd_bf16.argtypes = [p, p, p, p] + [i] * 12 + [p]
        lib.cmf_coupler_stack_max_clusters.argtypes = [i] * 6 + [ctypes.POINTER(ctypes.c_int)]
        lib.cmf_coupler_stack_max_clusters_bf16.argtypes = [i] * 9 + [ctypes.POINTER(ctypes.c_int)]
        for fn in (lib.cmf_coupler_stack_fwd, lib.cmf_coupler_stack_fwd_bf16,
                   lib.cmf_coupler_stack_max_clusters, lib.cmf_coupler_stack_max_clusters_bf16):
            fn.restype = ctypes.c_int
    return lib


def max_active_clusters(plan, h, w, c_in=1):
    """How many clusters of ``plan`` (a ``LaunchPlan`` or a ``Bf16Plan``) for
    an h×w image with c_in channels the current card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    n = ctypes.c_int(0)
    if isinstance(plan, Bf16Plan):
        rc = _lib().cmf_coupler_stack_max_clusters_bf16(c_in, h, w, plan.hidden, plan.cm, plan.cluster,
                                                        plan.n, plan.map_px, plan.stages, ctypes.byref(n))
    else:
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


def wgmma_tiles(w):
    """Hidden×hidden 3×3 weights (n, 64, 64, 3, 3), zero past the hidden
    width, → the bf16 kernel's weight stream: per conv, per tap, one 64 × 64
    A tile as its wgmma descriptor reads it in the no-swizzle K-major layout,
    [channel group of 8][64 outputs][8 channels]: core matrices of 8 outputs
    × 8 channels (128 contiguous bytes), 128 B apart along the outputs and
    1024 B along the channels. Rounded to bf16 to nearest, ties to even."""
    n = w.shape[0]
    t = w.permute(0, 3, 4, 1, 2)  # (n, ky, kx, O, I)
    t = t.reshape(n, 9, 64, 8, 8).permute(0, 1, 3, 2, 4)  # (n, tap, group, O, 8)
    return t.contiguous().to(torch.bfloat16).reshape(-1)


def pack_weights(params, c_in, hidden, c_out, device, kc=32, bf16=False):
    """The kernel's two weight buffers, checking every shape on the way.

    ``frags``: the 2K hidden×hidden convs (conv1, conv2 of each block in
    order) as ``mma_fragments``, hidden padded to 32 or 64 with zeros; or
    with ``bf16`` as ``wgmma_tiles``, both padded to 64. ``small``: conv_in as
    [C_in][tap][hidden] (rounded to bf16 with ``bf16``), the 2K biases
    [2K][hidden], the 1×1 conv as [hidden][C_out], its bias, head_w and
    head_b, fp32 as they are (``csrc/coupler_stack.cu``). ``kc`` is the
    fp32 plan's chunk depth, 32 or 16; the bf16 packing has none."""
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

    if convs and bf16:
        frags = wgmma_tiles(F.pad(torch.stack(convs), (0, 0, 0, 0, 0, 64 - hidden, 0, 64 - hidden)))
    elif convs:
        w = F.pad(torch.stack(convs), (0, 0, 0, 0, 0, pad, 0, pad))
        frags = mma_fragments(w, kc)
    if convs:
        bias = F.pad(torch.stack(biases), (0, pad)).reshape(-1)
    else:
        frags = torch.zeros(8 if bf16 else 4, dtype=torch.bfloat16 if bf16 else torch.float32, device=device)
        bias = torch.zeros(0, dtype=torch.float32, device=device)
    if bf16:
        w_in = bf16_round(w_in)
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


def packed_weights(params, c_in, hidden, c_out, device, kc=32, bf16=False):
    """``pack_weights``, from the cache where the same tensors, unchanged,
    were packed before in the same arithmetic (the bf16 packing under a key
    of its own, whatever ``kc``)."""
    tensors = _param_tensors(params)
    if any(t.is_inference() for t in tensors):  # no version counter to check
        return pack_weights(params, c_in, hidden, c_out, device, kc, bf16)
    packing = "wgmma_tiles" if bf16 else ("mma_fragments", kc)
    key = (str(device), packing, c_in, hidden, c_out, tuple(id(t) for t in tensors))
    versions = tuple(t._version for t in tensors)
    hit = _PACKED.get(key)
    if hit is not None and hit[1] == versions and all(r() is t for r, t in zip(hit[0], tensors)):
        return hit[2]
    for k in [k for k, v in _PACKED.items() if any(r() is None for r in v[0])]:
        del _PACKED[k]
    if len(_PACKED) >= _PACKED_MAX:
        del _PACKED[next(iter(_PACKED))]
    packed = pack_weights(params, c_in, hidden, c_out, device, kc, bf16)
    _PACKED[key] = ([weakref.ref(t) for t in tensors], versions, packed)
    return packed


def coupler_stack_cuda(x, params, bf16=False):
    """The kernel: x (B, C_in, H, W) CUDA fp32 → (B, C_out, H, W), in the
    bf16 variant's arithmetic with ``bf16``."""
    global LAUNCHES, BF16_LAUNCHES
    with span("ops/coupler_stack"):
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
        if bf16:
            plan = plan_launch_bf16(batch, c_in, hidden, h, w)
            geometry = (plan.cm, num_blocks, c_out, plan.cluster, plan.n, plan.map_px, plan.stages)
            kc = 32
        else:
            plan = plan_launch(batch, c_in, hidden, h, w)
            geometry = (num_blocks, c_out, plan.cluster, plan.stride, plan.kc)
            kc = plan.kc
        x = x.contiguous()
        frags, small = packed_weights(params, c_in, hidden, c_out, x.device, kc, bf16)
        out = torch.empty((batch, c_out, h, w), dtype=torch.float32, device=x.device)
        # A packed buffer that leaves the cache while the kernel is queued is
        # safe: the caching allocator hands its memory only to later work on the
        # same stream, which runs after the kernel.
        lib = _lib()
        entry = lib.cmf_coupler_stack_fwd_bf16 if bf16 else lib.cmf_coupler_stack_fwd
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = entry(x.data_ptr(), frags.data_ptr(), small.data_ptr(), out.data_ptr(),
                       batch, c_in, h, w, plan.hidden, *geometry, stream)
        if rc != 0:
            raise RuntimeError(f"coupler_stack kernel launch failed with CUDA error {rc}")
        LAUNCHES += 1
        BF16_LAUNCHES += bool(bf16)
        return out


def fused_resnet_coupler(x, params, bf16=False):
    """Coupler output (B, C_out, H, W), the same function as ``ResNet.apply``
    of the batchnorm-free net, in the TPU kernel's bf16 arithmetic with
    ``bf16`` (``ResNet.forward`` passes the compute-dtype policy). Forward
    only: it has no derivative rule, so
    callers route only inference through it (``nets/core.py``), and only
    shapes ``coupler_kernel_available`` admits. A tensor that carries a
    forward-mode tangent or sits inside a ``torch.func`` transform (a JVP,
    a vmap) raises on every device, rather than losing its tangent in the
    kernel."""
    global CALLS, BF16_CALLS
    if torch._C._functorch.is_functorch_wrapped_tensor(x) or forward_ad.unpack_dual(x).tangent is not None:
        raise RuntimeError(
            "fused_resnet_coupler has no forward-mode or batching rule: run JVPs and vmaps of a "
            "ResNet coupler outside torch.inference_mode(), where it takes the conv modules"
        )
    CALLS += 1
    BF16_CALLS += bool(bf16)
    if x.is_cuda:
        return coupler_stack_cuda(x, params, bf16)
    return coupler_stack_plain(x, params, bf16)
