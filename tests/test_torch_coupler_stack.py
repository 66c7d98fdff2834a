"""The coupler-stack kernel's plain version (``cmf_tpu_torch/ops/
coupler_stack.py``) against the JAX package's ``fused_resnet_coupler`` in
interpret mode and against JAX ``ResNet.apply``; the port's ``ResNet`` module
against JAX; and the route ``ResNet.forward`` takes: the fused coupler under
``torch.inference_mode()`` (the sampling path), the conv modules elsewhere,
inside ``torch.func.jvp`` above all; the shape gate, the launch plan at every
image coupler's shape, the TF32 rounding, the weight packing, and the
kernel's 3×TF32 arithmetic emulated on the CPU. The CUDA kernel itself runs
only on the card: ``chip_smoke.py`` holds it against this plain version
there."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cmf_tpu.nets import ResNet as JaxResNet
from cmf_tpu.ops.pallas.coupler_stack import fused_resnet_coupler as jax_fused_resnet_coupler
from cmf_tpu_torch.config.config import get_config
from cmf_tpu_torch.config.schemas import get_schema
from cmf_tpu_torch.data.image import DATASET_SHAPES
from cmf_tpu_torch.interop import variables_from_jax
from cmf_tpu_torch.models import get_density
from cmf_tpu_torch.nets import ResNet, compute_dtype
from cmf_tpu_torch.ops import coupler_stack as cs

from _torch_parity import t, to_numpy

# The JAX package's own tolerance for its kernel against ResNet.apply
# (tests/test_ops.py:312-335): fp32, sums in another order.
TOL = 2e-5

# (C_in, C_out, H=W, blocks, batch) of tests/test_ops.py:324, hidden 16: the
# 28×28 checkerboard and the 14×14 post-squeeze geometries.
GEOMETRIES = [(1, 2, 28, 2, 6), (4, 8, 14, 3, 5)]
IDS = ["28x28", "14x14"]


def _pair(c_in, c_out, hw, blocks, batch, seed=0):
    """JAX ResNet variables (head perturbed off its ones / zeros), the port's
    ResNet with the same weights, and an input."""
    net = JaxResNet(c_in, [16] * blocks, c_out, use_batchnorm=False)
    variables = to_numpy(net.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    variables["params"]["head_w"] = rng.normal(size=(c_out, 1, 1)).astype(np.float32)
    variables["params"]["head_b"] = rng.normal(size=(c_out, 1, 1)).astype(np.float32)
    port = ResNet(c_in, [16] * blocks, c_out)
    variables_from_jax(port, variables)
    x = rng.normal(size=(batch, c_in, hw, hw)).astype(np.float32)
    return net, variables, port, x


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=IDS)
def test_plain_matches_jax_kernel_in_interpret_mode(geometry, bf16):
    """Both arithmetics of the TPU kernel: with ``bf16`` both packages round
    the same operands (the shifted map and the weights of every 3×3 conv)
    and sum exact products in fp32, so they stay within the fp32 tolerance,
    more than ten times closer than bf16 is to fp32 here."""
    _, variables, port, x = _pair(*geometry)
    want = jax_fused_resnet_coupler(jnp.asarray(x), variables["params"], num_blocks=geometry[3],
                                    interpret=True, bf16=bf16)
    with torch.no_grad():
        got = cs.coupler_stack_plain(t(x), port.kernel_params(), bf16=bf16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    if bf16:
        with torch.no_grad():
            fp32 = cs.coupler_stack_plain(t(x), port.kernel_params())
        assert np.abs(fp32.numpy() - np.asarray(want)).max() > 10 * TOL


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=IDS)
def test_plain_and_module_match_jax_resnet_apply(geometry):
    net, variables, port, x = _pair(*geometry, seed=1)
    want, _ = net.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        plain = cs.coupler_stack_plain(t(x), port.kernel_params())
        module = port(t(x))
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(module.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_inference_mode_routes_through_the_fused_coupler():
    _, _, port, x = _pair(*GEOMETRIES[1], seed=2)
    x = t(x)
    cs.reset_launch_counts()
    with torch.no_grad():
        conv = port(x)
    assert cs.CALLS == 0
    with torch.inference_mode():
        fused = port(x)
    # On a CPU tensor the wrapper takes the plain version: routed, not launched.
    assert (cs.CALLS, cs.LAUNCHES) == (1, 0)
    np.testing.assert_allclose(fused.numpy(), conv.numpy(), rtol=TOL, atol=TOL)


def test_inference_mode_passes_the_compute_dtype_policy():
    """Under the bf16 policy the sampling route takes the kernel's bf16
    arithmetic; the conv modules under the same policy (cuDNN's bf16 convs
    where there is a card) round each conv's output to bf16 besides, as
    ``ResNet.apply`` does, so the two agree only to bf16's precision."""
    _, _, port, x = _pair(*GEOMETRIES[1], seed=6)
    x = t(x)
    cs.reset_launch_counts()
    with compute_dtype("bfloat16"):
        with torch.inference_mode():
            fused = port(x)
        with torch.no_grad():
            conv = port(x)
    assert (cs.CALLS, cs.BF16_CALLS, cs.LAUNCHES, cs.BF16_LAUNCHES) == (1, 1, 0, 0)
    with torch.no_grad():
        plain = cs.coupler_stack_plain(x, port.kernel_params(), bf16=True)
        fp32 = port(x)
    np.testing.assert_array_equal(fused.numpy(), plain.numpy())
    scale = float(fp32.abs().max())
    assert float((fused - fp32).abs().max()) > 10 * TOL * scale
    assert float((conv - fused).abs().max()) < 2e-2 * scale
    with torch.inference_mode():
        port(x)
    assert (cs.CALLS, cs.BF16_CALLS) == (2, 1)


def test_func_jvp_never_reaches_the_forward_only_kernel():
    """The Hutchinson solve's matvecs run without a graph but inside
    torch.func transforms, which turn inference mode off: even called under
    torch.inference_mode() the JVP takes the conv modules."""
    _, _, port, x = _pair(*GEOMETRIES[1], seed=3)
    x, v = t(x), torch.ones(x.shape)
    cs.reset_launch_counts()
    with torch.inference_mode():
        _, tangent = torch.func.jvp(port, (x,), (v,))
    assert cs.CALLS == 0
    with torch.no_grad():
        _, want = torch.func.jvp(port, (x,), (v,))
    np.testing.assert_array_equal(tangent.numpy(), want.numpy())


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    _, _, port, x = _pair(*GEOMETRIES[1], seed=4)
    with torch.no_grad():
        params = port.kernel_params()
        with pytest.raises(ValueError, match="CUDA tensor"):
            cs.coupler_stack_cuda(t(x), params)
        with pytest.raises(ValueError, match="shape"):
            cs.pack_weights(params, c_in=3, hidden=16, c_out=8, device=torch.device("cpu"))
    assert cs.LAUNCHES == 0


def _unpack_fragments(frags, n, hidden_p, kc):
    """W_hi, W_lo (n, O, I, 9) read out of ``frags`` lane by lane, as the
    kernel's A-fragment loads read them: per conv, tap, chunk, k-step,
    m-tile and hi/lo, lane 4·gid + tig holds W[o][k], W[o+8][k], W[o][k+4],
    W[o+8][k+4] with o = 16·m + gid, k = tig."""
    mt = hidden_p // 16
    shape = (n, 9, hidden_p // kc, kc // 8, mt, 2, 32, 4)
    c, tap, cb, ks, m, hl, lane, e = np.indices(shape).reshape(len(shape), -1)
    gid, tig = lane >> 2, lane & 3
    o = 16 * m + gid + 8 * (e & 1)
    i = cb * kc + ks * 8 + tig + 4 * (e >> 1)
    out = np.zeros((2, n, hidden_p, hidden_p, 9), np.float32)
    out[hl, c, o, i, tap] = frags.reshape(-1)
    return out[0], out[1]


def test_pack_weights_layout():
    """``frags``: the 2K hidden×hidden convs split hi/lo TF32 in mma
    fragment order, which sums back to the weights; ``small``: conv_in as
    [input][tap][output], the biases, the 1×1 conv as [input][output] and
    the head, hidden padded to 32 or 64."""
    _, _, port, _ = _pair(*GEOMETRIES[1], seed=5)  # C_in 4, hidden 16 (32 padded), C_out 8, 3 blocks
    hp = 32
    with torch.no_grad():
        params = port.kernel_params()
        frags, small = cs.pack_weights(params, c_in=4, hidden=16, c_out=8, device=torch.device("cpu"))
    n = 2 * 3
    assert frags.numel() == n * 9 * hp * hp * 2
    w_hi, w_lo = _unpack_fragments(frags.numpy(), n, hp, 32)
    w = np.stack([params["blocks"][k][c]["w"].detach().numpy() for k in range(3) for c in ("conv1", "conv2")])
    w = w.reshape(n, 16, 16, 9)
    np.testing.assert_array_equal(w_hi[:, :16, :16], cs.tf32_round(torch.from_numpy(w)).numpy())
    np.testing.assert_allclose(w_hi[:, :16, :16] + w_lo[:, :16, :16], w, rtol=0,
                               atol=2.0**-22 * np.abs(w).max())
    # The first lane's a1 of block 0's conv1, tap 4, is W[o=8][i=0][ky=1][kx=1]:
    # chunk (conv 0, tap 4) of 32 × 32 × 2 floats, k-step 0, m-tile 0, hi, lane 0.
    first = 4 * 32 * hp * 2
    assert frags[first + 1] == cs.tf32_round(params["blocks"][0]["conv1"]["w"][8, 0, 1, 1])
    w_in = params["conv_in"]["w"]  # (16, 4, 3, 3)
    assert small.numel() == 4 * 9 * hp + n * hp + hp * 8 + 3 * 8
    # w_in[o=5, i=2, ky=1, kx=0] sits at [i=2][tap=3][o=5].
    assert small[(2 * 9 + 3) * hp + 5] == w_in[5, 2, 1, 0]
    # conv2's bias of block 1 is bias row 3.
    assert small[4 * 9 * hp + 3 * hp + 7] == params["blocks"][1]["conv2"]["b"][7]
    w_out = params["conv_out"]["w"]  # (8, 16, 1, 1)
    start = small.numel() - 3 * 8 - hp * 8
    assert small[start + 7 * 8 + 3] == w_out[3, 7, 0, 0]


def _unpack_bf16_fragments(frags, n, hidden_p, kc):
    """W (n, O, I, 9) read out of the bf16 variant's ``frags`` lane by lane,
    as its A-fragment loads read them: per conv, tap, chunk, k-step of 16,
    m-tile, lane 4·gid + tig holds registers q = 2r + q8 of two bf16 each,
    j = 0 in the low half: W[o][i] with o = 16·m + gid + 8·q8 and
    i = 16·ks + 8r + tig + 4j."""
    mt = hidden_p // 16
    shape = (n, 9, hidden_p // kc, kc // 16, mt, 32, 2, 2, 2)
    c, tap, cb, ks, m, lane, r, q8, j = np.indices(shape).reshape(len(shape), -1)
    gid, tig = lane >> 2, lane & 3
    o = 16 * m + gid + 8 * q8
    i = cb * kc + ks * 16 + 8 * r + tig + 4 * j
    out = np.zeros((n, hidden_p, hidden_p, 9), np.float32)
    out[c, o, i, tap] = frags.reshape(-1)
    return out


@pytest.mark.parametrize("kc", [32, 16])
def test_pack_weights_bf16_layout(kc):
    """The bf16 variant's ``frags``: the 2K hidden×hidden convs rounded to
    bf16, to nearest and ties to even, in m16n8k16 fragment order, hidden
    padded to 32 or 64; ``small``: conv_in rounded the same way, the rest
    fp32 as in the TF32 packing."""
    c_in, hidden, c_out, blocks = 4, 40, 8, 2  # hidden 40 pads to 64: two m-tiles a warp
    net = ResNet(c_in, [hidden] * blocks, c_out, generator=torch.Generator().manual_seed(8))
    hp, n = 64, 2 * blocks
    with torch.no_grad():
        params = net.kernel_params()
        frags, small = cs.pack_weights(params, c_in, hidden, c_out, torch.device("cpu"), kc, bf16=True)
        _, small32 = cs.pack_weights(params, c_in, hidden, c_out, torch.device("cpu"), kc)
    assert frags.dtype == torch.bfloat16 and frags.numel() == n * 9 * hp * hp
    w_got = _unpack_bf16_fragments(frags.float().numpy(), n, hp, kc)
    w = torch.stack([params["blocks"][k][c]["w"].detach() for k in range(blocks) for c in ("conv1", "conv2")])
    w = w.reshape(n, hidden, hidden, 9)
    np.testing.assert_array_equal(w_got[:, :hidden, :hidden], cs.bf16_round(w).numpy())
    assert not w_got[:, hidden:].any() and not w_got[:, :, hidden:].any()
    n_in = c_in * 9 * hp
    w_in = small32[:n_in]
    np.testing.assert_array_equal(small[:n_in].numpy(), cs.bf16_round(w_in).numpy())
    assert not torch.equal(small[:n_in], w_in)
    np.testing.assert_array_equal(small[n_in:].numpy(), small32[n_in:].numpy())
    # bf16 rounds ties to even: 1 + 2^-8 lies halfway between 1 and 1 + 2^-7.
    assert float(cs.bf16_round(torch.tensor([1 + 2.0**-8]))) == 1.0
    assert float(cs.bf16_round(torch.tensor([1 + 3 * 2.0**-8]))) == 1 + 2.0**-6


def _emulate_bf16_kernel(x, params, c_in, hidden, c_out, kc=32):
    """The bf16 variant's arithmetic on the CPU, from its packed buffers:
    the input and conv_in's weights rounded to bf16, each hidden×hidden conv
    on bf16-rounded relu maps and fragment weights, fp32 sums and residual;
    the 1×1 conv and the head in fp32."""
    hp = cs.padded_hidden(hidden)
    n = 2 * len(params["blocks"])
    frags, small = cs.pack_weights(params, c_in, hidden, c_out, torch.device("cpu"), kc, bf16=True)
    w = torch.from_numpy(_unpack_bf16_fragments(frags.float().numpy(), n, hp, kc))
    w = w.reshape(n, hp, hp, 3, 3)
    w_in = small[: c_in * 9 * hp].reshape(c_in, 9, hp).permute(2, 0, 1).reshape(hp, c_in, 3, 3)
    rest = small[c_in * 9 * hp :]
    bias, rest = rest[: n * hp].reshape(n, hp), rest[n * hp :]
    w_out, rest = rest[: hp * c_out].reshape(hp, c_out), rest[hp * c_out :]
    b_out, head_w, head_b = rest.reshape(3, c_out)
    h = cs._conv3x3_taps(cs.bf16_round(x), w_in)
    for k in range(n // 2):
        t_ = cs._conv3x3_taps(cs.bf16_round(torch.relu(h)), w[2 * k], bias[2 * k])
        h = h + cs._conv3x3_taps(cs.bf16_round(torch.relu(t_)), w[2 * k + 1], bias[2 * k + 1])
    y = torch.einsum("io,bihw->bohw", w_out, torch.relu(h)) + b_out[None, :, None, None]
    return head_w[None, :, None, None] * torch.tanh(y) + head_b[None, :, None, None]


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=IDS)
def test_bf16_emulation_matches_plain(geometry):
    """The bf16 variant's packed buffers, read as the kernel reads them,
    give the plain bf16 version within the fp32 tolerance."""
    c_in, c_out, hw, blocks, batch = geometry
    gen = torch.Generator().manual_seed(9)
    net = ResNet(c_in, [16] * blocks, c_out, generator=gen)
    with torch.no_grad():
        x = torch.randn((batch, c_in, hw, hw), generator=gen)
        params = net.kernel_params()
        ref = cs.coupler_stack_plain(x, params, bf16=True)
        got = _emulate_bf16_kernel(x, params, c_in, 16, c_out)
    assert float((got - ref).abs().max()) <= TOL * float(ref.abs().max())


def test_pack_weights_pads_the_hidden_width():
    """A hidden width below 32 (or between 32 and 64) gets zero weights and
    biases for the padded channels."""
    c_in, hidden, c_out = 3, 10, 4
    net = ResNet(c_in, [hidden] * 2, c_out, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        frags, small = cs.pack_weights(net.kernel_params(), c_in, hidden, c_out, torch.device("cpu"))
    hp = 32
    w_hi, w_lo = _unpack_fragments(frags.numpy(), 4, hp, 32)
    assert not w_hi[:, hidden:].any() and not w_hi[:, :, hidden:].any() and not w_lo[:, hidden:].any()
    assert np.abs(w_hi[:, :hidden, :hidden]).max() > 0
    w_in = small[: c_in * 9 * hp].reshape(c_in, 9, hp)
    assert not w_in[:, :, hidden:].any()
    bias = small[c_in * 9 * hp : c_in * 9 * hp + 4 * hp].reshape(4, hp)
    assert not bias[:, hidden:].any() and bias[:, :hidden].abs().max() > 0


def test_packed_weights_are_cached_until_a_tensor_changes():
    """The wrapper packs a parameter set once and reuses it while the same
    tensors stay unchanged; an in-place update or a freed module misses."""
    dev = torch.device("cpu")

    def pack(net):
        with torch.no_grad():
            return cs.packed_weights(net.kernel_params(), 2, 16, 4, dev, 32)

    net = ResNet(2, [16] * 2, 4, generator=torch.Generator().manual_seed(0))
    first = pack(net)
    again = pack(net)
    assert again is first
    with torch.no_grad():
        net.blocks[1].conv2.b.add_(1.0)
    second = pack(net)
    assert second is not first
    np.testing.assert_array_equal(second[0].numpy(), first[0].numpy())  # the convs are unchanged
    assert not torch.equal(second[1], first[1])  # the bias moved
    with torch.no_grad():
        want = cs.pack_weights(net.kernel_params(), 2, 16, 4, dev, 32)
    assert all(torch.equal(a, b) for a, b in zip(second, want))
    del net
    gc.collect()
    other = ResNet(2, [16], 4, generator=torch.Generator().manual_seed(1))
    pack(other)
    # The freed module's entry went with the next miss; the live one stays.
    assert all(r() is not None for refs, _, _ in cs._PACKED.values() for r in refs)
    assert pack(other) is pack(other)


def test_packed_weights_cache_the_bf16_packing_apart():
    """The bf16 packing has its own cache entry beside the TF32 one: each
    arithmetic gets its own buffers, each reused while the tensors stay."""
    dev = torch.device("cpu")
    net = ResNet(2, [16] * 2, 4, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        params = net.kernel_params()
        tf32 = cs.packed_weights(params, 2, 16, 4, dev, 32)
        bf16 = cs.packed_weights(params, 2, 16, 4, dev, 32, bf16=True)
        assert bf16 is not tf32 and bf16[0].dtype == torch.bfloat16 and tf32[0].dtype == torch.float32
        assert cs.packed_weights(params, 2, 16, 4, dev, 32, bf16=True) is bf16
        assert cs.packed_weights(params, 2, 16, 4, dev, 32) is tf32
        net.conv_in.w.mul_(2.0)
        again = cs.packed_weights(params, 2, 16, 4, dev, 32, bf16=True)
    assert again is not bf16 and torch.equal(again[0], bf16[0]) and not torch.equal(again[1], bf16[1])


# cvt.rna.tf32.f32 on fp32 bit patterns: round to 10 mantissa bits, nearest,
# ties away from zero (PTX ISA, cvt).
TF32_PATTERNS = [
    (0x3F800000, 0x3F800000),  # 1.0 is TF32
    (0x3F800FFF, 0x3F800000),  # below half an ulp: down
    (0x3F801000, 0x3F802000),  # a tie with an even kept bit: away from zero (not to even)
    (0x3F803000, 0x3F804000),  # a tie with an odd kept bit: away from zero
    (0xBF801000, 0xBF802000),  # a negative tie: away from zero
    (0x3F801001, 0x3F802000),  # above half an ulp: up
    (0x3FFFF000, 0x40000000),  # a carry into the exponent
    (0x00000FFF, 0x00000000),  # subnormal below half an ulp
    (0x00001000, 0x00002000),  # subnormal tie
    (0x807FF000, 0x80800000),  # the largest subnormals round to the smallest normal
    (0x00000000, 0x00000000),  # +0
    (0x80000000, 0x80000000),  # -0
    (0x7F800000, 0x7F800000),  # +inf
    (0xFF800000, 0xFF800000),  # -inf
    (0x7F7FF000, 0x7F800000),  # past the largest TF32: inf
]


@pytest.mark.parametrize("bits,want", TF32_PATTERNS, ids=[f"{b:08x}" for b, _ in TF32_PATTERNS])
def test_tf32_round_matches_cvt_rna(bits, want):
    x = torch.tensor([bits], dtype=torch.int64)
    x = torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).view(torch.float32)
    got = int(cs.tf32_round(x).view(torch.int32)[0]) & 0xFFFFFFFF
    assert got == want, f"{bits:08x} -> {got:08x}, want {want:08x}"


def test_tf32_round_keeps_nan_and_matches_float64_rounding():
    assert torch.isnan(cs.tf32_round(torch.tensor([float("nan")]))).all()
    rng = np.random.default_rng(0)
    x = (rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, 4096)).astype(np.float32)
    x64 = x.astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(x64))) - 10)
    want = np.sign(x64) * np.floor(np.abs(x64) / ulp + 0.5) * ulp
    got = cs.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.astype(np.float64), want)
    hi, lo = cs.split_tf32(torch.from_numpy(x))
    np.testing.assert_array_equal(cs.tf32_round(lo).numpy(), lo.numpy())
    np.testing.assert_allclose((hi.double() + lo.double()).numpy(), x64, rtol=2.0**-21, atol=0)


def _emulate_kernel(x, params, c_in, hidden, c_out, kc=32):
    """The kernel's arithmetic on the CPU, from its packed buffers: conv_in
    and the head in fp32, each hidden×hidden 3×3 conv in 3×TF32 —
    Σ_tap W_lo·X_hi + W_hi·X_lo + W_hi·X_hi with X = relu of the map, split
    as cvt.rna splits it, fp32 sums."""
    hp = cs.padded_hidden(hidden)
    n = 2 * len(params["blocks"])
    frags, small = cs.pack_weights(params, c_in, hidden, c_out, torch.device("cpu"), kc)
    w_hi, w_lo = (torch.from_numpy(w) for w in _unpack_fragments(frags.numpy(), n, hp, kc))
    w_in = small[: c_in * 9 * hp].reshape(c_in, 9, hp).permute(2, 0, 1).reshape(hp, c_in, 3, 3)
    rest = small[c_in * 9 * hp :]
    bias, rest = rest[: n * hp].reshape(n, hp), rest[n * hp :]
    w_out, rest = rest[: hp * c_out].reshape(hp, c_out), rest[hp * c_out :]
    b_out, head_w, head_b = rest.reshape(3, c_out)
    height, width = x.shape[-2:]

    def taps(m):
        padded = F.pad(m, (1, 1, 1, 1))
        return [padded[:, :, ky : ky + height, kx : kx + width] for ky in range(3) for kx in range(3)]

    h = cs._conv3x3_taps(x, w_in)
    for k in range(n // 2):
        for c in (2 * k, 2 * k + 1):
            src = torch.relu(h if c % 2 == 0 else t)
            acc = 0
            for tap, xs in enumerate(taps(src)):
                x_hi, x_lo = cs.split_tf32(xs)
                for a, b in ((w_lo, x_hi), (w_hi, x_lo), (w_hi, x_hi)):
                    acc = acc + torch.einsum("oi,bihw->bohw", a[c, :, :, tap], b)
            out = acc + bias[c][None, :, None, None]
            if c % 2 == 0:
                t = out
            else:
                h = h + out
    y = torch.einsum("io,bihw->bohw", w_out, torch.relu(h)) + b_out[None, :, None, None]
    return head_w[None, :, None, None] * torch.tanh(y) + head_b[None, :, None, None]


# chip_smoke.py's COUPLER_TOL: the kernel against its plain version, max
# |err| / max |ref|.
COUPLER_TOL = 1e-4


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=IDS)
def test_3xtf32_emulation_matches_plain(geometry):
    """3×TF32 on the kernel's packed weights stays within the kernel's
    tolerance of the fp32 plain version at hidden 16, with weights drawn as
    chip_smoke.py draws them; single-pass TF32 on the same data does not
    come as close."""
    c_in, c_out, hw, blocks, batch = geometry
    gen = torch.Generator().manual_seed(7)
    net = ResNet(c_in, [16] * blocks, c_out, generator=gen)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
        x = torch.randn((batch, c_in, hw, hw), generator=gen)
        params = net.kernel_params()
        ref = cs.coupler_stack_plain(x, params)
        got = _emulate_kernel(x, params, c_in, 16, c_out)
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        assert err <= COUPLER_TOL, err
        single = {
            "conv_in": params["conv_in"],
            "blocks": [{c: {"w": cs.tf32_round(bp[c]["w"]), "b": bp[c]["b"]} for c in bp}
                       for bp in params["blocks"]],
            **{k: params[k] for k in ("conv_out", "head_w", "head_b")},
        }
        one_pass = cs.coupler_stack_plain(x, single)
        assert float((one_pass - ref).abs().max()) > 10 * float((got - ref).abs().max())


def _image_couplers(dataset):
    """(C_in, hidden, H, W) of every ResNet coupler the factory builds for
    the dataset at full width: the non-square schema, and the realnvp
    schema (baseline, 8 blocks) with its ResNets built batchnorm-free — the
    kernel route takes no batch-norm ResNet."""
    c, h, w = DATASET_SHAPES[dataset][:3]
    shapes = set()
    for model, baseline, overrides in (("non-square", False, {}),
                                       ("realnvp", True, {"resnet_batchnorm": False})):
        config = {**get_config(dataset, model, baseline), **overrides}
        density = get_density(get_schema(config), (c, h, w), "cpu", torch.Generator().manual_seed(0))
        for m in density.modules():
            if hasattr(m, "coupler") and hasattr(m, "x_shape"):
                for net in m.coupler.modules():
                    if isinstance(net, ResNet):
                        shapes.add((net.conv_in.w.shape[1], net.c_hidden, *m.x_shape[1:]))
    return sorted(shapes)


@pytest.mark.parametrize("dataset", sorted(DATASET_SHAPES))
def test_launch_plan_covers_every_image_coupler(dataset):
    """Every coupler shape of the six image datasets has a plan at the
    batches the port calls it with: its bands tile the image rows exactly,
    its shared memory fits 232,448 B, its cluster is legal, its map stride
    holds a band with its halos and avoids bank conflicts."""
    couplers = _image_couplers(dataset)
    assert len(couplers) == 2, couplers  # full-size and squeezed
    for c_in, hidden, h, w in couplers:
        assert cs.coupler_kernel_available(c_in, hidden, h, w), (dataset, c_in, hidden, h, w)
        for batch in (1, 8, 50, 64, 250):
            plan = cs.plan_launch(batch, c_in, hidden, h, w)
            bands = plan.bands(h)
            assert bands[0][0] == 0 and sum(r for _, r in bands) == h
            assert all(a + r == b for (a, r), (b, _) in zip(bands, bands[1:]))
            assert min(r for _, r in bands) >= 1 and max(r for _, r in bands) == plan.rows
            assert plan.rows * w <= cs.MAX_BAND_PIXELS
            assert 1 <= plan.cluster <= min(16, h)
            assert plan.stride >= (plan.rows + 2) * (w + 1) + 1 and plan.stride % 32 in (8, 24)
            assert plan.hidden in (32, 64) and plan.hidden >= hidden and plan.kc in (16, 32)
            assert 1 <= plan.tiles <= 4 and plan.tiles * 8 * 8 >= plan.rows * w
            assert plan.smem_bytes == cs.smem_bytes(plan.hidden, plan.stride, plan.kc)
            assert plan.smem_bytes <= 232_448


def test_gate_sends_what_the_kernel_cannot_take_to_the_conv_modules():
    """Shapes outside the kernel — hidden above 64, C_in above the padded
    hidden width, rows wider than a band — take F.conv2d even under
    inference mode; the wrapper has no plan for them."""
    assert cs.coupler_kernel_available(1, 64, 28, 28)
    assert cs.coupler_kernel_available(12, 8, 7, 7)  # hidden 8 pads to 32 ≥ C_in
    assert not cs.coupler_kernel_available(1, 80, 28, 28)
    assert not cs.coupler_kernel_available(33, 16, 8, 8)
    assert not cs.coupler_kernel_available(1, 16, 4, 300)
    with pytest.raises(ValueError, match="no launch plan"):
        cs.plan_launch(1, 1, 80, 28, 28)
    # A band is at most 256 pixels: 28-pixel rows take 4 CTAs or more.
    assert min(p.cluster for p in cs._plans(1, 64, 28, 28)) == 4
    net = ResNet(33, [16], 2, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 33, 8, 8)
    cs.reset_launch_counts()
    with torch.inference_mode():
        got = net(x)
    assert cs.CALLS == 0
    with torch.no_grad():
        np.testing.assert_array_equal(got.numpy(), net(x).numpy())


def test_flops_of_the_mnist_couplers():
    """The operation counts that set the kernel's bound: about 926 MFLOP an
    image at 28×28 (1→2 channels) and 232 MFLOP at 14×14 (2→4), hidden 64,
    8 blocks."""
    assert abs(cs.flops(1, 1, 64, 2, 8, 28, 28) - 926e6) < 1e6
    assert abs(cs.flops(1, 2, 64, 4, 8, 14, 14) - 232e6) < 1e6
    assert cs.flops(50, 1, 64, 2, 8, 28, 28) == 50 * cs.flops(1, 1, 64, 2, 8, 28, 28)
