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

import functools
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

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's CPU emulations run thousands of small torch ops. Where the
    suite's workers share the cores, a multi-threaded op waits milliseconds
    at its thread barrier: ~100× slower than on one thread. Restored after
    the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# The bf16 kernel's operands as its wgmma descriptors address them
# (csrc/coupler_stack.cu::gmma_desc, conv_gmma): shared memory is modelled as
# an array of 16-byte units of 8 bf16 values, one array for the weight ring's
# stage and one for each map, each at address 0.
A_LBO, A_SBO = 1024, 128  # a weight tile: 8 outputs of 8 channels a core matrix


def _gmma_desc(addr, lbo, sbo):
    """The 64-bit no-swizzle descriptor of csrc's ``gmma_desc``: start, LBO and
    SBO in 16-byte units in bits 0-13, 16-29 and 32-45."""
    return ((addr & 0x3FFFF) >> 4) | (((lbo & 0x3FFFF) >> 4) << 16) | (((sbo & 0x3FFFF) >> 4) << 32)


def _read_k_major(units, desc, rows, swap=False):
    """The (rows × 16) K-major operand a no-swizzle descriptor addresses in
    ``units`` (..., 16-byte units, 8): row r, column k at unit start +
    (r // 8)·SBO + r % 8 + (k // 8)·LBO, element k % 8. ``swap`` reads it
    with LBO and SBO exchanged."""
    assert desc >> 46 == 0  # base offset 0, layout type 0 (no swizzle)
    start, lbo, sbo = desc & 0x3FFF, (desc >> 16) & 0x3FFF, (desc >> 32) & 0x3FFF
    if swap:
        lbo, sbo = sbo, lbo
    r = torch.arange(rows)[:, None]
    k = torch.arange(16)[None, :]
    unit = start + (r // 8) * sbo + r % 8 + (k // 8) * lbo
    if swap:  # a wrong layout reads past the operand: wrap around
        unit = unit % units.shape[-2]
    return units[..., unit, k % 8]


def _unpack_wgmma_tiles(frags, n_convs):
    """W (n, 64, 64, 9) read out of the bf16 packing through the A
    descriptors: per conv and tap a stage of 64 × 64, k-step ks at +2048 B."""
    units = frags.float().reshape(n_convs, 9, 512, 8)
    w = torch.zeros(n_convs, 9, 64, 64)
    desc = _gmma_desc(0, A_LBO, A_SBO)
    for ks in range(4):
        w[:, :, :, 16 * ks : 16 * ks + 16] = _read_k_major(units, desc + ks * (2048 >> 4), 64)
    return w.permute(0, 2, 3, 1)


@pytest.mark.parametrize("hidden", [40, 16])
def test_pack_weights_bf16_layout(hidden):
    """The bf16 kernel's ``frags``: the 2K hidden×hidden convs rounded to
    bf16, to nearest and ties to even, as 64 × 64 A tiles a tap that the A
    descriptor reads back (zero past the hidden width); ``small``: conv_in
    rounded the same way, the rest fp32 as in the TF32 packing."""
    c_in, c_out, blocks = 4, 8, 2
    net = ResNet(c_in, [hidden] * blocks, c_out, generator=torch.Generator().manual_seed(8))
    n = 2 * blocks
    with torch.no_grad():
        params = net.kernel_params()
        frags, small = cs.pack_weights(params, c_in, hidden, c_out, torch.device("cpu"), bf16=True)
        _, small32 = cs.pack_weights(params, c_in, hidden, c_out, torch.device("cpu"))
    assert frags.dtype == torch.bfloat16 and frags.numel() == n * 9 * 64 * 64
    w_got = _unpack_wgmma_tiles(frags, n).numpy()
    w = torch.stack([params["blocks"][k][c]["w"].detach() for k in range(blocks) for c in ("conv1", "conv2")])
    w = w.reshape(n, hidden, hidden, 9)
    np.testing.assert_array_equal(w_got[:, :hidden, :hidden], cs.bf16_round(w).numpy())
    assert not w_got[:, hidden:].any() and not w_got[:, :, hidden:].any()
    # Conv 1 (block 0's conv2), tap 5, W[o=9][i=2]: group 0, output 9, channel 2.
    assert frags[(1 * 9 + 5) * 64 * 64 + 9 * 8 + 2] == cs.bf16_round(params["blocks"][0]["conv2"]["w"][9, 2, 1, 2])
    hp = cs.padded_hidden(hidden)
    n_in = c_in * 9 * hp
    w_in = small32[:n_in]
    np.testing.assert_array_equal(small[:n_in].numpy(), cs.bf16_round(w_in).numpy())
    assert not torch.equal(small[:n_in], w_in)
    np.testing.assert_array_equal(small[n_in:].numpy(), small32[n_in:].numpy())
    # bf16 rounds ties to even: 1 + 2^-8 lies halfway between 1 and 1 + 2^-7.
    assert float(cs.bf16_round(torch.tensor([1 + 2.0**-8]))) == 1.0
    assert float(cs.bf16_round(torch.tensor([1 + 3 * 2.0**-8]))) == 1 + 2.0**-6


def _epilogue_visits(plan, w, rows):
    """(warpgroup, warp, lane, element, row, col) of every accumulator element
    the bf16 kernel's epilogue writes for a band of ``rows`` rows, walked as
    csrc's ``for_band_pixels`` walks them: element 4j + e of a thread holds
    band pixel wg·n + 8j + 2·(lane % 4) + e % 2, counted over rows of W+1;
    the row and column advance by 8 pixels a j; a pad column (col = W) or a
    pixel past the band (row ≥ rows) is skipped."""
    wp = w + 1
    visits = []
    for wg in range(cs.BF16_WARPGROUPS):
        for warp in range(plan.cm // 16):
            for lane in range(32):
                n0 = wg * plan.n + 2 * (lane % 4)
                r, c = n0 // wp, n0 % wp
                for j in range(plan.n // 8):
                    for half in range(2):
                        rr, cc = r, c + half
                        if cc == wp:
                            rr, cc = rr + 1, 0
                        if rr < rows and cc < w:
                            visits += [(wg, warp, lane, 4 * j + half, rr, cc),
                                       (wg, warp, lane, 4 * j + half + 2, rr, cc)]
                    c += 8
                    while c >= wp:
                        c, r = c - wp, r + 1
    return visits


def _channel(warp, lane, element):
    """Output channel of accumulator element 4j + e of a warp's lane."""
    return 16 * warp + lane // 4 + 8 * (element % 4 // 2)


def _pixel(wg, n, lane, element):
    """Band pixel (over rows of W+1) of accumulator element 4j + e."""
    return wg * n + 8 * (element // 4) + 2 * (lane % 4) + element % 2


def _emulate_bf16_kernel(x, params, c_in, hidden, c_out, swap=False):
    """The bf16 kernel on the CPU, from its packed buffers and its launch
    plan, addressed as it addresses shared memory: each CTA's bf16 maps
    ([channel group][map pixel][8 channels], relu'd and rounded by the
    epilogue that writes them, halo rows written into the neighbours'),
    each tap's B tile read through the map descriptor moved by the tap's
    offset, A through the weight tile's; fp32 sums, h in fp32, conv_in and
    the head on the fp32 pipes."""
    batch, _, height, width = x.shape
    plan = cs.plan_launch_bf16(batch, c_in, hidden, height, width)
    cm, n_tile, mp, hp, wp = plan.cm, plan.n, plan.map_px, plan.hidden, width + 1
    n_convs = 2 * len(params["blocks"])
    frags, small = cs.pack_weights(params, c_in, hidden, c_out, torch.device("cpu"), bf16=True)
    a_units = frags.float().reshape(n_convs, 9, 512, 8) if n_convs else None
    zero_block = torch.zeros(16, 8)  # 256 bytes
    w_in = small[: c_in * 9 * hp].reshape(c_in, 9, hp)
    rest = small[c_in * 9 * hp :]
    bias, rest = rest[: n_convs * hp].reshape(n_convs, hp), rest[n_convs * hp :]
    w_out, rest = rest[: hp * c_out].reshape(hp, c_out), rest[hp * c_out :]
    b_out, head_w, head_b = rest.reshape(3, c_out)
    bands = plan.bands(height)
    nc = plan.cluster
    # Each CTA's epilogue writes, (channel, band pixel, row, column) per element.
    writes = [torch.tensor([(_channel(v[1], v[2], v[3]), _pixel(v[0], n_tile, v[2], v[3]), v[4], v[5])
                            for v in _epilogue_visits(plan, width, rows)]).T for _, rows in bands]

    def store(maps, r, vals):
        """The epilogue's map writes of CTA r: vals (B, 64, 2n) fp32."""
        rows = bands[r][1]
        ch, px, row, col = writes[r]
        val = cs.bf16_round(torch.relu(vals[:, ch, px]))
        grp, sub = ch // 8, ch % 8
        maps[:, r, grp * mp + 1 + (row + 1) * wp + col, sub] = val
        if r > 0:
            up = row == 0
            q = 1 + (bands[r - 1][1] + 1) * wp + col[up]
            maps[:, r - 1, grp[up] * mp + q, sub[up]] = val[:, up]
        if r < nc - 1:
            down = row == rows - 1
            maps[:, r + 1, grp[down] * mp + 1 + col[down], sub[down]] = val[:, down]

    # conv_in on the bf16-rounded input (exact products, fp32 sums), laid
    # out over each CTA's band pixels; the head reads h back the same way.
    w_in = w_in.permute(2, 0, 1).reshape(hp, c_in, 3, 3)
    full = cs._conv3x3_taps(cs.bf16_round(x), w_in)
    hmap = torch.zeros(batch, nc, (cm // 8) * mp, 8)
    tmap = torch.zeros_like(hmap)
    h = torch.zeros(batch, nc, 64, cs.BF16_WARPGROUPS * n_tile)
    band_px = []
    for r, (r0, rows) in enumerate(bands):
        row, col = torch.div(torch.arange(rows * wp), wp, rounding_mode="floor"), torch.arange(rows * wp) % wp
        keep = col < width
        band_px.append((row[keep] * wp + col[keep], r0 + row[keep], col[keep]))
        n, y, xx = band_px[r]
        h[:, r, :cm, n] = full[:, :cm, y, xx]
        store(hmap, r, h[:, r])
    for k in range(n_convs):
        src, dst = (tmap, hmap) if k % 2 else (hmap, tmap)
        acc = torch.zeros(batch, nc, 64, cs.BF16_WARPGROUPS * n_tile)
        for wg in range(cs.BF16_WARPGROUPS):
            first = 16 * (1 + wp + wg * n_tile)
            for tap in range(9):
                b_desc = _gmma_desc(first + 16 * ((tap // 3 - 1) * wp + tap % 3 - 1), 16 * mp, 128)
                a_desc = _gmma_desc(0, A_LBO, A_SBO)
                for ks in range(4):  # past the map's channels B is the zero block (SBO 0)
                    a = _read_k_major(a_units[k, tap], a_desc + ks * (2048 >> 4), 64, swap)
                    if ks < cm // 16:
                        b = _read_k_major(src, b_desc + ks * 2 * mp, n_tile, swap)  # (B, nc, n, 16)
                    else:
                        b = _read_k_major(zero_block, _gmma_desc(0, 128, 0), n_tile).expand(batch, nc, -1, -1)
                    acc[..., wg * n_tile : (wg + 1) * n_tile] += torch.einsum("mk,bcnk->bcmn", a, b)
        acc[:, :, :hp] += bias[k][None, None, :, None]
        if k % 2:
            h = h + acc
        for r in range(nc):
            if k < n_convs - 1:
                store(dst, r, h[:, r] if k % 2 else acc[:, r])
    out = torch.zeros(batch, c_out, height, width)
    for r in range(nc):
        n, y, xx = band_px[r]
        z = torch.einsum("io,bin->bon", w_out[:cm], torch.relu(h[:, r, :cm, n])) + b_out[None, :, None]
        out[:, :, y, xx] = head_w[None, :, None] * torch.tanh(z) + head_b[None, :, None]
    return out


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=IDS)
def test_bf16_emulation_matches_plain(geometry):
    """The bf16 kernel's addressing — its packed weight tiles, its launch
    plan's bands and maps, each tap's B tile through the moved descriptor,
    its epilogue's writes and halos — emulated on the CPU gives the plain
    bf16 version within the fp32 tolerance; read with LBO and SBO swapped
    it does not."""
    c_in, c_out, hw, blocks, batch = geometry
    gen = torch.Generator().manual_seed(9)
    net = ResNet(c_in, [16] * blocks, c_out, generator=gen)
    with torch.no_grad():
        x = torch.randn((batch, c_in, hw, hw), generator=gen)
        params = net.kernel_params()
        ref = cs.coupler_stack_plain(x, params, bf16=True)
        got = _emulate_bf16_kernel(x, params, c_in, 16, c_out)
        swapped = _emulate_bf16_kernel(x, params, c_in, 16, c_out, swap=True)
    plan = cs.plan_launch_bf16(batch, c_in, 16, hw, hw)
    assert plan.cluster > 1 and plan.rows * (hw + 1) > plan.n  # halos, and both warpgroups
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= TOL * scale
    assert float((swapped - ref).abs().max()) > 100 * TOL * scale


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
    """The bf16 packing (``wgmma_tiles``) has its own cache entry beside the
    TF32 one, whatever the chunk depth asked: each arithmetic gets its own
    buffers, each reused while the tensors stay."""
    dev = torch.device("cpu")
    net = ResNet(2, [16] * 2, 4, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        params = net.kernel_params()
        tf32 = cs.packed_weights(params, 2, 16, 4, dev, 32)
        bf16 = cs.packed_weights(params, 2, 16, 4, dev, 32, bf16=True)
        assert bf16 is not tf32 and bf16[0].dtype == torch.bfloat16 and tf32[0].dtype == torch.float32
        assert bf16[0].numel() == 4 * 9 * 64 * 64  # 4 convs, 9 taps, 64 × 64 tiles
        assert cs.packed_weights(params, 2, 16, 4, dev, 16, bf16=True) is bf16
        assert cs.packed_weights(params, 2, 16, 4, dev, 32) is tf32
        want = cs.pack_weights(params, 2, 16, 4, dev, bf16=True)
        assert all(torch.equal(a, b) for a, b in zip(bf16, want))
        net.conv_in.w.mul_(2.0)
        again = cs.packed_weights(params, 2, 16, 4, dev, 32, bf16=True)
    assert again is not bf16 and torch.equal(again[0], bf16[0]) and not torch.equal(again[1], bf16[1])


# chip_smoke.py's COUPLER_MAIN and COUPLER_EDGE shapes, (B, C_in, C_out, H=W,
# hidden, blocks): the kernel runs every one of them on the card.
SMOKE_COUPLERS = [(250, 1, 2, 28, 64, 8), (50, 1, 2, 28, 64, 8), (250, 2, 4, 14, 64, 8),
                  (50, 2, 4, 14, 64, 8), (1, 1, 2, 28, 64, 8), (50, 1, 2, 28, 64, 1),
                  (50, 2, 4, 14, 16, 8), (3, 1, 2, 7, 16, 1), (8, 3, 6, 32, 64, 8),
                  (2, 3, 6, 64, 64, 8)]


def _check_bf16_plan(batch, c_in, hidden, h, w):
    """A bf16 plan that the kernel's own check (csrc's ``bf::plan_ok``) takes:
    bands that tile the rows, two warpgroups that cover the tallest band,
    maps that hold it with its halos and the last tap's reach, a compiled
    width, 2-9 ring stages, and shared memory within 232,448 B."""
    plan = cs.plan_launch_bf16(batch, c_in, hidden, h, w)
    bands = plan.bands(h)
    assert bands[0][0] == 0 and sum(r for _, r in bands) == h and max(r for _, r in bands) == plan.rows
    assert 1 <= plan.cluster <= min(cs.MAX_CLUSTER, h) and plan.n in cs.BF16_WIDTHS
    assert cs.BF16_WARPGROUPS * plan.n >= plan.rows * (w + 1)
    assert plan.map_px % 8 == 0 and plan.map_px >= cs.BF16_WARPGROUPS * plan.n + 2 * (w + 1) + 2
    assert plan.cm == cs.bf16_hidden(hidden) and plan.hidden == cs.padded_hidden(hidden)
    assert 2 <= plan.stages <= cs.BF16_MAX_STAGES
    assert plan.smem_bytes == cs.bf16_smem_bytes(c_in, plan.cm, plan.n, plan.map_px, plan.stages)
    assert plan.smem_bytes <= 232_448
    return plan


@pytest.mark.parametrize("dataset", sorted(DATASET_SHAPES))
def test_bf16_launch_plan_covers_every_image_coupler(dataset):
    """Every coupler shape of the six image datasets has a bf16 plan at the
    batches the port calls it with."""
    for c_in, hidden, h, w in _image_couplers(dataset):
        for batch in (1, 8, 50, 64, 250):
            _check_bf16_plan(batch, c_in, hidden, h, w)


@pytest.mark.parametrize("shape", SMOKE_COUPLERS, ids=lambda s: "B{}-{}to{}-{}px-h{}-k{}".format(*s))
def test_bf16_launch_plan_covers_the_smoke_shapes(shape):
    batch, c_in, _, hw, hidden, _ = shape
    plan = _check_bf16_plan(batch, c_in, hidden, hw, hw)
    # At three mnist shapes, the plans the cost model picks: on an H100 the
    # fastest of every plan there (cmf_tpu_torch/tools/coupler_bf16_compare.py
    # --plans). At B=50 14x14 a faster plan exists, so only its validity is held.
    picked = {(250, 28): (3, 160, 6), (50, 28): (4, 104, 9), (250, 14): (1, 112, 9)}
    if hidden == 64 and (batch, hw) in picked and shape[5] == 8:
        assert (plan.cluster, plan.n, plan.stages) == picked[batch, hw]


def test_bf16_kernel_takes_every_shape_the_gate_admits():
    """The gate (``coupler_kernel_available``) is the fp32 kernel's; the bf16
    kernel has a plan for every shape it admits, over hidden widths, C_in up
    to the padded width and image sizes up to 16 bands of 256 pixels."""
    checked = 0
    for hidden in (1, 8, 16, 17, 32, 33, 40, 48, 56, 64):
        for w in (*range(1, 34), 48, 56, 63, 64, 65, 128, 129, 255, 256):
            for h in sorted({1, 2, 3, 7, 14, 28, 33, 64, 100, 256, 257, 4096 // w, 4096 // w + 1}):
                for c_in in sorted({1, hidden, cs.padded_hidden(hidden)}):
                    if h >= 1 and cs.coupler_kernel_available(c_in, hidden, h, w):
                        _check_bf16_plan(8, c_in, hidden, h, w)
                        checked += 1
    assert checked > 2000


@pytest.mark.parametrize("shape", [(1, 64, 28, 28, 250), (2, 64, 14, 14, 50), (3, 64, 64, 64, 2),
                                   (1, 16, 7, 7, 3), (4, 16, 14, 14, 5)],
                         ids=["28x28", "14x14-c2", "64x64-c16", "7x7-h16", "14x14-c4"])
def test_bf16_epilogue_writes_only_band_pixels(shape):
    """The epilogue's pixel map (csrc's ``for_band_pixels``) at the plan's
    widths, for each band height the plan cuts: every band pixel of every
    live channel written exactly once, never a pad column (col = W, the
    shared zero column) and never a pixel past the band, each element at
    the channel and pixel the wgmma accumulator layout puts it."""
    c_in, hidden, h, w, batch = shape
    plan = cs.plan_launch_bf16(batch, c_in, hidden, h, w)
    for rows in sorted({r for _, r in plan.bands(h)}):
        visits = _epilogue_visits(plan, w, rows)
        seen = [(_channel(warp, lane, e), row, col) for _, warp, lane, e, row, col in visits]
        assert sorted(seen) == [(c, r, q) for c in range(plan.cm) for r in range(rows) for q in range(w)]
        for wg, _, lane, e, row, col in visits:
            assert _pixel(wg, plan.n, lane, e) == row * (w + 1) + col


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


@functools.lru_cache(maxsize=None)
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
    return tuple(sorted(shapes))


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
