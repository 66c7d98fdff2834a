"""Dense augmented-batch decode + Jacobian for non-square chains
(``cmf_tpu/ops/decode_jac.py`` in torch).

The exact log-det path pushes the d latent basis vectors through the
decoder. This program carries the primal point and the d Jacobian columns
together in one ``(d+1, B, ...)`` tensor, group 0 the primal and groups 1..d
the tangent columns, with the tangent rules written out.

Flat stages (tabular and 2-D chains, and the flat end of image chains):

* the tail's zero-pad + inverse permutation builds the initial tensor;
* each inverse affine coupling (x = z·e^{−s} − t) folds its channel
  gather/scatter into zero-padded weight matrices, so every coupler layer is
  one ``((d+1)·B, C) @ (C, H)`` matmul;
* each inverse batch-norm is one whole-group affine map, x = z·scale +
  shift, with the shift on the primal group only; inside
  ``batch_statistics`` it reads the statistics of the encoder's forward,
  with their graph, else the running ones (decode_jac.py:296-309);
* every group-dependent op is one whole-group formula gated by a (d+1, 1, 1)
  primal mask (the round-5 primal-mask form), never a slice + concatenate.

Conv stages (the multiscale image decode, decode_jac.py:195-269):

* every convolution runs once over the merged ``(G·B, C, H, W)`` batch, the
  bias on the primal group only (a conv is linear);
* ReLU is one gate ``X ⊙ 1{X₀ > 0}``: relu for the primal group, its JVP
  for the tangents;
* the scaled-tanh coupler head and the coupling inverse apply their
  tangent rules (w·(1−tanh²(h₀))⊙t; e^{−s}(t_z − z⊙t_s) − t_t);
* the squeeze, the non-square split's zero pad and a channel permutation
  are group-preserving reshapes, pads and gathers.

The JAX package wraps each ResNet coupler in ``jax.checkpoint``; the port
does not, since no route of the port differentiates a program with conv
stages (the head's exact path skips it, and the Gram route runs it without
a graph). A gradient through it still works, keeping the hidden maps.

The matmuls and convs take the compute-precision policy
(``nets.core._matmul``, ``_conv2d``) on the whole augmented tensor, so
under bf16 the tangent columns are rounded where the JAX package rounds
them. ``has_conv`` says whether the chain has conv stages: the head takes
the program on its exact path, and ``hutchinson_solver="auto"`` takes the
exact-Gram solver, only where it has none (nonsquare.py:220,285).

It is plain first-order torch code, so ``loss.backward()`` through it yields
the second-order terms the log-det gradient needs. ``torch.func.jacfwd`` of
the plain decode serves only as an independent oracle in the tests.
"""

import numpy as np
import torch

from ..bijections.batchnorm import BatchNormBijection
from ..bijections.coupling import (
    Checkerboard2dCouplingBijection,
    MaskedChannelwiseCouplingBijection,
    SplitChannelwiseCouplingBijection,
)
from ..bijections.reshaping import (
    FlipBijection,
    RandomChannelwisePermutationBijection,
    Squeeze2dBijection,
    ViewBijection,
)
from ..couplers import ChunkedSharedCoupler, IndependentCoupler
from ..densities.exact import BijectionDensity
from ..densities.nonsquare import NonSquareTailDensity
from ..densities.split import SplitDensity
from ..nets.core import MLP, ResNet, _conv2d, _matmul


def _mask0(d, like):
    """(d+1, 1, 1) indicator of the primal group."""
    m = torch.zeros((d + 1, 1, 1), dtype=like.dtype, device=like.device)
    m[0] = 1.0
    return m


def _aug_act(U, activation):
    """Augmented activation: primal group gets σ, tangents σ′(primal)⊙t.
    σ is evaluated on the primal slice only; both groups recombine through
    the mask broadcast."""
    m0 = _mask0(U.shape[0] - 1, U)
    U0 = U[:1]
    if activation is torch.tanh:
        a = torch.tanh(U0)
        deriv = 1.0 - a * a
    else:  # relu
        a = torch.relu(U0)
        deriv = (U0 > 0).to(U.dtype)
    return m0 * a + (1.0 - m0) * deriv * U


def _primal_bias(b, d):
    """(d+1, 1, H) bias that only touches the primal group."""
    return _mask0(d, b) * b[None, None]


def _step_index(step, name, device):
    """The step's channel indices on ``device``, made there once: a copy
    from the host inside a captured step would fail the capture."""
    cache = step.setdefault("on_device", {})
    if (name, device) not in cache:
        cache[(name, device)] = torch.as_tensor(step[name], device=device)
    return cache[(name, device)]


def _acl_weights(step, device):
    """Fold the channel selection into zero-padded first/last weights."""
    bij = step["bij"]
    D = bij.x_shape[0]
    pass_idx, mod_idx = _step_index(step, "pass_idx", device), _step_index(step, "mod_idx", device)
    m = mod_idx.shape[0]
    cp = bij.coupler
    if isinstance(cp, ChunkedSharedCoupler):
        layers = cp.net.layers
        first = (layers[0].w, layers[0].b)
        mids = [(layer.w, layer.b) for layer in layers[1:-1]]
        w_last, b_last = layers[-1].w, layers[-1].b
        ws, wl = w_last[:, :m], w_last[:, m:]
        bs, bl = b_last[:m], b_last[m:]
    else:  # independent shift / log-scale nets of the same depth
        s_layers, l_layers = cp.shift.layers, cp.log_scale.layers
        # Side by side: shared input, concatenated hiddens (block-diagonal
        # mids), concatenated outputs.
        first = (
            torch.cat([s_layers[0].w, l_layers[0].w], dim=1),
            torch.cat([s_layers[0].b, l_layers[0].b]),
        )
        mids = [
            (torch.block_diag(sl.w, ll.w), torch.cat([sl.b, ll.b]))
            for sl, ll in zip(s_layers[1:-1], l_layers[1:-1])
        ]
        ws_, wl_ = s_layers[-1].w, l_layers[-1].w
        ws = torch.cat([ws_, ws_.new_zeros(wl_.shape[0], m)], dim=0)
        wl = torch.cat([wl_.new_zeros(ws_.shape[0], m), wl_], dim=0)
        bs, bl = s_layers[-1].b, l_layers[-1].b

    w1, b1 = first
    w1e = w1.new_zeros(D, w1.shape[1]).index_copy(0, pass_idx, w1)
    ws_e = ws.new_zeros(ws.shape[0], D).index_copy(1, mod_idx, ws)
    wl_e = wl.new_zeros(wl.shape[0], D).index_copy(1, mod_idx, wl)
    bs_e = bs.new_zeros(D).index_copy(0, mod_idx, bs)
    bl_e = bl.new_zeros(D).index_copy(0, mod_idx, bl)
    return w1e, b1, mids, ws_e, bs_e, wl_e, bl_e


def _flat_acl(step, X, d):
    activation = step["activation"]
    w1e, b1, mids, ws_e, bs_e, wl_e, bl_e = _acl_weights(step, X.device)
    H = _matmul(X, w1e) + _primal_bias(b1, d)
    for w, b in mids:
        H = _aug_act(H, activation)
        H = _matmul(H, w) + _primal_bias(b, d)
    H = _aug_act(H, activation)
    S = _matmul(H, ws_e) + _primal_bias(bs_e, d)
    L = _matmul(H, wl_e) + _primal_bias(bl_e, d)
    # One whole-group inverse-coupling formula (primal: e^{−s}x − t;
    # tangent: e^{−s}(t_x − x₀·t_s) − t_t), gated by the primal mask.
    m0 = _mask0(d, X)
    E0 = torch.exp(-L[:1])
    return E0 * (X - X[:1] * ((1.0 - m0) * L)) - S


def _bn_inverse(bij, X, d):
    """x = z·sqrt(var + eps) + mean, after the affine's inverse: one scale on
    every group, the shift on the primal group only."""
    mean, var = bij.inverse_statistics()
    scale = torch.sqrt(var + bij.eps)
    shift = mean
    if bij.apply_affine:
        scale = scale * torch.exp(-bij.log_scale)
        shift = shift - bij.shift * scale
    m0 = _mask0(d, X).reshape((d + 1,) + (1,) * (X.dim() - 1))
    return X * scale + m0 * shift


# ------------------------------------------------------------ conv stages
def _relu_gate(X):
    """X ⊙ 1{X₀>0}: relu for the primal group, its JVP for the tangents."""
    return X * (X[:1] > 0).to(X.dtype)


def _conv(X, w, b=None):
    """One conv over the merged (G·B, C, H, W) batch; the bias touches only
    the primal group."""
    G, B = X.shape[:2]
    out = _conv2d(X.reshape(G * B, *X.shape[2:]), w)
    out = out.reshape(G, B, *out.shape[1:])
    if b is not None:
        mask = _mask0(G - 1, out).reshape(G, 1, 1, 1, 1)
        out = out + mask * b[None, None, :, None, None]
    return out


def _resnet_aug(net, X):
    """The batch-norm-free ResNet coupler on an augmented batch
    (decode_jac.py:214-235): relu gates, merged-batch convs, and the
    scaled-tanh head w·tanh(h)+b on the primal, w·(1−tanh²(h₀))·t on the
    tangents."""
    out = _conv(X, net.conv_in.w)
    for block in net.blocks:
        h = _conv(_relu_gate(out), block.conv1.w, block.conv1.b)
        h = _conv(_relu_gate(h), block.conv2.w, block.conv2.b)
        out = out + h
    out = _conv(_relu_gate(out), net.conv_out.w, net.conv_out.b)
    th = torch.tanh(out[:1])
    hw, hb = net.head_w[None, None], net.head_b[None, None]
    return torch.cat([hw * th + hb, hw * (1.0 - th * th) * out[1:]], dim=0)


def _coupler_out(net, Cin):
    """(shift, log-scale) of the coupler on an augmented batch
    (decode_jac.py:237-243)."""
    out = _resnet_aug(net, Cin)
    c = out.shape[2]
    return out[:, :, : c // 2], out[:, :, c // 2 :]


def _conv_acl(step, X):
    """The inverse of a checkerboard or channel-split coupling on an
    augmented (G, B, C, H, W) batch (decode_jac.py:245-269)."""
    bij = step["bij"]
    net = bij.coupler.net
    if step["mode"] == "checkerboard":
        m = bij.mask[None]  # (1, 1, 1, H, W)
        S_, L_ = _coupler_out(net, m * X)
        E0 = torch.exp(-L_[:1])
        x0 = m * X[:1] + (1 - m) * (X[:1] * E0 - S_[:1])
        xt = m * X[1:] + (1 - m) * (E0 * (X[1:] - X[:1] * L_[1:]) - S_[1:])
        return torch.cat([x0, xt], dim=0)
    C = X.shape[2]
    n_pass = bij.num_passthrough
    if bij.reverse_mask:
        pas, mod = X[:, :, C - n_pass :], X[:, :, : C - n_pass]
    else:
        pas, mod = X[:, :, :n_pass], X[:, :, n_pass:]
    S_, L_ = _coupler_out(net, pas)
    E0 = torch.exp(-L_[:1])
    mod0 = mod[:1] * E0 - S_[:1]
    modt = E0 * (mod[1:] - mod[:1] * L_[1:]) - S_[1:]
    mod_new = torch.cat([mod0, modt], dim=0)
    parts = [mod_new, pas] if bij.reverse_mask else [pas, mod_new]
    return torch.cat(parts, dim=2)


def _squeeze_inv(step, X):
    """The glow unsqueeze (reshaping.py:98-104), the group axis in front."""
    G, B = X.shape[:2]
    zc, zh, zw = step["z_shape"]
    f = step["factor"]
    X = X.reshape(G, B, zc // f**2, f, f, zh, zw).permute(0, 1, 2, 5, 3, 6, 4)
    return X.reshape(G, B, *step["x_shape"])


class DenseDecodeProgram:
    """Decode-order step list over a non-square chain. Steps hold the port's
    modules themselves, so the program reads their current parameters and
    buffers on every call."""

    def __init__(self, steps, tail, tail_shape, flat_dim, latent_dim, has_conv=False):
        self.steps = steps
        self.tail = tail
        self.tail_shape = tuple(tail_shape)
        self.flat_dim = flat_dim
        self.latent_dim = latent_dim
        self.has_conv = has_conv

    def __call__(self, z, columns=None):
        """z (B, d) → (recon_flat (B, D), jac_cols (k, B, D)): the columns
        of the basis tangents ``columns`` = (start, stop) of d (a rank's
        share under a column partition), all d by default."""
        B, d = z.shape
        D = self.flat_dim
        assert d == self.latent_dim
        start, stop = (0, d) if columns is None else columns
        k = stop - start
        x0 = torch.cat([z, z.new_zeros(B, D - d)], dim=1)
        basis = torch.eye(d, D, dtype=z.dtype, device=z.device)[start:stop]
        X = torch.cat([x0[None], basis[:, None].expand(k, B, D)], dim=0)
        X = X[:, :, self.tail.inverse_permutation]
        if len(self.tail_shape) > 1:
            X = X.reshape(k + 1, B, *self.tail_shape)

        for step in self.steps:
            kind = step["kind"]
            if kind == "acl":
                X = _flat_acl(step, X, k)
            elif kind == "conv_acl":
                X = _conv_acl(step, X)
            elif kind == "bn":
                X = _bn_inverse(step["bij"], X, k)
            elif kind == "perm":
                X = X.index_select(step["axis"], step["bij"].inverse_permutation)
            elif kind == "flip":
                X = torch.flip(X, dims=(-1,))
            elif kind == "view":
                X = X.reshape(k + 1, B, *step["shape"])
            elif kind == "squeeze_inv":
                X = _squeeze_inv(step, X)
            elif kind == "split_pad":
                # The multiscale factor-out: decode zero-pads the second half.
                X = torch.cat([X, torch.zeros_like(X)], dim=2)
            else:  # pragma: no cover
                raise AssertionError(kind)

        recon = X[0].reshape(B, -1)
        jac_cols = X[1:].reshape(k, B, -1)
        return recon, jac_cols


def _mlp_activation(net):
    if isinstance(net, MLP) and net.activation in (torch.tanh, torch.relu):
        return net.activation
    return None


def _resnet_ok(net):
    """A ResNet coupler without batch-norm (decode_jac.py:364-368)."""
    return isinstance(net, ResNet) and not net.use_batchnorm


def _flat_coupler_activation(coupler):
    """The activation of a flat coupling's MLP coupler, or None where the
    program does not cover it: one shared MLP, or a shift and a log-scale
    MLP of one depth and one activation."""
    if isinstance(coupler, ChunkedSharedCoupler):
        return _mlp_activation(coupler.net)
    if isinstance(coupler, IndependentCoupler):
        act = _mlp_activation(coupler.shift)
        if (
            act is not None
            and _mlp_activation(coupler.log_scale) is act
            and len(coupler.shift.sizes) == len(coupler.log_scale.sizes)
        ):
            return act
    return None


def extract_dense_decode_program(head):
    """Walk ``head.prior``; return a ``DenseDecodeProgram`` when every layer
    of the decode chain is supported, else ``None``
    (decode_jac.py:338-505)."""
    steps_down = []
    has_conv = False
    node = getattr(head, "prior", None)
    if node is None:
        return None
    while True:
        if isinstance(node, NonSquareTailDensity):
            tail = node
            break
        if isinstance(node, SplitDensity):
            if not node.non_square or node.axis != 1:
                return None
            steps_down.append({"kind": "split_pad"})
            node = node.density_1
            continue
        if not isinstance(node, BijectionDensity):
            return None
        bij = node.bijection
        if isinstance(bij, ViewBijection):
            # Decode applies the inverse reshape (z_shape → x_shape).
            steps_down.append({"kind": "view", "shape": tuple(bij.x_shape)})
        elif isinstance(bij, Squeeze2dBijection):
            steps_down.append({"kind": "squeeze_inv", "factor": bij.factor,
                               "x_shape": tuple(bij.x_shape), "z_shape": tuple(bij.z_shape)})
        elif isinstance(bij, FlipBijection):
            if len(bij.x_shape) != 1 or bij.axis != 1:
                return None
            steps_down.append({"kind": "flip"})
        elif isinstance(bij, RandomChannelwisePermutationBijection):
            # The channel axis: -1 for flat stages, 2 for (G, B, C, H, W).
            steps_down.append({"kind": "perm", "bij": bij, "axis": -1 if len(bij.x_shape) == 1 else 2})
        elif isinstance(bij, BatchNormBijection):
            steps_down.append({"kind": "bn", "bij": bij})
        elif isinstance(bij, Checkerboard2dCouplingBijection):
            if not (isinstance(bij.coupler, ChunkedSharedCoupler) and _resnet_ok(bij.coupler.net)):
                return None
            has_conv = True
            steps_down.append({"kind": "conv_acl", "mode": "checkerboard", "bij": bij})
        elif isinstance(bij, (MaskedChannelwiseCouplingBijection, SplitChannelwiseCouplingBijection)):
            if len(bij.x_shape) == 3:
                if not (
                    isinstance(bij, SplitChannelwiseCouplingBijection)
                    and isinstance(bij.coupler, ChunkedSharedCoupler)
                    and _resnet_ok(bij.coupler.net)
                ):
                    return None
                has_conv = True
                steps_down.append({"kind": "conv_acl", "mode": "channel", "bij": bij})
                node = node.prior
                continue
            if len(bij.x_shape) != 1:
                return None
            act = _flat_coupler_activation(bij.coupler)
            if act is None:
                return None
            if isinstance(bij, SplitChannelwiseCouplingBijection):
                n, k = bij.x_shape[0], bij.num_passthrough
                if bij.reverse_mask:
                    pass_idx, mod_idx = np.arange(n - k, n), np.arange(n - k)
                else:
                    pass_idx, mod_idx = np.arange(k), np.arange(k, n)
            else:
                pass_idx, mod_idx = bij.pass_idx.cpu().numpy(), bij.mod_idx.cpu().numpy()
            steps_down.append({"kind": "acl", "bij": bij, "activation": act,
                               "pass_idx": pass_idx, "mod_idx": mod_idx})
        else:
            return None
        node = node.prior

    # Walk order is x→z (encoder); decode applies inverses innermost-first.
    return DenseDecodeProgram(
        list(reversed(steps_down)),
        tail,
        tail.x_shape,
        tail.flattened_dims,
        tail.latent_dimension,
        has_conv,
    )
