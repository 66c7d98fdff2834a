"""Dense augmented-batch decode + Jacobian for flat non-square chains
(``cmf_tpu/ops/decode_jac.py`` in torch, flat stages only).

The exact log-det path pushes the d latent basis vectors through the
decoder. This program carries the primal point and the d Jacobian columns
together in one ``(d+1, B, D)`` tensor, group 0 the primal and groups 1..d
the tangent columns, with the tangent rules written out:

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

It is plain first-order torch code, so ``loss.backward()`` through it yields
the second-order terms the log-det gradient needs. ``torch.func.jacfwd`` of
the plain decode serves only as an independent oracle in the tests.
"""

import torch

from ..bijections.batchnorm import BatchNormBijection
from ..bijections.coupling import AlternatingChannelwiseCouplingBijection
from ..bijections.reshaping import (
    FlipBijection,
    RandomChannelwisePermutationBijection,
    ViewBijection,
)
from ..couplers import ChunkedSharedCoupler, IndependentCoupler
from ..densities.exact import BijectionDensity
from ..densities.nonsquare import NonSquareTailDensity
from ..nets.core import MLP


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


def _acl_weights(bij):
    """Fold the channel selection into zero-padded first/last weights."""
    D = bij.x_shape[0]
    pass_idx, mod_idx = bij.pass_idx, bij.mod_idx
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


def _flat_acl(bij, activation, X, d):
    w1e, b1, mids, ws_e, bs_e, wl_e, bl_e = _acl_weights(bij)
    H = X @ w1e + _primal_bias(b1, d)
    for w, b in mids:
        H = _aug_act(H, activation)
        H = H @ w + _primal_bias(b, d)
    H = _aug_act(H, activation)
    S = H @ ws_e + _primal_bias(bs_e, d)
    L = H @ wl_e + _primal_bias(bl_e, d)
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


class DenseDecodeProgram:
    """Decode-order step list over a flat non-square chain. Steps hold the
    port's modules themselves, so the program reads their current
    parameters and buffers on every call."""

    def __init__(self, steps, tail, tail_shape, flat_dim, latent_dim):
        self.steps = steps
        self.tail = tail
        self.tail_shape = tuple(tail_shape)
        self.flat_dim = flat_dim
        self.latent_dim = latent_dim

    def __call__(self, z):
        """z (B, d) → (recon_flat (B, D), jac_cols (d, B, D))."""
        B, d = z.shape
        D = self.flat_dim
        assert d == self.latent_dim
        x0 = torch.cat([z, z.new_zeros(B, D - d)], dim=1)
        basis = torch.eye(d, D, dtype=z.dtype, device=z.device)
        X = torch.cat([x0[None], basis[:, None].expand(d, B, D)], dim=0)
        X = X[:, :, self.tail.inverse_permutation]
        if len(self.tail_shape) > 1:
            X = X.reshape(d + 1, B, *self.tail_shape)

        for step in self.steps:
            kind = step["kind"]
            if kind == "acl":
                X = _flat_acl(step["bij"], step["activation"], X, d)
            elif kind == "bn":
                X = _bn_inverse(step["bij"], X, d)
            elif kind == "perm":
                X = X[..., step["bij"].inverse_permutation]
            elif kind == "flip":
                X = torch.flip(X, dims=(-1,))
            elif kind == "view":
                X = X.reshape(d + 1, B, *step["shape"])
            else:  # pragma: no cover
                raise AssertionError(kind)

        recon = X[0].reshape(B, -1)
        jac_cols = X[1:].reshape(d, B, -1)
        return recon, jac_cols


def _mlp_activation(net):
    if isinstance(net, MLP) and net.activation in (torch.tanh, torch.relu):
        return net.activation
    return None


def extract_dense_decode_program(head):
    """Walk ``head.prior``; return a ``DenseDecodeProgram`` when every layer
    of the decode chain is a supported flat layer, else ``None``
    (decode_jac.py:338-505, flat branches)."""
    steps_down = []
    node = getattr(head, "prior", None)
    if node is None:
        return None
    while True:
        if isinstance(node, NonSquareTailDensity):
            tail = node
            break
        if not isinstance(node, BijectionDensity):
            return None
        bij = node.bijection
        if isinstance(bij, ViewBijection):
            # Decode applies the inverse reshape (z_shape → x_shape).
            steps_down.append({"kind": "view", "shape": tuple(bij.x_shape)})
        elif isinstance(bij, FlipBijection):
            if len(bij.x_shape) != 1 or bij.axis != 1:
                return None
            steps_down.append({"kind": "flip"})
        elif isinstance(bij, RandomChannelwisePermutationBijection):
            if len(bij.x_shape) != 1:
                return None
            steps_down.append({"kind": "perm", "bij": bij})
        elif isinstance(bij, BatchNormBijection):
            steps_down.append({"kind": "bn", "bij": bij})
        elif isinstance(bij, AlternatingChannelwiseCouplingBijection):
            if len(bij.x_shape) != 1:
                return None
            coupler = bij.coupler
            if isinstance(coupler, ChunkedSharedCoupler):
                act = _mlp_activation(coupler.net)
            elif isinstance(coupler, IndependentCoupler):
                act = _mlp_activation(coupler.shift)
                if (
                    act is None
                    or _mlp_activation(coupler.log_scale) is not act
                    or len(coupler.shift.sizes) != len(coupler.log_scale.sizes)
                ):
                    act = None
            else:
                act = None
            if act is None:
                return None
            steps_down.append({"kind": "acl", "bij": bij, "activation": act})
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
    )
