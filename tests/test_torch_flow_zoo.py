"""The rest of the port's flow zoo against the JAX package, module by
module, on the same weights (carried by ``interop``) and numpy inputs: the
planar and conditional planar flows, the sum-of-squares polynomial flow (at
negative inputs and |x| > 1), BNAF (each activation and each ``residual``
value) and its log-matmul-exp, the coupled rational-quadratic spline, the
constant and identity coupler nets in the masked channel coupling, tanh,
the inverse, identity and composite bijections, the mixture density and
the Concrete density. Values and log-jacobians within 1e-5 relative,
gradients within 1e-4 of the largest of their tensor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmf_tpu.bijections.base import CompositeBijection as JaxComposite
from cmf_tpu.bijections.base import IdentityBijection as JaxIdentity
from cmf_tpu.bijections.bnaf import BlockNeuralAutoregressiveBijection as JaxBNAF
from cmf_tpu.bijections.bnaf import _logmatmulexp as jax_logmatmulexp
from cmf_tpu.bijections.coupling import MaskedChannelwiseCouplingBijection as JaxMaskedCoupling
from cmf_tpu.bijections.elementwise import TanhBijection as JaxTanh
from cmf_tpu.bijections.linear import LULinearBijection as JaxLULinear
from cmf_tpu.bijections.planar import ConditionalPlanarBijection as JaxCondPlanar
from cmf_tpu.bijections.planar import PlanarBijection as JaxPlanar
from cmf_tpu.bijections.sos import SumOfSquaresPolynomialBijection as JaxSOS
from cmf_tpu.bijections.spline import CoupledRationalQuadraticSplineBijection as JaxCoupledSpline
from cmf_tpu.couplers import ChunkedSharedCoupler as JaxChunked
from cmf_tpu.densities.concrete import ConcreteConditionalDensity as JaxConcrete
from cmf_tpu.densities.gaussian import DiagonalGaussianDensity as JaxGaussian
from cmf_tpu.densities.mixture import BijectionMixtureDensity as JaxMixture
from cmf_tpu.nets import MLP as JaxMLP
from cmf_tpu.nets import ConstantNetwork as JaxConstant
from cmf_tpu.nets import IdentityNetwork as JaxIdentityNet
from cmf_tpu.nets import get_activation as jax_activation
from cmf_tpu_torch.bijections import (
    BlockNeuralAutoregressiveBijection,
    CompositeBijection,
    ConditionalPlanarBijection,
    CoupledRationalQuadraticSplineBijection,
    IdentityBijection,
    LULinearBijection,
    MaskedChannelwiseCouplingBijection,
    PlanarBijection,
    SumOfSquaresPolynomialBijection,
    TanhBijection,
)
from cmf_tpu_torch.bijections.bnaf import _logmatmulexp
from cmf_tpu_torch.bijections.sos import integer_powers
from cmf_tpu_torch.couplers import ChunkedSharedCoupler
from cmf_tpu_torch.densities import BijectionMixtureDensity, ConcreteConditionalDensity, DiagonalGaussianDensity
from cmf_tpu_torch.interop import jax_path, variables_from_jax
from cmf_tpu_torch.nets import MLP, ConstantNetwork, IdentityNetwork, get_activation

from _torch_parity import to_numpy
from _torch_tabular import (
    DIM,
    FWD_TOL,
    GRAD_TOL,
    HIDDEN,
    INV_TOL,
    ROUND_TRIP_TOL,
    assert_grads_close,
    check_bijection,
    check_forward,
    inputs,
    rel_err,
    t,
)

NUM_U = 3


def _raises_as_cmf_tpu(jax_bij, port_bij, z, *cond):
    with pytest.raises(NotImplementedError) as want:
        jax_bij.inverse(None, jnp.asarray(z), *(jnp.asarray(c) for c in cond))
    with pytest.raises(NotImplementedError) as got:
        port_bij.inverse(t(z), *map(t, cond))
    assert str(got.value) == str(want.value)


def test_planar_matches_cmf_tpu():
    """f(x) = x + û·tanh(wᵀx + b), params u, w (D,) and b (1,); no inverse."""
    port = PlanarBijection(DIM)
    assert sorted((n, tuple(p.shape)) for n, p in port.named_parameters()) == [
        ("b", (1,)), ("u", (DIM,)), ("w", (DIM,))]
    check_forward(JaxPlanar(DIM), port, inputs(32, seed=1, scale=1.5), seed=2)
    _raises_as_cmf_tpu(JaxPlanar(DIM), port, inputs(4, seed=3))


class _IndexedPlanar(ConditionalPlanarBijection):
    """The conditional planar layer with its index fixed."""

    def __init__(self, u):
        super().__init__(DIM, NUM_U, [HIDDEN, HIDDEN], torch.tanh)
        self.u = u

    def forward(self, x):
        return super().forward(x, self.u)


class _JaxIndexed:
    def __init__(self, bij, u):
        self.bij, self.u = bij, u

    def init(self, key):
        return self.bij.init(key)

    def forward(self, variables, x):
        return self.bij.forward(variables, x, u=self.u)


def test_cond_planar_matches_cmf_tpu():
    """(u, w, b) from an MLP of the CIF index to 2D + 1 outputs."""
    u = inputs(32, seed=4)[:, :NUM_U]
    jax_bij = JaxCondPlanar(DIM, NUM_U, [HIDDEN, HIDDEN], jax_activation("tanh"))
    check_forward(_JaxIndexed(jax_bij, jnp.asarray(u)), _IndexedPlanar(t(u)), inputs(32, seed=5), seed=6)
    _raises_as_cmf_tpu(jax_bij, ConditionalPlanarBijection(DIM, NUM_U, [HIDDEN], torch.tanh),
                       inputs(4, seed=7), u[:4])


@pytest.mark.parametrize("degree", [4, 3], ids=["r4", "r3"])
def test_sos_matches_cmf_tpu_at_negative_and_large_inputs(degree):
    """The 2-D zoo's K = 2 polynomials of degree 4, and an odd degree; the
    inputs at scale 1.5, so that about a third lie beyond ±1 and half are
    negative, where an even power must stay positive and an odd one keep
    the sign: the powers against numpy's integer powers."""
    x = inputs(48, seed=8, scale=1.5)
    assert np.mean(x < 0) > 0.3 and np.mean(np.abs(x) > 1) > 0.2
    powers = integer_powers(t(x), 2 * degree + 1).numpy()
    want = np.stack([x.astype(np.float64) ** k for k in range(2 * degree + 2)], -1)
    assert np.all(np.sign(powers) == np.sign(want))
    assert rel_err(powers[..., -1], want[..., -1]) <= 1e-6
    jax_bij = JaxSOS(DIM, [HIDDEN, HIDDEN], jax_activation("tanh"), 2, degree)
    port = SumOfSquaresPolynomialBijection(DIM, [HIDDEN, HIDDEN], torch.tanh, 2, degree)
    assert port.c.shape == () and sorted(set(port.state_dict()) - {n for n, _ in port.named_parameters()}) == [
        "net.masks.0", "net.masks.1", "net.masks.2"]
    check_forward(jax_bij, port, x, seed=9)
    _raises_as_cmf_tpu(jax_bij, port, x[:4])


def test_logmatmulexp_matches_cmf_tpu_at_the_two_d_shapes():
    """At the 2-D zoo's BNAF blocks (d = 2, a = 45): within 1e-6. The
    ``1e-38`` inside the log is subnormal in fp32, so it can only show
    where a row's exp-sum underflows: there the port (which keeps
    subnormals on the CPU, as CUDA does) gives log(1e-38), and XLA's CPU
    runtime, which flushes subnormals to zero, gives -inf or the same."""
    r = np.random.default_rng(10)
    a = r.normal(size=(2, 45, 45)).astype(np.float32) * 3
    b = r.normal(size=(64, 2, 45, 1)).astype(np.float32) * 3
    want = jax.jit(jax_logmatmulexp)(jnp.asarray(a)[None], jnp.asarray(b))
    got = _logmatmulexp(t(a), t(b))
    assert got.shape == (64, 2, 45, 1)
    assert rel_err(got.numpy(), want) <= 1e-6
    # One row whose every product term is exp(-200) · 1, zero in fp32.
    a = np.array([[[0.0, -200.0]]], np.float32)
    b = np.array([[[-200.0], [0.0]]], np.float32)
    got = _logmatmulexp(t(a), t(b)).item()
    assert got == pytest.approx(float(np.log(np.float32(1e-38))), rel=1e-6)
    want = np.asarray(jax.jit(jax_logmatmulexp)(jnp.asarray(a), jnp.asarray(b))).item()
    assert want == -np.inf or want == pytest.approx(got, rel=1e-6)


@pytest.mark.parametrize("activation, residual", [
    ("soft-leaky-relu", False), ("soft-leaky-relu", True), ("tanh", "normal"), ("leaky-relu", "gated"),
])
def test_bnaf_matches_cmf_tpu(activation, residual):
    """Each activation and each ``residual`` value: a bool is no residual
    (the reference's quirk, kept), "normal" and "gated" the real modes (a
    ``gate`` param only for "gated"); the masks are non-persistent."""
    jax_bij = JaxBNAF(DIM, 1, 3, activation, residual)
    port = BlockNeuralAutoregressiveBijection(DIM, 1, 3, activation, residual)
    names = sorted(n for n, _ in port.named_parameters())
    assert names == sorted([f"layers.{i}.{k}" for i in range(3) for k in ("weight", "diag_weight", "bias")]
                           + (["gate"] if residual == "gated" else []))
    assert not port.state_dict().keys() - set(names)
    check_forward(jax_bij, port, inputs(32, seed=11, scale=1.5), seed=12)
    _raises_as_cmf_tpu(jax_bij, port, inputs(4, seed=13))


@pytest.mark.parametrize("reverse_mask", [False, True], ids=["even", "odd"])
def test_coupled_spline_matches_cmf_tpu(reverse_mask):
    """miniboone's ``nsf-c`` (cut): a residual MLP of width 8 and 1 block,
    4 bins, tails at ±3, inputs at scale 2 (some in the tails); its
    analytic one-pass inverse and the round trip. The residual MLP's first
    layer keeps the JAX key ``in``. The inverse is held at the round
    trip's tolerance: its log-jacobian at a root near a steep knot is
    fp32-conditioned (at one element of this batch both packages' eager
    splines are 1.5e-4 from fp64, and agree with each other)."""
    jax_bij = JaxCoupledSpline(DIM, 1, HIDDEN, 4, 3.0, jax_activation("relu"), 0.2, reverse_mask)
    port = CoupledRationalQuadraticSplineBijection(DIM, 1, HIDDEN, 4, 3.0, get_activation("relu"), 0.2,
                                                   reverse_mask)
    assert {"net.in.w", "net.in.b", "net.blocks.0.l1.w", "net.out.b"} <= {n for n, _ in port.named_parameters()}
    x = inputs(32, seed=14, scale=2.0)
    assert np.any(np.abs(x) > 3.0)
    check_bijection(jax_bij, port, x, seed=15, inverse_tol=ROUND_TRIP_TOL, round_trip_tol=ROUND_TRIP_TOL)


def _net(kind, package, n_in, n_out):
    if kind == "mlp":
        return JaxMLP(n_in, [HIDDEN], n_out, jax_activation("tanh")) if package == "jax" else \
            MLP(n_in, [HIDDEN], n_out, torch.tanh)
    if kind == "identity":
        return JaxIdentityNet() if package == "jax" else IdentityNetwork()
    fixed = kind == "fixed-constant"
    return JaxConstant((n_out,), 0.0, fixed) if package == "jax" else ConstantNetwork((n_out,), 0.0, fixed)


@pytest.mark.parametrize("kind", ["mlp", "learned-constant", "fixed-constant", "identity"])
def test_masked_coupling_with_each_flat_net_matches_cmf_tpu(kind):
    """A generic mask (channels 0, 2, 3, 5 pass, 1 and 4 change) with an
    MLP, a learned constant (a parameter), a fixed constant (a buffer, the
    JAX net's state) and the identity net (its 4 passthrough channels are
    the shift and log-scale of the 2 that change)."""
    mask = np.array([True, False, True, True, False, True])
    jax_bij = JaxMaskedCoupling((DIM,), lambda n: JaxChunked(_net(kind, "jax", n, 2 * (DIM - n))), mask)
    port = MaskedChannelwiseCouplingBijection(
        (DIM,), lambda n: ChunkedSharedCoupler(_net(kind, "port", n, 2 * (DIM - n))), mask)
    params = [n for n, _ in port.named_parameters()]
    assert params == {"mlp": ["coupler.net.layers.0.w", "coupler.net.layers.0.b", "coupler.net.layers.1.w",
                              "coupler.net.layers.1.b"],
                      "learned-constant": ["coupler.net.value"]}.get(kind, [])
    assert list(port.state_dict()) == params + (["coupler.net.value"] if kind == "fixed-constant" else [])
    check_bijection(jax_bij, port, inputs(32, seed=16), seed=17, round_trip_tol=INV_TOL)


def test_tanh_matches_cmf_tpu():
    """tanh, log tanh'(x) = 2(log 2 − x − softplus(−2x)); the inverse at
    the reconstructed point, and clipped to ±(1 − 1e-7) at the edges."""
    check_bijection(JaxTanh((DIM,)), TanhBijection((DIM,)), inputs(32, seed=18, scale=1.5),
                    round_trip_tol=1e-4)
    z = np.array([[-1.0, 1.0, 0.999999, -0.5, 1.5, 0.0]], np.float32)
    x_j, lj_j = jax.jit(lambda zz: JaxTanh((DIM,)).inverse(None, zz))(jnp.asarray(z))
    x_t, lj_t = TanhBijection((DIM,)).inverse(t(z))
    assert rel_err(x_t.numpy(), x_j) <= FWD_TOL and rel_err(lj_t.numpy(), lj_j) <= FWD_TOL


def _load_inverted(port, tree):
    """A z-to-x composite's layers are ``InverseBijection``s: each JAX
    layer's tree is its wrapped bijection's."""
    for layer, params, state in zip(port.layers, tree["params"]["layers"], tree["state"]["layers"]):
        variables_from_jax(layer.bijection, {"params": params, "state": state})


def _inverted_path(name):
    return jax_path(name.replace(".bijection.", "."))


@pytest.mark.parametrize("direction", ["x-to-z", "z-to-x"])
def test_composite_identity_and_inverse_match_cmf_tpu(direction):
    """LU linear, tanh, an identity and a masked coupling chained in each
    direction (z-to-x inverts every layer and reverses the list), log
    jacobians summed; both directions of the chain."""
    mask = np.array([True, False] * (DIM // 2))

    def chain(package):
        if package == "jax":
            coupling = JaxMaskedCoupling((DIM,), lambda n: JaxChunked(_net("mlp", "jax", n, 2 * (DIM - n))), mask)
            return JaxComposite([JaxLULinear(DIM), JaxTanh((DIM,)), JaxIdentity((DIM,)), coupling], direction)
        coupling = MaskedChannelwiseCouplingBijection(
            (DIM,), lambda n: ChunkedSharedCoupler(_net("mlp", "port", n, 2 * (DIM - n))), mask)
        return CompositeBijection([LULinearBijection(DIM), TanhBijection((DIM,)), IdentityBijection((DIM,)),
                                   coupling], direction)

    port = chain("port")
    load, path = (variables_from_jax, jax_path) if direction == "x-to-z" else (_load_inverted, _inverted_path)
    # x-to-z maps through tanh last but one, z-to-x through artanh: keep
    # its inputs inside (-1, 1).
    x = inputs(32, seed=19, scale=1.0 if direction == "x-to-z" else 0.15)
    check_bijection(chain("jax"), port, x, seed=20, round_trip_tol=INV_TOL, load=load,
                    path=path)


def test_mixture_density_matches_cmf_tpu():
    """Two LU linear bijections over one standard Gaussian, weighted by an
    MLP of z: the elbo (a logsumexp over the bijections) and its gradients;
    ``sample`` on the JAX package's prior draw and categorical indices,
    and on a generator of its own."""
    k, n = 2, 40
    jd = JaxMixture(JaxGaussian((DIM,)), [JaxLULinear(DIM) for _ in range(k)],
                    JaxMLP(DIM, [HIDDEN], k, jax_activation("tanh")))
    td = BijectionMixtureDensity(DiagonalGaussianDensity((DIM,)), [LULinearBijection(DIM) for _ in range(k)],
                                 MLP(DIM, [HIDDEN], k, torch.tanh))
    jv = jd.init(jax.random.PRNGKey(21))
    # Off the near-identity init, where both components map x alike and the
    # weight map's gradient cancels to fp32 noise.
    leaves, treedef = jax.tree.flatten(jv["params"])
    keys = jax.random.split(jax.random.PRNGKey(121), len(leaves))
    leaves = [p + 0.3 * jax.random.normal(kk, p.shape) for p, kk in zip(leaves, keys)]
    jv = {"params": jax.tree.unflatten(treedef, leaves), "state": jv["state"]}
    variables_from_jax(td, to_numpy(jv))
    assert {n.split(".")[0] for n, _ in td.named_parameters()} == {"bijections", "weight_map"}
    x = inputs(n, seed=22)

    def loss(p):
        info, _ = jd.elbo({"params": p, "state": jv["state"]}, jnp.asarray(x))
        return -jnp.mean(info["elbo"]), info["elbo"]

    (_, elbo_j), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(jv["params"])
    elbo_t = td.elbo(t(x))["elbo"]
    (-elbo_t.mean()).backward()
    assert rel_err(elbo_t.detach().numpy(), elbo_j) <= FWD_TOL
    assert_grads_close(td, grads_j, GRAD_TOL)

    key = jax.random.PRNGKey(23)
    x_j = jax.jit(lambda v: jd.sample(v, key, n))(jv)
    r1, r2 = jax.random.split(key)
    z = jd.prior.sample(None, r1, n)
    logits, _ = jd.weight_map.apply({"params": jv["params"]["weight_map"], "state": {}}, z)
    indices = jax.random.categorical(r2, logits, axis=-1)
    assert 0 < int(indices.sum()) < n  # both components drawn
    got = td.sample(n, noise=t(z), indices=torch.as_tensor(np.asarray(indices)))
    assert rel_err(got.numpy(), x_j) <= INV_TOL
    own = td.sample(n, generator=torch.Generator().manual_seed(0))
    assert own.shape == (n, DIM) and torch.isfinite(own).all()


def test_concrete_density_matches_cmf_tpu():
    """Maddison et al.'s eq. (10) with the 1e-20 inside the log: log_prob and
    its gradients in the net's weights; ``sample`` on the JAX package's
    Gumbel draw, and on a generator of its own. The JAX tree is the net's,
    so it loads into ``log_alpha_map``."""
    k, lam, n = 4, 0.7, 24
    jd = JaxConcrete(JaxMLP(DIM, [HIDDEN], k, jax_activation("tanh")), lam)
    td = ConcreteConditionalDensity(MLP(DIM, [HIDDEN], k, torch.tanh), lam)
    jv = jd.init(jax.random.PRNGKey(24))
    variables_from_jax(td.log_alpha_map, to_numpy(jv))
    cond = inputs(n, seed=25)
    simplex = np.random.default_rng(26).dirichlet(np.ones(k), size=n).astype(np.float32)
    simplex[0, 0] = 0.0  # the 1e-20 keeps the log finite
    simplex[0] /= simplex[0].sum()

    def loss(v):
        lp = jd.log_prob(v, jnp.asarray(simplex), jnp.asarray(cond))
        return jnp.sum(lp), lp

    (_, lp_j), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(jv)
    lp_t = td.log_prob(t(simplex), t(cond))
    lp_t.sum().backward()
    assert np.all(np.isfinite(lp_t.detach().numpy()))
    assert rel_err(lp_t.detach().numpy(), lp_j) <= FWD_TOL
    assert_grads_close(td.log_alpha_map, grads_j["params"], GRAD_TOL)

    key = jax.random.PRNGKey(27)
    s_j, slp_j = jax.jit(lambda v: jd.sample(v, key, jnp.asarray(cond)))(jv)
    gumbel = jax.random.gumbel(key, (n, k))
    with torch.no_grad():
        s_t, slp_t = td.sample(t(cond), gumbel=t(gumbel))
        own, own_lp = td.sample(t(cond), generator=torch.Generator().manual_seed(0))
    assert rel_err(s_t.numpy(), s_j) <= FWD_TOL and rel_err(slp_t.numpy(), slp_j) <= FWD_TOL
    assert torch.allclose(own.sum(-1), torch.ones(n)) and torch.isfinite(own_lp).all()


def test_tanh_layer_builds_as_cmf_tpu():
    """The factory's ``tanh`` layer over a standard Gaussian: the elbo of
    both packages, and a fixed sample through the inverse."""
    from _torch_parity import build_pair

    jd, jv, td = build_pair([{"type": "tanh"}], dim=DIM, seed=28)
    x = inputs(16, seed=29, scale=1.5)
    elbo_j = jax.jit(lambda v, xx: jd.elbo(v, xx)[0]["elbo"])(jv, jnp.asarray(x))
    assert rel_err(td.elbo(t(x))["elbo"].detach().numpy(), elbo_j) <= FWD_TOL
    noise = np.random.default_rng(30).uniform(-0.95, 0.95, size=(8, DIM)).astype(np.float32)
    x_j = jax.jit(lambda v, n: jd.fixed_sample(v, noise=n))(jv, jnp.asarray(noise))
    assert rel_err(td.fixed_sample(t(noise)).numpy(), x_j) <= INV_TOL
