"""Plain reference of the miniboone CMF training step: the loss of
``flows.py``'s non-square flow on a batch, its gradient by autograd, and
optax's Adam (its bias corrections in float32, as optax computes them),
step by step from the benchmark's initial weights.

The decoder's Jacobian is pushed forward explicitly, column by column,
through each coupling's inverse (no ``torch.func``); its Gram's log-det is
2·Σ log diag of the Cholesky factor, and where a batch's factor is not
finite the whole batch takes the first level of the jitter ladder
(1e-6, ×10 a try, summed as float32, at most 6 tries) whose factor is.
A step whose loss or gradient norm is not finite leaves every state as it
was.
"""

import math

import torch

from portbench.reference import flows

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
JITTER0, JITTER_FACTOR, JITTER_TRIES = 1e-6, 10.0, 6

param_specs = flows.param_specs
permutation_size = flows.permutation_size


def _pow32(base, exponent):
    """base**exponent as optax's bias correction computes it: a float32
    power of float32 operands."""
    return torch.pow(torch.tensor(base, dtype=torch.float32), torch.tensor(float(exponent)))


def encode_low(params, x, perm, d, arith):
    h = x
    for layer, _, leaves, _ in params.x:
        h, _ = flows.flat_forward(layer, leaves, h, arith)
    return h[:, perm][:, :d]


def decode(params, low, perm, arith, tangents):
    """decode(low) (B, D) and, with ``tangents``, its Jacobian as d rows
    (B, d, D)."""
    batch, d = low.shape
    big_d = perm.numel()
    inv = torch.argsort(perm)
    y = torch.cat([low, low.new_zeros(batch, big_d - d)], dim=1)[:, inv]
    dy = None
    if tangents:
        basis = torch.eye(d, big_d, dtype=low.dtype, device=low.device)[:, inv]
        dy = basis.expand(batch, d, big_d).clone()
    for layer, _, leaves, _ in reversed(params.x):
        y, dy = flows.flat_inverse(layer, leaves, y, arith, dy)
    return y, dy


def log_det_gram(jac, arith):
    """(log|JᵀJ| (B,), jitter used) of the d rows ``jac`` (B, d, D)."""
    gram = arith.mm(jac, jac.mT)
    d = gram.shape[-1]
    eye = torch.eye(d, dtype=gram.dtype, device=gram.device)
    total = torch.zeros((), dtype=gram.dtype, device=gram.device)
    eps = torch.full((), JITTER0, dtype=gram.dtype, device=gram.device)
    with torch.no_grad():
        levels, g = [total.clone()], gram.detach()
        for _ in range(JITTER_TRIES):
            total = total + eps
            levels.append(total.clone())
            eps = eps * JITTER_FACTOR
        chosen = levels[-1]
        for level in levels:
            factor, info = torch.linalg.cholesky_ex(g + level * eye)
            if not bool(info.any()) and bool(torch.isfinite(factor).all()):
                chosen = level
                break
    factor = torch.linalg.cholesky_ex(gram + chosen * eye)[0]
    return 2.0 * torch.log(torch.diagonal(factor, dim1=-2, dim2=-1)).sum(dim=-1), float(chosen)


def loss(params, x, perm, d, flags, arith, regularization):
    """−mean(elbo) of the batch ``x`` under the epoch's ``flags``."""
    low = encode_low(params, x, perm, d, arith)
    low_dim = flows.prior_log_prob(params, low, arith)
    if flags["skip_likelihood"]:
        recon, _ = decode(params, low, perm, arith, tangents=False)
        likelihood, jitter = 0.0, 0.0
    else:
        recon, jac = decode(params, low, perm, arith, tangents=True)
        log_det, jitter = log_det_gram(jac, arith)
        likelihood = low_dim - log_det / 2.0
    recon_loss = ((recon - x) ** 2).sum(dim=1)
    elbo = flags["likelihood_wt"] * likelihood - regularization * recon_loss
    return -elbo.mean(), jitter


def train_steps(cfgfile, init, perm, batches, flags, arith=flows.FP32):
    """Adam steps from ``init`` over ``batches``: {"losses", "grad1" (the
    first step's gradient, leaf by leaf), "params" (after the last step),
    "jitter" (the ladder's level at each step)}."""
    flows.pin_fp32()
    cfg = cfgfile["config"]
    leaves = [t.detach().clone().requires_grad_(True) for t in init]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    params = flows.Params(cfgfile, leaves)
    out = {"losses": [], "grad1": None, "jitter": []}
    for step, x in enumerate(batches, start=1):
        value, jitter = loss(params, x, perm, cfg["latent_dimension"], flags, arith, cfg["regularization_param"])
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        out["losses"].append(float(value.detach()))
        out["jitter"].append(jitter)
        if out["grad1"] is None:
            out["grad1"] = [g.detach().clone() for g in grads]
        norm = math.sqrt(sum(float((g * g).sum()) for g in grads))
        if not (math.isfinite(float(value.detach())) and math.isfinite(norm)):
            continue
        with torch.no_grad():
            for t, g, m, v in zip(leaves, grads, mu, nu):
                m.copy_(g * (1 - ADAM_B1) + m * ADAM_B1)
                v.copy_((g * g) * (1 - ADAM_B2) + v * ADAM_B2)
                m_hat = m / (1 - _pow32(ADAM_B1, step))
                v_hat = v / (1 - _pow32(ADAM_B2, step))
                # optax's order: the Adam direction, scaled by −lr, added
                t.add_(m_hat / (torch.sqrt(v_hat) + ADAM_EPS) * -cfg["lr"])
    out["params"] = [t.detach() for t in leaves]
    return out
