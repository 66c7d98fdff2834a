"""Model FLOPs of the CMF configurations, from their shapes: the forward
pass, plus twice it for the backward of what is differentiated. The dense
and conv layers' multiply-adds are counted (the elementwise work, the
Cholesky's d³/3 and the Gaussian's sums are under 1% of them); the jitter
ladder's retries and anything an implementation recomputes are left out.
The layers come from the configuration's ``architecture``, as the reference
reads them."""

import math

from portbench.counts import coupler_stack, gram_logdet
from portbench.reference import flows


def _split(cfgfile):
    layers = flows.couplers(cfgfile)
    n_x = sum(1 for layer in cfgfile["architecture"]["x_layers"] if layer["type"] not in ("squeeze", "split"))
    return layers[:n_x], layers[n_x:]


def mlp_row_flops(specs):
    """2·in·out summed over a dense stack's weights: one row through it."""
    return sum(2 * shape[0] * shape[1] for leaf, shape, _, _ in specs if leaf == "w")


def train_step_flops(cfgfile, likelihood):
    """One step of the tabular CMF: the encode, the latent prior and the
    decode of B rows, and with the likelihood the d tangent rows a row that
    the decoder's Jacobian pushes through the chain, with the Gram and its
    factor. Without it the prior's value is computed and not differentiated."""
    cfg = cfgfile["config"]
    batch, d = cfg["train_batch_size"], cfg["latent_dimension"]
    big_d = math.prod(cfgfile["architecture"]["x_shape"])
    x_layers, prior = _split(cfgfile)
    if any(net != "mlp" for _, net, _, _ in x_layers):
        raise ValueError("train_step_flops counts flat chains only")
    cx = sum(mlp_row_flops(specs) for _, _, specs, _ in x_layers)
    cp = sum(mlp_row_flops(specs) for _, _, specs, _ in prior)
    differentiated = 2 * batch * cx
    undifferentiated = batch * cp
    if likelihood:
        differentiated += d * batch * cx + batch * cp + gram_logdet.forward(d, batch, big_d)[0]
        undifferentiated = 0
    return undifferentiated + 3 * differentiated


def coupler_launches(cfgfile, n):
    """(B, C_in, C_out, H, W, hidden, blocks) of each ResNet coupler that a
    sample of ``n`` images runs once, in the chain's order."""
    x_layers, _ = _split(cfgfile)
    out = []
    for _, net, specs, shape in x_layers:
        if net == "resnet":
            c_out, hidden = specs[-2][1][0], specs[-2][1][1]
            c_in = specs[2][1][1]
            out.append((n, c_in, c_out, shape[1], shape[2], hidden, (len(specs) - 5) // 4))
    return out


def sample_chunk_flops(cfgfile, n):
    """One ``sample(n)``: the latent prior's inverse and every coupler of
    the image chain's inverse."""
    _, prior = _split(cfgfile)
    cp = sum(mlp_row_flops(specs) for _, _, specs, _ in prior)
    return n * cp + sum(coupler_stack.launch(*shape)[0] for shape in coupler_launches(cfgfile, n))
