"""Plain reference of the mnist CMF sampler: a standard Gaussian draw in d
dimensions through the latent RealNVP's inverse, the tail's zero-padding
and un-permutation, the multiscale chain's inverse (checkerboard and
split-channel couplings with ResNet couplers, the squeeze and the
non-square split) and the inverse of the preprocessing (logit, the added
1e-6, the scale by 1/256)."""

from portbench.reference import flows

param_specs = flows.param_specs
permutation_size = flows.permutation_size


def sample(cfgfile, init, perm, eps, arith=flows.FP32):
    """The images of the Gaussian draws ``eps`` (n, d)."""
    flows.pin_fp32()
    params = flows.Params(cfgfile, list(init))
    low = flows.prior_sample(params, eps, arith)
    return flows.image_decode(cfgfile, params, low, perm, arith)
