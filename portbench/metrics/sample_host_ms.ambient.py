"""sample_host_ms.ambient: the host's time a chunk in the program's
``sample`` span (``Density.sample``) outside its child spans
(``sample/latent``, ``ops/coupler_stack``): the ambient chain's inverse,
under the profiler over the traced FID pass; None where the program has no
such span. With ``sample_host_ms.latent`` and
``sample_host_ms.coupler_launch`` it sums to the whole ``sample`` span."""

from portbench.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, "sample", "self_s")
