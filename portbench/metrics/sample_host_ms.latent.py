"""sample_host_ms.latent: the host's time a chunk inside the program's
``sample/latent`` span (``densities/nonsquare.py``, the tail's ``_sample``:
the low-dimensional prior's draw and its lift to D), under the profiler over
the traced FID pass; None where the program has no such span."""

from portbench.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, "sample/latent")
