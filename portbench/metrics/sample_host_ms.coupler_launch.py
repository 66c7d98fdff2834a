"""sample_host_ms.coupler_launch: the host's time a chunk inside the
program's ``ops/coupler_stack`` span (``coupler_stack_cuda``, from its entry
through the kernel's launch: the plan, the packed weights' cache, the
ctypes call), under the profiler over the traced FID pass; None where the
program has no such span."""

from portbench.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, "ops/coupler_stack")
