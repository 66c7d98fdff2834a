"""coupler_stack_roofline: the fp32 ResNet coupler kernel's share of its
roofline over the traced FID pass, in %: the least time of every launch at
its own shape (``counts/coupler_stack.py``; a chunk's launches from the
configuration's chain) over the kernel's device time. Only where the trace
holds a launch for every coupler of every chunk."""

from portbench.counts import cmf_flow, coupler_stack, least_seconds
from portbench.harness.trace import kernel_time


def read(ctx):
    s = ctx.get("trace")
    if not s:
        return None
    seconds, launches = kernel_time(s, r"\bcoupler_stack_kernel\b")
    cfgfile = ctx["cell"].cfgfile
    shapes = cmf_flow.coupler_launches(cfgfile, cfgfile["config"]["test_batch_size"])
    if launches == 0 or launches != s["units"] * len(shapes):
        return None
    least = s["units"] * sum(least_seconds(*coupler_stack.launch(*shape)) for shape in shapes)
    return 100.0 * least / seconds
