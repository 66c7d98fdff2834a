"""gram_logdet_bwd_roofline: the backward Gram/log-det kernel's share of its
roofline, in %: the least time of each launch (the larger of its FLOPs over
the peak and its bytes over the bandwidth, ``counts/gram_logdet.py`` at the
training batch's (d, B, D)) over the kernel's device time in the traced
steps. Only where the trace holds the captured graph's kernels."""

import math

from portbench.counts import gram_logdet, least_seconds
from portbench.harness.trace import kernel_time


def read(ctx):
    s = ctx.get("trace")
    if not s or not s["graph_kernels_seen"]:
        return None
    seconds, launches = kernel_time(s, r"\bgram_logdet_bwd_kernel\b")
    if launches == 0:
        return None
    cfgfile = ctx["cell"].cfgfile
    shape = (cfgfile["config"]["latent_dimension"], cfgfile["config"]["train_batch_size"],
             math.prod(cfgfile["architecture"]["x_shape"]))
    return 100.0 * launches * least_seconds(*gram_logdet.backward(*shape)) / seconds
