"""idle_share.sample: one less the union of the device intervals over the
traced FID pass's wall time, in %."""


def read(ctx):
    s = ctx.get("trace")
    if not s or not s["graph_kernels_seen"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
