"""idle_share.train: one less the union of the device intervals over the
traced steps' wall time, in %; only where the trace holds the captured
graph's kernels."""


def read(ctx):
    s = ctx.get("trace")
    if not s or not s["graph_kernels_seen"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
