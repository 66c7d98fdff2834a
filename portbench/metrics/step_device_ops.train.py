"""step_device_ops.train: device operations (kernels, copies, fills) a
training step, from the traced steps; only where the trace holds the
captured graph's kernels."""


def read(ctx):
    s = ctx.get("trace")
    if not s or not s["graph_kernels_seen"]:
        return None
    return s["device_ops"] / s["units"]
