"""sample_enqueue_ms: the host's time a chunk from the call of
``density.sample`` to its return, with no synchronize, the mean over the
window's chunks (the benchmark's span around the program's call, timed in
the traced run's window)."""


def read(ctx):
    spans = ctx.get("enqueue_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
