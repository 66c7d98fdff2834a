"""sample_samples_per_s: all samples of the chunks drawn in the window's
FID passes over the window's seconds; the window ends in the host read of
its last pass, which waits for the device."""


def read(ctx):
    return ctx["samples"] / ctx["window_s"]
