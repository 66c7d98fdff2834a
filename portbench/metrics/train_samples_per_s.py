"""train_samples_per_s: all training samples of the steps completed in the
window over the window's seconds; the window ends in the host read of its
last epoch, which waits for the device."""


def read(ctx):
    return ctx["samples"] / ctx["window_s"]
