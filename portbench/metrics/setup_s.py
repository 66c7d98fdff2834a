"""setup_s: from the start of the process to the start of the window:
imports, CUDA context, data, model, weights, warm-up, graph capture and, in
a checkout's first run, the kernels' build."""


def read(ctx):
    return ctx["setup_s"]
