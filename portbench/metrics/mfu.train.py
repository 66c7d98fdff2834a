"""mfu.train: the whole training step's share of the chip's peak, in %: the
step's model FLOPs (``counts/cmf_flow.py``) times the steps of the window,
over the window's seconds, over the peak (``counts/peaks.json``)."""

from portbench.counts import cmf_flow, peaks


def read(ctx):
    flops = cmf_flow.train_step_flops(ctx["cell"].cfgfile, ctx["likelihood"]) * ctx["units"]
    return 100.0 * flops / ctx["window_s"] / peaks()["flops_per_s"]
