"""mfu.sample: the whole sampling chunk's share of the chip's peak, in %: a
chunk's model FLOPs (``counts/cmf_flow.py``) times the chunks of the window,
over the window's seconds, over the peak (``counts/peaks.json``)."""

from portbench.counts import cmf_flow, peaks


def read(ctx):
    cfgfile = ctx["cell"].cfgfile
    flops = cmf_flow.sample_chunk_flops(cfgfile, cfgfile["config"]["test_batch_size"]) * ctx["units"]
    return 100.0 * flops / ctx["window_s"] / peaks()["flops_per_s"]
