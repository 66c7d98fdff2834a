"""step_device_ms.logdet_fallback: device time a step owned by the
program's ``head/logdet_fallback`` span: the jitter fallback
(``_kernel_or_fallback`` in ``densities/nonsquare.py``: the jittered
Cholesky of ``ops/chol.py`` on the selected Gram, the selects and the
counter), forward and backward. From the eager guard steps of the traced
run, which run the kernels the graph replays; a backward kernel counts
under the forward span that built its node (``harness/spans.py``). None
where the program has no such span."""

from portbench.harness.spans import eager_device_ms


def read(ctx):
    return eager_device_ms(ctx, "head/logdet_fallback")
