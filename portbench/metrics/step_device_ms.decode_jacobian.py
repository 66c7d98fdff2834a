"""step_device_ms.decode_jacobian: device time a step owned by the
program's ``head/decode_jacobian`` span: the decode-Jacobian program
(``_exact_log_det`` in ``densities/nonsquare.py``, ``ops/decode_jac.py``),
forward and backward. From the eager guard steps of the traced run, which
run the kernels the graph replays; a backward kernel counts under the
forward span that built its node (``harness/spans.py``). None where the
program has no such span."""

from portbench.harness.spans import eager_device_ms


def read(ctx):
    return eager_device_ms(ctx, "head/decode_jacobian")
