"""step_device_ms.optimizer: device time a step owned by the program's
``step/optimizer`` span: the gradient norm, Adam (``training/optim.py``)
and the freeze of ``Trainer._step_fn``. From the eager guard steps of the
traced run, which run the kernels the graph replays. None where the
program has no such span."""

from portbench.harness.spans import eager_device_ms


def read(ctx):
    return eager_device_ms(ctx, "step/optimizer")
