"""step_launch_ms.train: the host's time a step inside the program's
``train/replay`` span (``graph.replay()`` of the captured step,
``training/trainer.py``), over the traced steps; None where the program has
no such span (an eager step, or a program without spans)."""

from portbench.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, "train/replay")
