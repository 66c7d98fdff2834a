"""Operation and byte counts of the benchmark's kernels and models, from
their shapes, and the table of peaks they are held against. Each FLOP is
counted once, each input byte read once and each output byte written once,
whatever an implementation recomputes or reads again."""

import json
from pathlib import Path


def peaks():
    with open(Path(__file__).with_name("peaks.json")) as f:
        return json.load(f)


def least_seconds(flops, nbytes):
    """The least time the chip could take: the larger of the FLOPs over the
    peak rate and the bytes over the bandwidth."""
    p = peaks()
    return max(flops / p["flops_per_s"], nbytes / p["bytes_per_s"])
