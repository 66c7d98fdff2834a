"""Small cells for the CPU tests: the published configurations at cut
widths and few rows, so that a step takes milliseconds."""

import time

from portbench.harness.cell import ROOT, load_cell, load_json

TRAIN = {"coupler_hidden_channels": [16, 16], "prior_hidden_channels": [8], "train_batch_size": 40}
SAMPLE = {"g_hidden_channels": [8, 8], "prior_hidden_channels": [8], "test_batch_size": 4, "num_fid_samples": 40}


def bench():
    return load_json(ROOT / "BENCHMARK.json")


def cell(workload, seed=2**31 + 77, seconds=0.3, trace=False):
    overrides = SAMPLE if workload == "mnist-fid-sample" else TRAIN
    c = load_cell(bench(), workload, seed, seconds, trace, device="cpu", overrides=overrides, start=time.perf_counter())
    c.cfgfile["assumed"] = {**c.cfgfile["assumed"], "train_rows": 200}
    return c
