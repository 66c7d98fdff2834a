"""The program's layer spans (``cmf_tpu_torch/tracing.py``): with no
profiler recording, a step and a ``sample`` enter no ``record_function``;
under a CPU ``torch.profiler`` (the trainer's ``profile_dir`` epoch) each
span of a miniboone-shaped non-square model sits at its boundary, under its
parent; ``Trainer.timings`` counts as before; and the facility brings no
environment variable, CLI flag or config key."""

import inspect
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cmf_tpu_torch import tracing
from cmf_tpu_torch.config import get_config
from cmf_tpu_torch.main import build_parser
from cmf_tpu_torch.training.experiment import setup_experiment

# miniboone's D=43 at cut widths: 3 steps of 40 rows an epoch, d=5 inside
# the fused log-det's gate, so a likelihood step takes the jitter fallback.
SMALL = {"max_dataset_size": 120, "train_batch_size": 40, "coupler_hidden_channels": [16],
         "prior_hidden_channels": [8], "num_density_layers": 2, "prior_num_density_layers": 2,
         "latent_dimension": 5, "use_fid": False, "early_stopping": False}
EPOCH = 60  # likelihood weight 1

# Each span an eager CPU epoch and a sample give, and its parent in them.
PARENTS = {
    "loader/batch": None,
    "train/step": None,
    "train/epoch_read": None,
    "step/forward": "train/step",
    "step/backward": "train/step",
    "step/optimizer": "train/step",
    "head/encode": "step/forward",
    "head/decode_jacobian": "step/forward",
    "head/gram_logdet": "step/forward",
    "head/logdet_fallback": "step/forward",
    "sample": None,
    "sample/latent": "sample",
}


@pytest.fixture(scope="module")
def trainer():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    config = {"model": "non-square", "dataset": "miniboone", **get_config("miniboone", "non-square", False),
              **SMALL, "seed": 5, "synthetic_data": True}
    try:
        yield setup_experiment(config, write_to_disk=False, device="cpu")["trainer"]
    finally:
        torch.set_num_threads(threads)


class _Counted:
    """``record_function`` that counts its constructions."""

    calls = 0

    def __init__(self, real):
        self.real = real

    def __call__(self, *args, **kwargs):
        _Counted.calls += 1
        return self.real(*args, **kwargs)


def _parents(events):
    """span name → the set of names of the spans directly around it."""
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"], e["name"][4:]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("cmf/")),
                   key=lambda s: (s[2], s[0], -s[1]))
    out, stack = {}, []
    for start, end, tid, name in spans:
        while stack and (stack[-1][2] != tid or stack[-1][1] < start):
            stack.pop()
        out.setdefault(name, set()).add(stack[-1][3] if stack else None)
        stack.append((start, end, tid, name))
    return out


def test_no_profiler_enters_no_record_function(trainer, monkeypatch):
    counted = _Counted(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    _Counted.calls = 0
    flags = trainer.objective.for_epoch(EPOCH)
    x = next(iter(trainer.train_loader))
    trainer.eager_step(x, flags)
    trainer.step(x, flags)
    trainer.density.sample(8)
    assert _Counted.calls == 0
    assert tracing.span("train/step") is tracing.span("sample")
    # The same calls under a profiler do enter it: the count above is not
    # blind.
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.eager_step(x, flags)
        trainer.density.sample(8)
    assert _Counted.calls == len(PARENTS) - 2  # all but the epoch's loader/batch and read


def test_profiled_epoch_and_sample_nest_each_span_under_its_parent(trainer, tmp_path):
    trainer.profile_dir, trainer.profile_path = str(tmp_path), None
    calls = trainer.timings.get("train", [0, 0.0])[0]
    try:
        trainer._train_epoch(EPOCH)
    finally:
        trainer.profile_dir = None
    assert trainer.profile_path is not None
    with open(trainer.profile_path) as f:
        epoch = json.load(f)["traceEvents"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.density.sample(8)
    prof.export_chrome_trace(str(tmp_path / "sample.json"))
    with open(tmp_path / "sample.json") as f:
        sample = json.load(f)["traceEvents"]
    parents = {**_parents(epoch), **_parents(sample)}
    assert {name: parents.get(name) for name in PARENTS} == {name: {p} for name, p in PARENTS.items()}
    steps = len(trainer.train_loader)
    counts = {}
    for e in epoch + sample:
        if e.get("cat") == "user_annotation" and e["name"].startswith("cmf/"):
            counts[e["name"][4:]] = counts.get(e["name"][4:], 0) + 1
    assert counts == {**{name: steps for name in PARENTS}, "train/epoch_read": 1, "sample": 1, "sample/latent": 1}
    # Trainer.timings keeps its count: one "train" entry an epoch, profiled
    # or not.
    trainer._train_epoch(EPOCH)
    assert trainer.timings["train"][0] == calls + 2
    # A timed block keeps its count under a profiler, and adds no span.
    before = trainer.timings.get("checkpoint", [0, 0.0])[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trainer._timed("checkpoint"):
            pass
    assert not [e.name for e in prof.events() if e.name.startswith("cmf/")]
    assert trainer.timings["checkpoint"][0] == before + 1


def test_spans_bring_no_option():
    source = inspect.getsource(tracing)
    for word in ("environ", "getenv", "argparse"):
        assert word not in source
    public = {n for n, v in vars(tracing).items() if not n.startswith("_") and not inspect.ismodule(v)}
    assert public == {"span"}
    flags = [s for a in build_parser()._actions for s in a.option_strings]
    assert not [f for f in flags if "span" in f or "trac" in f]
    for dataset, model in (("miniboone", "non-square"), ("mnist", "non-square")):
        keys = get_config(dataset, model, False)
        assert not [k for k in keys if "span" in k or "trac" in k]
