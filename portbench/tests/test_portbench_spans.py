"""The reduction of a trace to the program's spans (``harness/spans.py``):
self time, ownership by correlation, a backward kernel paired with its
forward span by ``Sequence number``, ``(none)``; the same pairing on the
CPU ops of a real profiled step; the summary's keys unmoved by the spans;
the span metrics' readers, on stretches with spans and without, measured
once a run and not where the program has no spans; and the stretches of
each cell, set up again, at small widths on the CPU."""

import importlib.util
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench.harness import spans, trace
from portbench.harness.cell import BENCH_DIR, load_module
from portbench.tests import small

MAIN, AUTOGRAD, OTHER = 1, 2, 3


def x(name, cat, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": args}


def launch(ts, corr, tid=MAIN, name="cudaLaunchKernel"):
    return x(name, "cuda_runtime", ts, 1.0, tid, correlation=corr)


def kernel(name, ts, dur, corr):
    return x(name, "kernel", ts, dur, 7, correlation=corr)


def cmf(name, ts, dur):
    return x("cmf/" + name, "user_annotation", ts, dur)


EVENTS = [
    x(trace.WINDOW, "user_annotation", 1000.0, 200.0),
    cmf("train/step", 1000.0, 150.0),
    cmf("step/forward", 1005.0, 45.0),
    cmf("head/logdet_fallback", 1010.0, 20.0),
    cmf("step/backward", 1055.0, 45.0),
    cmf("step/optimizer", 1105.0, 35.0),
    cmf("train/replay", 1145.0, 3.0),
    # Forward ops on the main thread (their "Fwd thread id" is 0), and one
    # with a colliding sequence number on another thread.
    x("aten::sqrt", "cpu_op", 1012.0, 3.0, **{"Sequence number": 7, "Fwd thread id": 0}),
    x("aten::mm", "cpu_op", 1040.0, 5.0, **{"Sequence number": 8, "Fwd thread id": 0}),
    x("aten::sqrt", "cpu_op", 1013.0, 1.0, OTHER, **{"Sequence number": 7, "Fwd thread id": 0}),
    # The autograd engine's thread: two nodes of the forward thread, and the
    # gradient's accumulation, which has no forward op.
    x(spans.EVALUATE + "SqrtBackward0", "cpu_op", 1060.0, 10.0, AUTOGRAD,
      **{"Sequence number": 7, "Fwd thread id": 1}),
    x(spans.EVALUATE + "MmBackward0", "cpu_op", 1071.0, 9.0, AUTOGRAD,
      **{"Sequence number": 8, "Fwd thread id": 1}),
    x(spans.EVALUATE + "torch::autograd::AccumulateGrad", "cpu_op", 1081.0, 9.0, AUTOGRAD),
    launch(1013.0, 1),
    launch(1062.0, 2, AUTOGRAD),
    launch(1073.0, 3, AUTOGRAD),
    launch(1085.0, 4, AUTOGRAD),
    launch(1110.0, 5),
    launch(1146.0, 6, name="cudaGraphLaunch"),
    launch(1160.0, 8),
    kernel("sqrt_fwd", 1014.0, 2.0, 1),
    kernel("sqrt_bwd", 1063.0, 3.0, 2),
    kernel("mm_bwd", 1074.0, 4.0, 3),
    kernel("accumulate", 1086.0, 1.0, 4),
    kernel("adam", 1111.0, 5.0, 5),
    kernel("graph_a", 1147.0, 2.0, 6),
    kernel("graph_b", 1149.0, 2.0, 6),
    kernel("after", 1161.0, 4.0, 8),
    kernel("uncorrelated", 1170.0, 1.0, 99),
    kernel("outside", 900.0, 5.0, 1),
]


def test_host_and_self_time():
    s = spans.reduce(EVENTS, (1000.0, 1200.0))
    assert s["train/step"]["count"] == 1
    assert s["train/step"]["host_s"] == pytest.approx(150e-6)
    assert s["train/step"]["self_s"] == pytest.approx((150 - 45 - 45 - 35 - 3) * 1e-6)
    assert s["step/forward"]["self_s"] == pytest.approx(25e-6)
    assert s["head/logdet_fallback"]["self_s"] == pytest.approx(20e-6)


def test_device_events_by_owner():
    s = spans.reduce(EVENTS, (1000.0, 1200.0))
    owned = {name: (round(v["device_s"] * 1e6, 6), v["device_ops"]) for name, v in s.items() if v["device_ops"]}
    assert owned == {
        # its own forward kernel, and its backward kernel by the pairing
        "head/logdet_fallback": (5.0, 2),
        # the backward of a forward op outside any nested span
        "step/forward": (4.0, 1),
        "step/optimizer": (5.0, 1),
        # a graph's kernels under its launch
        "train/replay": (4.0, 2),
        # the accumulation on the engine's thread, a call outside every
        # span, a kernel with no launch
        spans.NONE: (6.0, 3),
    }


def test_forward_thread_is_the_spans_thread():
    owners = spans.Owners(EVENTS, (1000.0, 1200.0))
    # The other thread's op with the same sequence number is not the
    # forward op of the engine's nodes.
    assert owners.fwd_thread == MAIN
    assert owners.forward == {7: 1012.0, 8: 1040.0}
    assert owners.of_call(AUTOGRAD, 1065.0) == "head/logdet_fallback"
    assert owners.of_call(MAIN, 1195.0) == spans.NONE


def test_owned_names_each_device_event():
    got = sorted(spans.owned(EVENTS, (1000.0, 1200.0)))
    assert [(owner, name) for owner, name, _ in got if owner == "head/logdet_fallback"] == [
        ("head/logdet_fallback", "sqrt_bwd"), ("head/logdet_fallback", "sqrt_fwd")]
    assert len(got) == 9 and "outside" not in [name for _, name, _ in got]


def test_summary_keys_unmoved_by_spans():
    plain = [e for e in EVENTS if not e["name"].startswith("cmf/")]
    with_spans, without = trace.summarize(EVENTS, 2), trace.summarize(plain, 2)
    assert set(with_spans) == set(without)
    for key in without:
        if key != "breakdown":
            assert with_spans[key] == without[key]
    assert with_spans["breakdown"]["device_ops"] == without["breakdown"]["device_ops"]
    gaps = [sum(s for _, s in b["idle_gaps"]) for b in (with_spans["breakdown"], without["breakdown"])]
    assert gaps[0] == pytest.approx(gaps[1])
    # Only the gaps' names move: a span is now the innermost host event.
    assert any(n.startswith("cmf/") for n, _ in with_spans["breakdown"]["idle_gaps"])
    assert not any(n.startswith("cmf/") for n, _ in without["breakdown"]["idle_gaps"])


def _profiled_step(tmp_path):
    """The Chrome events of one eager likelihood step of the miniboone cell
    at cut widths, on the CPU."""
    from cmf_tpu_torch.training.experiment import setup_experiment

    cell = small.cell("miniboone-train")
    cfg = {**cell.port_config(), "max_dataset_size": 120}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer = setup_experiment(cfg, write_to_disk=False, device="cpu")["trainer"]
        flags = trainer.objective.for_epoch(cell.traffic["epoch"])
        x = next(iter(trainer.train_loader))
        trainer.eager_step(x, flags)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(trace.WINDOW):
                trainer.eager_step(x, flags)
    finally:
        torch.set_num_threads(threads)
    return trace.export_events(prof, str(tmp_path))


def test_backward_ops_of_a_real_step_pair_with_their_forward_spans(tmp_path):
    events = _profiled_step(tmp_path)
    window = trace.window_of(events)
    owners = spans.Owners(events, window)
    nodes = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith(spans.EVALUATE)]
    by_owner = {}
    for e in nodes:
        by_owner.setdefault(owners.of_call(e["tid"], float(e["ts"]) + 0.5 * float(e["dur"])), set()).add(
            e["name"][len(spans.EVALUATE):])
    # The Cholesky's square roots are the fallback's; the nodes that carry a
    # sequence number leave step/backward, which keeps the accumulations.
    assert "SqrtBackward0" in by_owner["head/logdet_fallback"]
    for name in ("head/encode", "head/decode_jacobian", "head/gram_logdet", "step/forward"):
        assert by_owner.get(name), name
    assert by_owner["step/backward"] == {"torch::autograd::AccumulateGrad"}
    assert spans.NONE not in by_owner


def _reader(metric):
    return load_module(BENCH_DIR / "metrics" / f"{metric}.py", "span_reader")


def _span(host_s=0.0, self_s=0.0, device_s=0.0):
    return {"count": 1, "host_s": host_s, "self_s": self_s, "device_s": device_s, "device_ops": 1}


def _measured(traced=None, eager=None):
    return {"program_spans": {"traced": traced, "eager": eager}}


@pytest.mark.parametrize("metric, ctx, value", [
    ("sample_host_ms.latent", _measured({"units": 4, "spans": {"sample/latent": _span(host_s=0.008)}}), 2.0),
    ("sample_host_ms.ambient", _measured({"units": 4, "spans": {"sample": _span(host_s=0.04, self_s=0.02)}}), 5.0),
    ("sample_host_ms.coupler_launch", _measured({"units": 4, "spans": {"ops/coupler_stack": _span(host_s=0.004)}}),
     1.0),
    ("step_launch_ms.train", _measured({"units": 20, "spans": {"train/replay": _span(host_s=0.03)}}), 1.5),
    ("step_device_ms.decode_jacobian",
     _measured({"units": 20, "spans": {}}, {"units": 2, "spans": {"head/decode_jacobian": _span(device_s=0.004)}}),
     2.0),
    ("step_device_ms.logdet_fallback",
     _measured({"units": 20, "spans": {}}, {"units": 2, "spans": {"head/logdet_fallback": _span(device_s=0.003)}}),
     1.5),
    ("step_device_ms.optimizer",
     _measured({"units": 20, "spans": {}}, {"units": 2, "spans": {"step/optimizer": _span(device_s=0.001)}}),
     0.5),
])
def test_span_metrics(metric, ctx, value):
    reader = _reader(metric)
    assert reader.read(ctx) == pytest.approx(value)
    # A program without the span, stretches without spans, a program
    # without spans, or no trace: None.
    assert reader.read(_measured({"units": 4, "spans": {}}, {"units": 2, "spans": {}})) is None
    assert reader.read(_measured()) is None
    assert reader.read({"program_spans": None}) is None
    assert reader.read({"trace": None}) is None
    assert reader.read({}) is None


def test_program_spans_measured_once_a_run(monkeypatch):
    cells = []
    monkeypatch.setattr(spans, "measure", lambda cell: cells.append(cell) or _measured(
        {"units": 4, "spans": {"sample": _span(host_s=0.04, self_s=0.02)}})["program_spans"])
    ctx = {"trace": {"units": 4}, "cell": "the cell"}
    assert _reader("sample_host_ms.ambient").read(ctx) == pytest.approx(5.0)
    assert _reader("sample_host_ms.latent").read(ctx) is None
    assert cells == ["the cell"]


def test_program_without_spans_is_not_set_up_again(monkeypatch):
    found = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "cmf_tpu_torch.tracing" else found(name, *a))
    monkeypatch.setattr(spans, "measure", lambda cell: pytest.fail("set up again"))
    ctx = {"trace": {"units": 4}, "cell": None}
    assert _reader("step_launch_ms.train").read(ctx) is None
    assert ctx["program_spans"] is None


@pytest.mark.parametrize("workload, outer, inner", [
    ("miniboone-train", "train/step", "head/logdet_fallback"),
    ("miniboone-warmup", "train/step", "step/optimizer"),
    ("mnist-fid-sample", "sample", "sample/latent"),
])
def test_measure_sets_the_cell_up_again_and_profiles_its_stretch(workload, outer, inner):
    cell = small.cell(workload, trace=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = spans.measure(cell)
    finally:
        torch.set_num_threads(threads)
    traced, cfg = got["traced"], cell.port_config()
    if workload == "mnist-fid-sample":
        units = cell.traffic["trace_passes"] * (cfg["num_fid_samples"] // cfg["test_batch_size"])
        ran = units
    else:
        # As in the driver's traced steps, an epoch of the small cell's rows
        # holds fewer steps than the stretch asks for.
        units = cell.traffic["trace_steps"]
        ran = min(units, cell.cfgfile["assumed"]["train_rows"] // cfg["train_batch_size"])
    assert traced["units"] == units
    assert traced["spans"][outer]["count"] == ran
    assert traced["spans"][inner]["count"] >= 1
    # The CPU route runs no graph, so no eager guard is taken.
    assert got["eager"] is None


def test_span_metrics_declared():
    bench = small.bench()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in ("sample_host_ms.latent", "sample_host_ms.ambient", "sample_host_ms.coupler_launch",
                 "step_launch_ms.train", "step_device_ms.decode_jacobian", "step_device_ms.logdet_fallback",
                 "step_device_ms.optimizer"):
        assert declared[name]["source"] == "program_span"
        assert (BENCH_DIR / "metrics" / f"{name}.py").exists()
    json.dumps(bench)
