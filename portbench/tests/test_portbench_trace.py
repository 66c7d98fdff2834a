"""The reduction of a trace: the idle share over a window with leading and
trailing gaps, kernel times by name, gaps named by the host, and the rate
of a window of whole epochs."""

import json
import time

import pytest

from portbench.harness import trace
from portbench.harness.cell import BENCH_DIR, load_module


def x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    x(trace.WINDOW, "user_annotation", 1000.0, 100.0),
    x("step", "cpu_op", 1000.0, 45.0),
    x("launch", "cuda_runtime", 1040.0, 2.0),
    x("read", "cpu_op", 1060.0, 40.0),
    x("kern_a", "kernel", 1010.0, 10.0),
    x("kern_b", "kernel", 1015.0, 15.0),
    x("memcpy", "gpu_memcpy", 1050.0, 10.0),
    x("outside", "kernel", 900.0, 50.0),
    x("aten::mm", "cpu_op", 1010.0, 5.0),
]


def test_idle_share_counts_the_leading_and_trailing_gaps():
    s = trace.summarize(EVENTS, units=2)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(30e-6)  # [1010, 1030) and [1050, 1060)
    assert s["device_ops"] == 3
    assert 1 - s["busy_s"] / s["window_s"] == pytest.approx(0.7)


def test_gaps_are_named_by_the_innermost_host_event():
    dev = trace.device_events(EVENTS, (1000.0, 1100.0))
    gaps = trace.idle_gaps(dev, (1000.0, 1100.0))
    assert gaps == [(1000.0, 1010.0), (1030.0, 1050.0), (1060.0, 1100.0)]
    named = trace.name_gaps(gaps, trace.host_events(EVENTS))
    assert [n for n, _ in named] == ["step", "launch", "read"]
    assert trace.top(named + [("step", 1e-6)])[0] == ["read", pytest.approx(40e-6)]


def test_kernel_time_by_pattern():
    s = trace.summarize(EVENTS, units=1)
    assert trace.kernel_time(s, r"kern_") == (pytest.approx(25e-6), 2)
    assert trace.kernel_time(s, r"\bkern_a\b") == (pytest.approx(10e-6), 1)
    assert trace.kernel_time(s, "nothing") == (0.0, 0)


def test_no_window_or_no_device_event_reads_nothing():
    assert trace.summarize(EVENTS[1:], units=1) is None
    assert trace.summarize([EVENTS[0], EVENTS[1]], units=1) is None


def test_export_round_trip(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    assert trace.summarize(trace.load_events(path), 2)["device_ops"] == 3


class _Loader:
    batch_size = 400


class _Trainer:
    """Epochs of 73 steps (29,556 rows, batch 400, the last 356 dropped)."""

    def __init__(self, seconds_an_epoch):
        self.history, self.train_loader, self.dt = [], _Loader(), seconds_an_epoch

    def _train_epoch(self, epoch):
        time.sleep(self.dt)
        self.history += [(epoch, 1.0, 1.0, False)] * (29_556 // 400)


@pytest.mark.parametrize("seconds", [0.05, 0.12])
def test_rate_over_whole_epochs(seconds):
    """The window runs whole epochs past its length; the rate is every
    step's samples over all of the window's time."""
    driver = load_module(BENCH_DIR / "drivers" / "train_epochs.py", "train_driver")
    state = type("S", (), {"trainer": _Trainer(0.02), "epoch": 60})()
    w = driver.window(state, seconds)
    epochs = w["units"] // 73
    assert w["units"] == 73 * epochs and w["samples"] == 29_200 * epochs
    assert w["window_s"] >= seconds and epochs * 0.02 <= w["window_s"] < seconds + 0.1
    reader = load_module(BENCH_DIR / "metrics" / "train_samples_per_s.py", "rate_reader")
    assert reader.read(w) == pytest.approx(w["samples"] / w["window_s"])
