"""Reduction of a profiled stretch to the program's own spans: the
``cmf/<name>`` host annotations of ``cmf_tpu_torch/tracing.py``.

Inside the window annotation each span gives its count, its host seconds
(``host_s``, the summed durations), its self seconds (``self_s``: less the
time covered by the program spans nested in it on its thread), and the
device time and count of the device events it owns (``device_s``,
``device_ops``). A device event (kernel, copy, fill) is owned by one span,
found from the runtime call that launched it (its ``correlation`` arg):

1. where that call lies inside an ``autograd::engine::evaluate_function``
   op, by the forward op that built the node: the op with the same
   ``Sequence number`` on the forward thread (the thread that enters the
   spans), and the innermost span that covers it there (a backward kernel
   counts under the forward span);
2. else the innermost span that covers the call on its own thread;
3. else ``(none)``: on the card, the autograd engine's device thread runs
   the gradients' accumulation, which has no forward op, under no span.

A captured graph's kernels carry the correlation of its ``cudaGraphLaunch``
and so fall under the span around the replay.

The span metrics' readers (``host_ms``, ``eager_device_ms``) take their
stretches after the driver's run, once a run (``program_spans``): the
cell's driver sets the program up again from the same seed and the same
stretches as its ``traced`` are profiled and reduced here. The driver's own
traced summary is left as it was; a program without spans is not set up
again, and its readers return None.
"""

import bisect
import importlib
import importlib.util
import itertools
import tempfile

import torch

from portbench.harness import device as dev
from portbench.harness import trace
from portbench.harness.trace import DEVICE_CATEGORIES, _span

PREFIX = "cmf/"
NONE = "(none)"
EVALUATE = "autograd::engine::evaluate_function: "
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


class Nested:
    """Properly nested (start, end, name) intervals of one thread: each
    one's parent, and the innermost one covering a time."""

    def __init__(self, intervals):
        self.items = sorted(intervals, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.items]
        self.parent, stack = [], []
        for i, (start, end, _) in enumerate(self.items):
            while stack and self.items[stack[-1]][1] < start:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def innermost(self, t):
        """Index of the innermost interval covering ``t``, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0:
            if self.items[i][1] >= t:
                return i
            i = self.parent[i]
        return None

    def name_at(self, t):
        i = self.innermost(t)
        return None if i is None else self.items[i][2]


def _args(e):
    return e.get("args") or {}


def _by_thread(events):
    out = {}
    for e in events:
        out.setdefault(e["tid"], []).append(e)
    return out


class Owners:
    """Which program span owns a host call, by the rules of the module."""

    def __init__(self, events, window):
        xs = [e for e in events if e.get("ph") == "X"]
        self.spans = {tid: Nested([(*_span(e), e["name"][len(PREFIX):]) for e in evs])
                      for tid, evs in _by_thread(
                          e for e in xs
                          if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX)
                          and window[0] <= float(e["ts"]) <= window[1]).items()}
        ops = [e for e in xs if e.get("cat") == "cpu_op"]
        self.nodes = {tid: Nested([(*_span(e), _args(e)) for e in evs])
                      for tid, evs in _by_thread(e for e in ops if e["name"].startswith(EVALUATE)).items()}
        # The forward thread is the one that enters the program's spans;
        # its forward ops (their "Fwd thread id" is 0) by sequence number,
        # the start of the outermost one that carries it.
        self.fwd_thread = max(self.spans, key=lambda tid: len(self.spans[tid].items), default=None)
        self.forward = {}
        for e in ops:
            a = _args(e)
            if (e["tid"] == self.fwd_thread and "Sequence number" in a and not a.get("Fwd thread id")
                    and not e["name"].startswith(EVALUATE)):
                seq = a["Sequence number"]
                self.forward[seq] = min(float(e["ts"]), self.forward.get(seq, float("inf")))

    def of_call(self, tid, t):
        """The span that owns a host call made at ``t`` on thread ``tid``:
        inside a backward node with a forward op, the span at that op."""
        nested = self.nodes.get(tid)
        i = None if nested is None else nested.innermost(t)
        if i is not None:
            start = self.forward.get(nested.items[i][2].get("Sequence number"))
            if start is not None:
                tid, t = self.fwd_thread, start
        own = self.spans.get(tid)
        return (own.name_at(t) if own else None) or NONE


def owned(events, window, owners=None):
    """(owning span, name, seconds) of each device event, clipped to
    ``window`` (start µs, end µs); ``(none)`` where no span owns it."""
    owners = owners or Owners(events, window)
    calls = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATEGORIES and "correlation" in _args(e):
            calls[_args(e)["correlation"]] = (e["tid"], float(e["ts"]))
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        start, end = _span(e)
        start, end = max(start, window[0]), min(end, window[1])
        if end <= start:
            continue
        call = calls.get(_args(e).get("correlation"))
        yield (NONE if call is None else owners.of_call(*call)), e.get("name", ""), (end - start) * 1e-6


def reduce(events, window):
    """{span name: {"count", "host_s", "self_s", "device_s", "device_ops"}}
    of the stretch inside ``window`` (start µs, end µs); ``(none)`` holds
    the device events no span owns."""
    out = {}

    def entry(name):
        return out.setdefault(name, {"count": 0, "host_s": 0.0, "self_s": 0.0, "device_s": 0.0, "device_ops": 0})

    owners = Owners(events, window)
    for nested in owners.spans.values():
        child = [0.0] * len(nested.items)
        for i, p in enumerate(nested.parent):
            if p is not None:
                child[p] += nested.items[i][1] - nested.items[i][0]
        for (start, end, name), covered in zip(nested.items, child):
            e = entry(name)
            e["count"] += 1
            e["host_s"] += (end - start) * 1e-6
            e["self_s"] += (end - start - covered) * 1e-6
    for owner, _, seconds in owned(events, window, owners):
        d = entry(owner)
        d["device_s"] += seconds
        d["device_ops"] += 1
    return out


def profiled(fn, units, device):
    """Run ``fn`` (``units`` steps or chunks) under ``torch.profiler``
    inside the window annotation, as ``device.profiled`` does: {"units",
    "spans" (``reduce``)}, or None where the trace holds no window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.is_cuda(device) else [])
    dev.synchronize(device)
    with profile(activities=activities) as prof:
        with record_function(trace.WINDOW):
            fn()
            dev.synchronize(device)
    events = trace.export_events(prof, tempfile.gettempdir())
    window = trace.window_of(events)
    return None if window is None else {"units": units, "spans": reduce(events, window)}


def measure(cell):
    """The program's spans over the cell's traced stretches, on a program
    set up again by the cell's driver (``setup``, the same seed): {"traced":
    the driver's traced steps or passes, "eager": a captured cell's eager
    guard steps, else None}."""
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    state = driver.setup(cell)
    try:
        if cell.traffic["driver"] == "fid_sampling":
            n = cell.traffic["trace_passes"] * state.chunks_per_pass

            def passes():
                for _ in range(cell.traffic["trace_passes"]):
                    driver.one_pass(state, state.chunks_per_pass)

            return {"traced": profiled(passes, n, state.device), "eager": None}
        trainer, flags = state.trainer, state.flags

        def steps(n, fn):
            def go():
                outs = [torch.stack(fn(x, flags)) for x in itertools.islice(iter(trainer.train_loader), n)]
                torch.stack(outs).tolist()
            return profiled(go, n, state.device)

        eager = steps(cell.traffic["eager_guard_steps"], trainer.eager_step) if trainer.captured else None
        return {"traced": steps(cell.traffic["trace_steps"], trainer.step), "eager": eager}
    finally:
        driver.release(state)


def program_spans(ctx):
    """``measure`` of the run's cell, once a run (kept in ``ctx``); None
    where the driver's traced stretch held no device event or the program
    has no spans (``cmf_tpu_torch/tracing.py``), without setting it up."""
    if "program_spans" not in ctx:
        has = ctx.get("trace") and importlib.util.find_spec("cmf_tpu_torch.tracing") is not None
        ctx["program_spans"] = measure(ctx["cell"]) if has else None
    return ctx["program_spans"]


def _per_unit(stretch, name, key):
    span = stretch and stretch["spans"].get(name)
    return None if not span else 1e3 * span[key] / stretch["units"]


def host_ms(ctx, name, key="host_s"):
    """Milliseconds a step or chunk of span ``name``'s ``key`` (``host_s``
    or ``self_s``) over the traced steps or passes; None without the span."""
    return _per_unit((program_spans(ctx) or {}).get("traced"), name, key)


def eager_device_ms(ctx, name):
    """Milliseconds a step of the device time span ``name`` owns over a
    captured cell's eager guard steps; None without the span."""
    return _per_unit((program_spans(ctx) or {}).get("eager"), name, "device_s")
