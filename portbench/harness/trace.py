"""Reduction of a ``torch.profiler`` trace to the benchmark's readings.

A traced sub-window is wrapped in one host annotation (``WINDOW``) that ends
in a synchronize. From the exported Chrome trace this module takes the
device events (kernels, copies, fills: an aten op's own device time and the
device-side spans named after host regions would count their kernels a
second time), clips them to the annotation, and gives:

* the union of their intervals (``busy_s``) and the annotation's wall time
  (``window_s``): the idle share is one less their ratio, so the idle time
  before the first kernel and after the last counts;
* the device time and count of each kernel name;
* the idle gaps between the merged intervals, each named after the host
  event that was running in it (the innermost one that covers the gap's
  middle).
"""

import heapq
import json
import os
import re

WINDOW = "portbench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# Host events that may name an idle gap, innermost first by duration.
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def load_events(path):
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def export_events(prof, directory):
    """The events of a finished profiler run, through a Chrome trace written
    to ``directory`` and removed after it is read."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        return load_events(path)
    finally:
        os.unlink(path)


def _span(e):
    start = float(e["ts"])
    return start, start + float(e.get("dur", 0.0))


def window_of(events, name=WINDOW):
    """(start µs, end µs) of the host annotation ``name``; None if absent."""
    spans = [_span(e) for e in events
             if e.get("ph") == "X" and e.get("name") == name and e.get("cat") == "user_annotation"]
    return max(spans, key=lambda s: s[1] - s[0]) if spans else None


def device_events(events, window=None):
    """(start µs, end µs, name) of the device-side events, clipped to
    ``window``, sorted by start."""
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        start, end = _span(e)
        if window is not None:
            start, end = max(start, window[0]), min(end, window[1])
            if end <= start:
                continue
        out.append((start, end, e.get("name", "")))
    return sorted(out)


def merged_intervals(dev):
    """The union of ``device_events`` intervals as disjoint (start, end)."""
    merged = []
    for start, end, _ in dev:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [tuple(m) for m in merged]


def union_us(dev):
    return sum(end - start for start, end in merged_intervals(dev))


def idle_gaps(dev, window):
    """(start, end) of each stretch of ``window`` with no device event."""
    gaps, cursor = [], window[0]
    for start, end in merged_intervals(dev):
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)
    if window[1] > cursor:
        gaps.append((cursor, window[1]))
    return gaps


def host_events(events):
    return [(*_span(e), e.get("name", "")) for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATEGORIES and e.get("name") != WINDOW]


def name_gaps(gaps, hosts):
    """Each gap's seconds under the innermost host event running at its
    middle ("host between ops" where none is: the interpreter between two
    torch calls). One sweep over both, in time order."""
    hosts = sorted(hosts)
    active, i, out = [], 0, []
    for start, end in sorted(gaps):
        mid = 0.5 * (start + end)
        while i < len(hosts) and hosts[i][0] <= mid:
            heapq.heappush(active, (hosts[i][1], hosts[i][0], hosts[i][2]))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        name = min(((e - s, n) for e, s, n in active), default=(0.0, "host between ops"))[1]
        out.append((name, (end - start) * 1e-6))
    return out


def top(pairs, n=10):
    """The ``n`` largest of (name, seconds) summed by name, largest first."""
    totals = {}
    for name, seconds in pairs:
        totals[name] = totals.get(name, 0.0) + seconds
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def summarize(events, units):
    """The readings of one traced sub-window of ``units`` steps or chunks:
    {"window_s", "busy_s", "device_ops", "units", "kernels": {name: [s, n]},
    "breakdown"}; None where the trace holds no window or no device event."""
    window = window_of(events)
    if window is None:
        return None
    dev = device_events(events, window)
    if not dev:
        return None
    kernels = {}
    for start, end, name in dev:
        entry = kernels.setdefault(name, [0.0, 0])
        entry[0] += (end - start) * 1e-6
        entry[1] += 1
    gaps = name_gaps(idle_gaps(dev, window), host_events(events))
    return {
        "window_s": (window[1] - window[0]) * 1e-6,
        "busy_s": union_us(dev) * 1e-6,
        "device_ops": len(dev),
        "units": units,
        "kernels": kernels,
        "breakdown": {
            "device_ops": top((name, s) for name, (s, _) in kernels.items()),
            "idle_gaps": top(gaps),
        },
    }


def kernel_time(summary, pattern):
    """(seconds, launches) of the kernels whose name matches ``pattern``."""
    rx = re.compile(pattern)
    seconds, count = 0.0, 0
    for name, (s, n) in summary["kernels"].items():
        if rx.search(name):
            seconds += s
            count += n
    return seconds, count
