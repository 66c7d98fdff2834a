"""The cost of the program's spans (``cmf_tpu_torch/tracing.py``) on the
card's host, and what they own in a cell's traced stretches.

    python3 portbench/tools/span_cost.py --loop
    python3 portbench/tools/span_cost.py --workload <name> --seed <n> [--pairs 5] [--seconds 10] [--out FILE]

``--loop`` times 10**6 passes of an empty loop, of ``span`` with no
profiler, and of an ungated ``record_function``, then 10**5 of ``span``
under a CPU+CUDA profiler: microseconds a pass.

``--workload`` sets the cell up as ``run.py`` does and runs its untraced
window for ``--seconds`` (ms a step or chunk); then ``--pairs`` pairs of
the driver's traced stretches in turns, the spans live and gated off (the
gate shown no profiler), and the untraced window again. A line a stretch:
its ms a unit and idle share and, live, the host ms a unit in the
outermost spans (``train/replay``, ``sample``), so the traced readings
stand beside the untraced rate of the same process. ``--out`` writes the
first live pair's device time and count of each kernel name by the span
that owns it (``spans.owned``), a profile at a time.
"""

import argparse
import json
import statistics
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUTER = ("train/replay", "sample")


def loop():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from cmf_tpu_torch.tracing import span

    def per(n, body):
        t = time.perf_counter()
        body(n)
        return (time.perf_counter() - t) / n * 1e6

    def empty(n):
        for _ in range(n):
            pass

    def gated(n):
        for _ in range(n):
            with span("x"):
                pass

    def ungated(n):
        for _ in range(n):
            with record_function("cmf/x"):
                pass

    torch.cuda.init()
    for rep in range(2):
        e, g, u = per(10**6, empty), per(10**6, gated), per(10**6, ungated)
        print(f"rep {rep}: empty {e:.4f} us, span off {g:.4f} us (+{g - e:.4f}), "
              f"record_function ungated {u:.4f} us (+{u - e:.4f})")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on, e = per(10**5, gated), per(10**5, empty)
    print(f"span on (CPU+CUDA profiler): {on:.4f} us, empty {e:.4f} us, +{on - e:.4f}")


def stretches(args):
    import torch

    from cmf_tpu_torch import tracing
    from portbench import run
    from portbench.harness import spans, trace
    from portbench.harness.cell import load_cell, load_json, load_module

    run._environment()
    torch.set_num_threads(1)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = load_cell(bench, args.workload, args.seed, args.seconds, True, start=time.perf_counter())
    driver = load_module(ROOT / "portbench" / "drivers" / f"{cell.traffic['driver']}.py", "driver")
    state = driver.setup(cell)

    def untraced():
        w = driver.window(state, args.seconds)
        print(f"{args.workload} untraced: {1e3 * w['window_s'] / w['units']:.4f} ms/unit over {w['units']} units",
              flush=True)

    kept, export = [], trace.export_events
    trace.export_events = lambda prof, directory: kept.append(export(prof, directory)) or kept[-1]
    gate, off = tracing._profiler, types.SimpleNamespace(_is_profiler_enabled=False)
    rows, kernels = {"on": [], "off": []}, []
    untraced()
    for i in range(args.pairs):
        for side in ("on", "off") if i % 2 == 0 else ("off", "on"):
            tracing._profiler = gate if side == "on" else off
            kept.clear()
            s = driver.traced(state)
            tracing._profiler = gate
            ms, idle = 1e3 * s["window_s"] / s["units"], 100 * (1 - s["busy_s"] / s["window_s"])
            # The first profile is the traced steps or passes.
            reduced = spans.reduce(kept[0], trace.window_of(kept[0]))
            outer = {n: 1e3 * reduced[n]["host_s"] / s["units"] for n in OUTER if n in reduced}
            rows[side].append({"ms": ms, "idle": idle, **outer})
            print(f"{args.workload} traced, spans {side}: {ms:.4f} ms/unit, idle {idle:.3f}%"
                  + "".join(f", {n} {v:.4f} ms/unit" for n, v in outer.items()), flush=True)
            if side == "on" and not kernels:
                for events in kept:
                    by = {}
                    for owner, name, seconds in spans.owned(events, trace.window_of(events)):
                        k = by.setdefault(owner, {}).setdefault(name, [0, 0.0])
                        k[0] += 1
                        k[1] += seconds
                    kernels.append(by)
    trace.export_events = export
    untraced()
    for side, r in rows.items():
        print(f"{args.workload} spans {side}: median {statistics.median(x['ms'] for x in r):.4f} ms/unit, "
              f"idle {statistics.median(x['idle'] for x in r):.3f}%")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"stretches": rows, "kernels_by_span": kernels}, f)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--loop", action="store_true")
    parser.add_argument("--workload")
    parser.add_argument("--seed", type=int)
    parser.add_argument("--pairs", type=int, default=5)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("span costs are taken on the card", file=sys.stderr)
        return 2
    if args.loop:
        loop()
    if args.workload:
        stretches(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
