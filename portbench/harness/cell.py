"""One cell of ``BENCHMARK.json``, its files found by name, run once.

A workload names a configuration (``configs/<config>.json``, its plain
reference ``reference/<config>.py``) and a traffic mix
(``traffic/<traffic>.json``, whose ``driver`` names the general generator
in ``drivers/``); its limits are ``limits/<workload>.json``; each metric
is read by ``metrics/<metric>.py``. A later cell or metric adds files and
entries, and edits none of these.
"""

import importlib.util
import json
import math
import sys
from dataclasses import dataclass
from pathlib import Path

from portbench.harness import compare

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
# Top-level modules that no process of the benchmark may hold: the JAX
# package and JAX itself, compared by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "cmf_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """The module at ``path`` (names here may hold '-' and '.')."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(modules=None):
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclass
class Cell:
    """What a driver needs: the workload's entries and files (its
    configuration with any overrides of a small test cell) and the run's
    arguments."""

    workload: dict
    cfgfile: dict
    traffic: dict
    limits: dict
    reference: object
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    start: float = 0.0

    @property
    def name(self):
        return self.workload["name"]

    def port_config(self):
        """The configuration as the program takes it, with the run's seed."""
        return {**self.cfgfile["config"], "seed": self.seed}

    @property
    def device_arg(self):
        """The program's device argument: None is the card."""
        return None if self.device == "cuda" else self.device


def load_cell(bench, workload_name, seed, seconds, trace, device="cuda", overrides=None, start=0.0):
    workloads = {w["name"]: w for w in bench["workloads"]}
    if workload_name not in workloads:
        raise KeyError(f"no workload {workload_name!r} in BENCHMARK.json")
    wl = workloads[workload_name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfgfile = load_json(ROOT / configs[wl["config"]]["file"])
    if overrides:
        cfgfile = {**cfgfile, "config": {**cfgfile["config"], **overrides}}
    return Cell(
        workload=wl,
        cfgfile=cfgfile,
        traffic=load_json(BENCH_DIR / "traffic" / f"{wl['traffic']}.json"),
        limits=load_json(BENCH_DIR / "limits" / f"{workload_name}.json"),
        reference=load_module(BENCH_DIR / "reference" / f"{wl['config']}.py", f"portbench_ref_{wl['config']}"),
        seed=seed,
        seconds=seconds,
        trace=trace,
        device=device,
        start=start,
    )


def applies(metric, workload_name, bench):
    """Whether the cell reports ``metric``: the cells its ``workloads``
    lists, else every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return workload_name in metric["workloads"]
    if "moves" not in metric:
        return True
    moved = {m["name"]: m for m in bench["end_to_end"]}[metric["moves"]]
    return "workloads" not in moved or workload_name in moved["workloads"]


def read_metrics(bench, cell, ctx):
    """{name: {"value", "unit"}} of the cell's end-to-end metrics (untraced)
    or per-layer ones (traced); a reader that finds nothing returns None."""
    out = {}
    for metric in bench["per_layer" if cell.trace else "end_to_end"]:
        if not applies(metric, cell.name, bench):
            continue
        reader = load_module(BENCH_DIR / "metrics" / f"{metric['name']}.py", "portbench_metric")
        value = reader.read(ctx)
        if value is not None:
            if not math.isfinite(value):
                raise ValueError(f"{metric['name']} read {value}")
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def run_cell(bench, cell):
    """The cell's result line, as a dict, its checks, and the times at
    which set-up's phases ended."""
    driver = load_module(BENCH_DIR / "drivers" / f"{cell.traffic['driver']}.py", "portbench_driver")
    ctx = driver.run(cell)
    ctx["cell"] = cell
    checks = compare.judged(ctx["numbers"], cell.limits)
    result = {
        "correct": compare.correct(checks),
        "attempted": ctx["attempted"],
        "failed": ctx["failed"],
        "metrics": read_metrics(bench, cell, ctx),
        "device": ctx["device"],
    }
    if cell.trace and ctx.get("trace"):
        result["breakdown"] = ctx["trace"]["breakdown"]
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result, checks, ctx.get("setup_phases", {})
