"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``cmf_tpu_torch``. It measures the
cell's end-to-end metrics (``--trace 0``) or its per-layer ones, read from a
profiled stretch after the window (``--trace 1``), checks what the timed
path produced against the plain reference, prints each compared number
beside its limit as the last lines on standard error, and as the last line
of standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, [``breakdown``,] ``checks``. It exits 2, printing
no result, without the CUDA devices the cell asks for, and 3 if JAX or the
JAX package was loaded.
"""

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment():
    """Every build and kernel cache in fixed directories of the checkout;
    no library's JAX backend; one host thread for the CPU-side work."""
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(cache / "torch_kernels")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness.cell import forbidden_modules, load_cell, load_json, run_cell

    bench = load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has {have}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = load_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), start=_START)
    result, checks, phases = run_cell(bench, cell)
    held = forbidden_modules()
    if held:
        print(f"the run loaded {', '.join(held)}: nothing the benchmark runs may import them", file=sys.stderr)
        return 3
    sys.stdout.flush()
    last = cell.start
    for name, t in phases.items():
        print(f"setup phase {name} {t - last:.3f} s", file=sys.stderr)
        last = t
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
