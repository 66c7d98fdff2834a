"""The readings a cell's limits are set from, on the chip at the cell's own
size: for each seed the numbers ``compare.py`` holds the program to, and
the same numbers of the control (the reference in TF32, put in the
program's place) and of the planted faults.

    python3 portbench/tools/readings.py --workload <name> --seeds 1,2,3 [--seconds 2] [--out FILE]

Training cells need no window: set-up runs the steps the reference follows,
and the half-batch fault is the reference on the first half of each batch.
The sampling cell runs a short window (its reservoir of checked chunks
full), and its fault swaps two images of each checked chunk. One line of
JSON a seed; ``--out`` also writes them all.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def training(cell, driver, flows):
    from portbench.harness import compare

    state = driver.setup(cell)
    driver.release(state)
    ref = cell.reference
    args = (cell.cfgfile, state.init, state.perm)
    flags = driver.reference_flags(state)
    fp32 = ref.train_steps(*args, state.batches, flags)
    control = ref.train_steps(*args, state.batches, flags, arith=flows.TF32)
    half = ref.train_steps(*args, [x[: x.shape[0] // 2] for x in state.batches], flags)
    return {
        "program": compare.training(state.program, fp32, state.init),
        "control": compare.training(control, fp32, state.init),
        "half_batch": compare.training(half, fp32, state.init),
        "jitter": fp32["jitter"],
        "losses": fp32["losses"],
    }


def sampling(cell, driver, flows, seconds):
    import torch

    from portbench.harness import compare

    state = driver.setup(cell)
    driver.window(state, seconds)
    driver.release(state)
    d = cell.cfgfile["config"]["latent_dimension"]
    fp32, control = [], []
    for slot in sorted(state.kept_states):
        gen = torch.Generator(state.device)
        gen.set_state(state.kept_states[slot])
        eps = torch.randn((state.chunk, d), generator=gen, device=state.device)
        with torch.no_grad():
            fp32.append(cell.reference.sample(cell.cfgfile, state.init, state.perm, eps))
            control.append(cell.reference.sample(cell.cfgfile, state.init, state.perm, eps, arith=flows.TF32))
    swapped = [x[[1, 0, *range(2, x.shape[0])]] for x in fp32]
    kept = [state.kept[slot] for slot in sorted(state.kept_states)]
    return {
        "program": compare.sampling(kept, fp32),
        "control": compare.sampling(control, fp32),
        "swapped_answer": compare.sampling(swapped, fp32),
        "checked_chunks": len(fp32),
        "pixel_range": [min(float(x.min()) for x in kept), max(float(x.max()) for x in kept)],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch

    from portbench.harness.cell import load_cell, load_json, load_module
    from portbench.reference import flows

    if not torch.cuda.is_available():
        print("readings are taken on the card", file=sys.stderr)
        return 2
    bench = load_json(ROOT / "BENCHMARK.json")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = load_cell(bench, args.workload, seed, args.seconds, False)
        driver = load_module(ROOT / "portbench" / "drivers" / f"{cell.traffic['driver']}.py", "driver")
        if cell.traffic["driver"] == "train_epochs":
            row = training(cell, driver, flows)
        else:
            row = sampling(cell, driver, flows, args.seconds)
        row.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del cell, driver
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
