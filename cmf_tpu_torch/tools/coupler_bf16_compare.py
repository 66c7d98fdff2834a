#!/usr/bin/env python3
"""The coupler kernel's bf16 instance at the mnist shapes, on one card.

    python3 cmf_tpu_torch/tools/coupler_bf16_compare.py [--root DIR] [--label NAME] [--plans]

Loads ``cmf_tpu_torch`` from the checkout at ``--root`` (default: this
repo), builds its ``csrc/coupler_stack.cu``, and at ``chip_smoke.py``'s four
mnist coupler shapes (B=250 and 50; 1->2 at 28x28 and 2->4 at 14x14; [64]x8
ResNets with the model's own weight draw) reports the bf16 instance's card
and device time and its error against the plain bf16 version as a share of
the plain version's gap to fp32; at the first shape the fp32 instance's
device time beside it. Then ``sample(250)`` of the mnist non-square model
under the bf16 policy (random weights from seed 0): ms a call on the host
clock in 5 blocks of 5 calls after a warm-up, the coupler kernels' device
ms a call, the device's busy ms a call and idle share from one trace of 5
calls, and its coupler launches by arithmetic. Two versions compare on one
card when one command runs the script for each, in the order parent,
change, change, parent. The timers are ``chip_smoke.py``'s, from this
script's own checkout.

``--plans`` (this repo's wrapper only) times every bf16 launch plan the
wrapper could take at each shape through the C entry, beside the cost
``plan_launch_bf16`` gives it, to check its choice. The card's name and
power limit come from ``nvidia-smi``. The last line is a JSON object of the
numbers.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (its timers; it imports only the standard library at load)

SHAPES = [(250, 1, 2, 28, 64, 8), (50, 1, 2, 28, 64, 8), (250, 2, 4, 14, 64, 8), (50, 2, 4, 14, 64, 8)]
SAMPLE_BATCH = 250


def errors(cs, x, params):
    """(max err / max |ref|, that over the plain bf16 version's own gap to fp32)."""
    got = cs.coupler_stack_cuda(x, params, bf16=True)
    ref = cs.coupler_stack_plain(x, params, bf16=True)
    fp32 = cs.coupler_stack_plain(x, params)
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max()) / scale
    return err, err / (float((fp32 - ref).abs().max()) / scale)


def plan_times(cs, shape, x, params):
    """Device ms of every bf16 plan at the shape, by the C entry."""
    import torch

    b, c_in, c_out, hw, hidden, blocks = shape
    wts, small = cs.packed_weights(params, c_in, hidden, c_out, x.device, bf16=True)
    out = torch.empty((b, c_out, hw, hw), device=x.device)
    lib = cs._lib()
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for plan in cs._bf16_plans(c_in, hidden, hw, hw):
        def call(plan=plan):
            rc = lib.cmf_coupler_stack_fwd_bf16(
                x.data_ptr(), wts.data_ptr(), small.data_ptr(), out.data_ptr(), b, c_in, hw, hw, plan.hidden,
                plan.cm, blocks, c_out, plan.cluster, plan.n, plan.map_px, plan.stages, stream)
            assert rc == 0, f"bf16 C entry: CUDA error {rc}"

        rows.append({"cluster": plan.cluster, "n": plan.n, "stages": plan.stages,
                     "cost": cs._bf16_cost(b, plan),
                     "device_ms": chip_smoke.profiled_device_ms(call, "coupler_stack")})
    return rows


def sample_times(cs, blocks=5, calls=5):
    """``sample(250)`` of the mnist non-square model under bf16: host ms a
    call in each block, the coupler kernels' device ms a call, the device's
    busy ms a call and idle share, and the coupler launches of one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cmf_tpu_torch.config.config import get_config
    from cmf_tpu_torch.config.schemas import get_schema
    from cmf_tpu_torch.models import get_density
    from cmf_tpu_torch.nets import set_compute_dtype

    config = get_config("mnist", "non-square", False)
    density = get_density(get_schema(config), (1, 28, 28), "cuda", torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)

    def sample():
        return density.sample(SAMPLE_BATCH, generator=gen)

    set_compute_dtype("bfloat16")
    try:
        sample()
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        samples = sample()
        torch.cuda.synchronize()
        out = {"launches": {"bf16": cs.BF16_LAUNCHES, "fp32": cs.LAUNCHES - cs.BF16_LAUNCHES}}
        assert bool(torch.isfinite(samples).all()), "sample() is not finite"
        out["host_ms"] = []
        for _ in range(blocks):
            t0 = time.perf_counter()
            for _ in range(calls):
                sample()
            torch.cuda.synchronize()
            out["host_ms"].append((time.perf_counter() - t0) / calls * 1e3)
        out["coupler_device_ms"] = chip_smoke.profiled_device_ms(sample, "coupler_stack", iters=calls)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                sample()
            torch.cuda.synchronize()
        busy, span = chip_smoke.device_union_and_span(chip_smoke.device_events(prof))
        out["busy_ms"], out["idle_share"] = busy / calls / 1e3, 1.0 - busy / span
        return out
    finally:
        set_compute_dtype("float32")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default="")
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from cmf_tpu_torch.device import pin_fp32
    from cmf_tpu_torch.ops import coupler_stack as cs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    tag = f"[{args.label}]"
    print(f"{tag} nvidia-smi: {smi}; source {os.path.abspath(cs.__file__)}", flush=True)
    pin_fp32()
    cs._lib()
    out = {"label": args.label, "root": args.root, "card": smi, "shapes": {}}
    gen = torch.Generator().manual_seed(0)
    for shape in SHAPES:
        net, x = chip_smoke.init_scale_coupler(*shape, gen)
        with torch.no_grad():
            params = net.kernel_params()
            err, share = errors(cs, x, params)

            def call():
                return cs.coupler_stack_cuda(x, params, bf16=True)

            row = {"err": err, "gap_share": share, "card_ms": chip_smoke.cuda_ms(call),
                   "device_ms": chip_smoke.profiled_device_ms(call, "coupler_stack")}
            if shape == SHAPES[0]:
                row["fp32_device_ms"] = chip_smoke.profiled_device_ms(
                    lambda: cs.coupler_stack_cuda(x, params), "coupler_stack")
            if args.plans:
                row["plans"] = plan_times(cs, shape, x, params)
        print(f"{tag} B={shape[0]} {shape[1]}->{shape[2]} {shape[3]}x{shape[3]}: {json.dumps(row)}", flush=True)
        out["shapes"][",".join(map(str, shape))] = row
    out["sample"] = sample_times(cs)
    print(f"{tag} sample({SAMPLE_BATCH}) under bf16: {json.dumps(out['sample'])}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
