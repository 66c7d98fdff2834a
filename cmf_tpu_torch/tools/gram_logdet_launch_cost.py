#!/usr/bin/env python3
"""Per-call cost of the Gram/log-det backward kernel's launch path on one card.

    python3 cmf_tpu_torch/tools/gram_logdet_launch_cost.py [--root DIR] [--label NAME]

Loads ``cmf_tpu_torch`` from the checkout at ``--root`` (default: this
repo), builds its ``csrc/gram_logdet.cu``, and times back-to-back calls of

- ``bwd_c``: the backward's C entry ``cmf_gram_logdet_bwd`` through ctypes,
  on an output allocated once;
- ``bwd_wrapper``: the wrapper ``gram_logdet_bwd_cuda`` (argument checks,
  ``torch.empty``, the same C entry);
- ``fwd_c``: the forward's C entry, as a control for the host's speed;

at the miniboone shape (d=21, B=400, D=43) and at d=1 (a backward block
under 48 KB of shared memory). For each, over the median of five runs of
2,000 calls, it reports the ms a call by CUDA events (the card's time, or
the host's where the host is slower) and the µs a call on the host clock up
to the return of the last call (the issue cost); then the kernel's own
device time from ``torch.profiler``. The card's name and power limit come
from ``nvidia-smi``. Two versions compare on one card when one command runs
the script for each, in the order parent, change, change, parent. The last
line is a JSON object of the numbers.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SHAPES = [(21, 400, 43), (1, 400, 43)]
CALLS = 2000
REPEATS = 5


def time_calls(fn, calls=CALLS, repeats=REPEATS):
    """Median over ``repeats`` of (ms a call by CUDA events, µs a call of host
    issue) over ``calls`` back-to-back calls."""
    import torch

    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    card, host = [], []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        end.record()
        end.synchronize()
        card.append(start.elapsed_time(end) / calls)
        host.append((t1 - t0) / calls * 1e6)
    return statistics.median(card), statistics.median(host)


def device_ms(fn, name, calls=200):
    """Device time a call of the kernels whose name contains ``name``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
        for e in prof.key_averages()
        if name in e.key
    )
    return total_us / calls / 1e3 if total_us else None


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.abspath(__file__)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(here))))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from cmf_tpu_torch.ops import gram_logdet as gl

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[{args.label}] nvidia-smi: {smi}", flush=True)
    lib = gl._lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    out = {"label": args.label, "root": args.root, "source": os.path.abspath(gl.__file__),
           "card": smi, "shapes": {}}
    for d, b, big_d in SHAPES:
        j = torch.randn((d, b, big_d), device=dev, generator=gen)
        _, _, l = gl.gram_logdet_fwd_cuda(j)
        gbar = torch.randn((b, d, d), device=dev, generator=gen)
        ldbar = torch.randn((b,), device=dev, generator=gen)
        dj = torch.empty_like(j)
        g_out, l_out = torch.empty_like(gbar), torch.empty_like(gbar)
        ld_out = torch.empty_like(ldbar)
        p = {k: t.data_ptr() for k, t in dict(j=j, l=l, g=gbar, ld=ldbar, dj=dj, go=g_out,
                                                lo=l_out, ldo=ld_out).items()}

        def bwd_c():
            rc = lib.cmf_gram_logdet_bwd(p["j"], p["l"], p["g"], p["ld"], p["dj"], d, b, big_d, stream)
            assert rc == 0, f"backward C entry: CUDA error {rc}"

        def bwd_wrapper():
            return gl.gram_logdet_bwd_cuda(j, l, gbar, ldbar)

        def fwd_c():
            rc = lib.cmf_gram_logdet_fwd(p["j"], p["go"], p["ldo"], p["lo"], d, b, big_d, stream)
            assert rc == 0, f"forward C entry: CUDA error {rc}"

        row = {}
        for name, fn, kern in (("bwd_c", bwd_c, "gram_logdet_bwd_kernel"),
                               ("bwd_wrapper", bwd_wrapper, "gram_logdet_bwd_kernel"),
                               ("fwd_c", fwd_c, "gram_logdet_fwd_kernel")):
            card_ms, host_us = time_calls(fn)
            row[name] = {"card_ms": card_ms, "host_us": host_us, "device_ms": device_ms(fn, kern)}
            print(f"[{args.label}] d,B,D={(d, b, big_d)} {name}: {card_ms:.6f} ms a call by CUDA "
                  f"events, {host_us:.3f} µs a call of host issue, kernel device time "
                  f"{row[name]['device_ms']} ms", flush=True)
        out["shapes"][f"{d},{b},{big_d}"] = row
    print(json.dumps(out))


if __name__ == "__main__":
    main()
