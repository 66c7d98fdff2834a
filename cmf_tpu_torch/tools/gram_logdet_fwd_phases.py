#!/usr/bin/env python3
"""Where one warp of the Gram/log-det forward kernel spends its time, on one card.

    python3 cmf_tpu_torch/tools/gram_logdet_fwd_phases.py

Builds a copy of ``csrc/gram_logdet.cu`` in which lane 0 of each warp of
``gram_logdet_fwd_kernel`` records ``clock64()`` at the ends of its steps
(the copy of J, the Gram, the G store, the panels, the L store) and the
``%globaltimer`` at its start and end, and runs it at the smoke's shapes.
For each step it prints the median of the warps' cycles over 20 launches
(and the median of the slowest warp's), then a warp's time and the span from
the first warp's start to the last warp's end in ns. The stamps add a few
instructions a step; the kernel's own timings stay with ``chip_smoke.py``.
The card's name and power limit come from ``nvidia-smi``. The last line is a
JSON object of the numbers.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SHAPES = [(21, 400, 43), (21, 100, 43), (1, 400, 43), (32, 400, 128)]
STEPS = ["copy J", "Gram", "G store", "panels", "L store"]
RUNS = 20
MAX_B = 1024
SLOTS = 8  # clock64 at the kernel's start and at the ends of the 5 steps; globaltimer at start and end

# Anchors in the forward kernel and the stamp put after (or, with a
# negative step, before) each. A missing anchor stops the tool: the kernel's
# steps changed and the anchors with them.
_ANCHORS = [
    ("  if (b >= B) return;  // a tail warp leaves before any __syncwarp\n", "GT(6) ST(0)"),
    ("  cp_async_wait_all();\n  __syncwarp();\n", "ST(1)"),
    ("  // 3. Store G", "-ST(2)"),
    ("  __syncwarp();  // A is overwritten from here on\n", "ST(3)"),
    ("  // 5. Store L", "-ST(4)"),
    ("  if (lane == 0) logdet[b] = ld;\n", "ST(5) GT(7)"),
]
_PRELUDE = f"""
__device__ long long g_stamps[{MAX_B} * {SLOTS}];
#define ST(p) if (lane == 0 && b < {MAX_B}) g_stamps[b * {SLOTS} + (p)] = clock64();
#define GT(p) if (lane == 0 && b < {MAX_B}) {{ long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); g_stamps[b * {SLOTS} + (p)] = t_; }}
"""
_READER = """
extern "C" int cmf_fwd_phases_read(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, n * sizeof(long long));
}
"""


def stamped_source():
    src = (ROOT / "cmf_tpu_torch" / "csrc" / "gram_logdet.cu").read_text()
    start = src.index("gram_logdet_fwd_kernel(const float*")
    end = src.index("gram_logdet_bwd_kernel(", start)
    body = src[start:end]
    for anchor, stamp in _ANCHORS:
        if anchor not in body:
            sys.exit(f"anchor not found in gram_logdet_fwd_kernel: {anchor!r}")
        before = stamp.startswith("-")
        text = stamp.lstrip("-") + "\n"
        body = body.replace(anchor, "  " + text + anchor if before else anchor + "  " + text, 1)
    head = src[:start].replace("namespace {\n", "namespace {\n" + _PRELUDE, 1)
    return head + body + src[end:] + _READER


def build():
    from cmf_tpu_torch.ops import cuda_build

    out_dir = cuda_build.BUILD_DIR / "fwd_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "gram_logdet_phases.cu", out_dir / "libgram_logdet_phases.so"
    src.write_text(stamped_source())
    cmd = [cuda_build._nvcc(), *cuda_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", str(lib), str(src)]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cmf_gram_logdet_fwd.argtypes = [p, p, p, p, i, i, i, p]
    lib.cmf_fwd_phases_read.argtypes = [p, i]
    return lib


def main():
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    lib = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    out = {"card": smi, "shapes": {}}
    for d, b, big_d in SHAPES:
        j = torch.randn((d, b, big_d), device="cuda", generator=gen)
        g, l = torch.empty((b, d, d), device="cuda"), torch.empty((b, d, d), device="cuda")
        ld = torch.empty((b,), device="cuda")

        def launch():
            rc = lib.cmf_gram_logdet_fwd(j.data_ptr(), g.data_ptr(), ld.data_ptr(), l.data_ptr(),
                                         d, b, big_d, stream)
            assert rc == 0, f"CUDA error {rc}"

        for _ in range(20):
            launch()
        runs = []
        for _ in range(RUNS):
            launch()
            torch.cuda.synchronize()
            buf = np.zeros(MAX_B * SLOTS, np.int64)
            assert lib.cmf_fwd_phases_read(buf.ctypes.data, buf.size) == 0
            runs.append(buf.reshape(MAX_B, SLOTS)[:min(b, MAX_B)].copy())
        st = np.stack(runs)  # (runs, warps, slots)
        cycles = np.diff(st[:, :, 0:6], axis=2)
        med = np.median(cycles, axis=(0, 1))
        slowest = np.median(cycles.max(axis=1), axis=0)
        warp_ns = float(np.median(st[:, :, 7] - st[:, :, 6]))
        span_ns = float(np.median(st[:, :, 7].max(1) - st[:, :, 6].min(1)))
        row = {"cycles": dict(zip(STEPS, med.tolist())), "slowest_warp_cycles": dict(zip(STEPS, slowest.tolist())),
               "total_cycles": float(med.sum()), "warp_ns": warp_ns, "span_ns": span_ns}
        out["shapes"][f"{d},{b},{big_d}"] = row
        steps = ", ".join(f"{n} {m:.0f} ({s:.0f})" for n, m, s in zip(STEPS, med, slowest))
        print(f"d,B,D={(d, b, big_d)}: cycles a warp, median (slowest warp): {steps}; total {med.sum():.0f}; "
              f"a warp {warp_ns:.0f} ns, first start to last end {span_ns:.0f} ns", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
