#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``cmf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on its own failure:

1. device      -- the card's name and power limit; TF32 off.
2. build       -- nvcc builds ``cmf_tpu_torch/csrc/*.cu`` for sm_90a, one
                  process per source, all at once; each kernel's ptxas line
                  and the Gram/log-det kernels' launch geometry.
3. kernels     -- each kernel against its plain PyTorch version on the card,
                  at the main-path shapes and edge shapes; a rank-deficient
                  input must give a non-finite log-det; the Gram/log-det
                  forward on a batch that mixes rank-2 Jacobians with
                  full-rank ones must give non-finite log-dets on the same
                  elements as its plain version; the backward on a batch
                  that mixes NaN factors (ḡ_ld = 0) with finite ones must
                  stay finite; the Gram/log-det kernels' device times at a
                  quarter of the batch; times of the kernel, the plain
                  version and a library yardstick, and the bound (for the
                  coupler kernel both its 3xTF32 tensor-core bound and the
                  fp32-pipe bound, its launch plan, and cuDNN with TF32 as
                  an aside in other numerics).
4. kernels-small -- both Gram/log-det kernels against their plain versions
                  at the 2-D zoo's shapes (d = 1, 2, 6; D = 2, 3, 6; B up to
                  5000 and a tail warp): the forward, autograd through each
                  with a loss on the Gram, and the backward kernel with a
                  random Ḡ, with ḡ_ld random and zero, on columns with
                  singular values in [0.5, 2]; the forward and its plain
                  version on Gaussian columns at d = D = 6 against fp64
                  (both finite where fp32 Cholesky cannot break down, the
                  kernel's log-det error within a multiple of the plain
                  version's); times,
                  bounds and the library yardstick at the sphere's and the
                  battery's shape.
5. train       -- the port's CLI trains miniboone non-square at full width
                  with the likelihood on from step 1, one CUDA graph replay a
                  step after the first; the Gram/log-det kernels' launch
                  counts, counted on the device and so under replay, must
                  equal the likelihood steps, one each a replay; step time and idle share of the captured and the
                  eager route; then one step on the card against the same
                  step on the CPU.
6. captured    -- 10 captured steps against 10 eager steps of the same step
                  function from the same weights on the same batches (losses
                  and every parameter and Adam state tensor within 1e-6
                  relative); one eager exact step under
                  ``torch.cuda.set_sync_debug_mode("error")``; a NaN batch
                  from step k on in a captured epoch must freeze the state at
                  step k-1's and raise at the epoch's end; the head's log-det
                  captured on a Jacobian with zero rows must take the jittered
                  fallback at the eager jitter level with a finite gradient;
                  the fallback's own cost a step.
7. warmup      -- the miniboone CLI with its default likelihood warm-up for
                  27 epochs of 2 batches: two flag keys, one graph each,
                  launches equal to the likelihood steps.
8. default     -- the flagship's default run: the miniboone CLI with the
                  published defaults (a run dir, early stopping from epoch
                  50, FID on 10,000 samples as the validation loss, a test
                  pass every 5 epochs, ``latest`` and ``best_valid``
                  checkpoints) for 53 epochs of 2 batches; then the run dir
                  resumed to epoch 55, its restored state bit-equal to the
                  saved ``latest`` and its epochs trained through a graph;
                  then ``--test --resume`` from ``best_valid``. Seconds of
                  the run, ms per FID pass and per checkpoint save, and the
                  share of the run outside training steps.
9. default-sphere -- the README's first command, sphere with the published
                  defaults under ``--nosave`` for 60 epochs of 10 steps:
                  valid/loss (-elbo) every epoch and test/loss at epochs 1
                  and 51 finite; one graph; Gram/log-det launches equal to
                  the steps (backward) and the steps plus the evaluation
                  batches (forward); ms a step, the device's idle share over
                  20 back-to-back replays, the run's seconds
                  and its share outside training; a card step against the
                  CPU; 10 captured against 10 eager steps.
10. cmf-battery -- hemisphere-2-6 at the CMF-vs-RNF battery's protocol (d=6,
                  lr 0.001) for 30 epochs an arm, g_ij_loss on and off: each
                  trained model's canonical-metric summary and MACS on the
                  card against the CPU; the CMF arm's step against the CPU
                  and its captured steps against eager ones; the same two
                  checks for miniboone with g_ij_loss (the README's second
                  command).
11. train-mnist -- the CLI trains the mnist non-square model (Hutchinson + CG)
                  at full width for 10 steps; then one step on the card
                  against the same step on the CPU, on the same weights,
                  dequantization noise and Hutchinson probes.
12. sample     -- ``sample(250)`` and ``fixed_sample()`` of the trained mnist
                  model, which must launch the coupler kernel once per
                  coupling inverse; the samples against the same noise decoded
                  through the conv modules.
13. inception  -- the port's InceptionV3 (``random_state_dict(0)`` weights)
                  on the JAX package's golden input against the golden
                  features and against the same network on the CPU; ms for a
                  chunk of 50 images.
14. default-mnist -- the mnist CLI with the published defaults (FID on
                  10,000 samples in chunks of 50 as the validation loss from
                  the warm-up's end, a test every 10 epochs, random-conv
                  proxy features) under ``--nosave``, cut to 7 epochs of 2
                  batches with the warm-up from epoch 2 to 4: valid/loss at
                  epochs 4-7 and test/fid at epoch 1 finite and stamped
                  ``proxy``; 10 coupler kernel launches a ``sample(50)``, so
                  2,000 a FID pass; then ``Trainer.test()`` at 50,000
                  samples. Seconds of the run, its share outside training
                  steps, ms per FID pass and its parts, the card's idle share
                  over one pass.
15. ood        -- ``density.ood`` of that model on 100 synthetic mnist and
                  100 synthetic fashion-mnist test images, card against CPU
                  on the same weights; the stump accuracies of the OOD
                  battery's rule on the two outputs.

16. metric-mnist -- the image metric analysis of the phase-11 mnist model at
                  its defaults (256 images: the g_kk and latent-variance
                  sorts, MACS, the prominent-z sweeps and the three grids),
                  the effective-z curves and the per-dimension FID (on each
                  image's centred mean: on raw pixels the FID raises in both
                  packages, and the phase prints the covariance that makes it
                  raise), the centring at 8: the coupler kernel's launches
                  must equal the routed calls times the 10 couplings; each
                  routed call at B = 1, 4, 7, 8, 10, 16, 32, 64, 128, 256
                  against the conv route; the Jacobian's numbers (4 points),
                  the effective-z curves (16), the sweeps and the grids, card
                  against CPU; a full-width d=2 model's two-dim manifold
                  grid against the conv route and the CPU; the battery's
                  seconds and parts, the kernel's ms at B = 1, 10, 64, 256;
                  ``load_run`` on phase 8's run dir bit-equal to its
                  ``best_valid``; ``--print-model`` on the card equal to
                  the CPU's; ``--profile-dir`` on miniboone for 3 epochs, its
                  trace naming both Gram/log-det kernels.

It prints a ``{"kernels": [...]}`` line, then, as its last line,
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result. It imports nothing of JAX and nothing of ``cmf_tpu``.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

# Main-path shape of the kernels: latent d, batch B, ambient D (miniboone).
MAIN_SHAPE = (21, 400, 43)
# Edges: d=1; the gate's corner (the backward's block opts in to over 48 KB
# of shared memory); B=1; and a B that is no multiple of the backward's
# warps a block (a tail warp).
EDGE_SHAPES = [(1, 400, 43), (32, 400, 128), (21, 1, 43), (21, 401, 43)]
# The 2-D zoo's shapes (d, B, D): a 1-D latent of 2-D data, the sphere
# (d=2, D=3) at the train and valid batch and at its test split's one batch
# of 5000, the CMF-vs-RNF battery's d=6, D=6, and a tail warp. The two
# timed are the sphere's and the battery's train step.
SMALL_SHAPES = [(1, 1000, 2), (2, 1000, 3), (2, 5000, 3), (6, 1000, 6), (6, 1001, 6)]
SMALL_TIMED = [(2, 1000, 3), (6, 1000, 6)]
# The battery's d = D = 6 on Gaussian columns: a square J's Gram can be
# conditioned past what fp32 resolves. Both forward versions are held
# against fp64 there: finite wherever cond(G) is below the bound under which
# an fp32 Cholesky cannot break down, 1 / (20 d^1.5 eps) (Higham, Accuracy
# and Stability of Numerical Algorithms, Thm 10.7), and the kernel's log-det
# error at most this multiple of the plain version's (plus FWD_TOL). Above
# the bound either may break down where the other does not.
GAUSSIAN_SHAPE = (6, 1000, 6)
GAUSSIAN_ERR_RATIO = 10
# fp32 kernels against fp32 torch ops that sum in another order: error over
# the reference's largest magnitude (at least 1).
FWD_TOL = 1e-4
BWD_TOL = 1e-3
# One training step on the card against the same step on the CPU: ten
# coupling layers of [128]x4 tanh MLPs, a 21x21 Cholesky and its gradient,
# each side summing in its own order.
STEP_LOSS_TOL = 1e-4
STEP_GRAD_TOL = 1e-3
# Coupler kernel against its plain version: max |err| / max |ref|. The
# kernel runs its hidden convs in 3xTF32 on the tensor cores with fp32 sums,
# the plain version in fp32, each summing in its own order (9·64 products a
# conv output, 17 convs deep, then a tanh head); measured about 1e-5.
COUPLER_TOL = 1e-4
# Coupler shapes (B, C_in, C_out, H=W, hidden, blocks). Main path: the
# checkerboard couplers at 28x28 and the split-channel / post-split
# checkerboard couplers at 14x14, at the train batch (50) and the sampling
# batch (250). The first one is the kernel's line in the JSON summary.
COUPLER_MAIN = [(250, 1, 2, 28, 64, 8), (50, 1, 2, 28, 64, 8), (250, 2, 4, 14, 64, 8),
                (50, 2, 4, 14, 64, 8)]
# Edges: B=1 (a 14-CTA cluster), one block, hidden 16 (padded to 32), 7x7;
# the cifar10 / svhn checkerboard coupler (3->6 at 32x32) and the celeba one
# (3->6 at 64x64, a 16-CTA cluster with 16-channel weight chunks).
COUPLER_EDGE = [(1, 1, 2, 28, 64, 8), (50, 1, 2, 28, 64, 1), (50, 2, 4, 14, 16, 8),
                (3, 1, 2, 7, 16, 1), (8, 3, 6, 32, 64, 8), (2, 3, 6, 64, 64, 8)]
# Captured steps against eager steps of the same step function on the same
# card: the same kernels on the same inputs, so any difference is a fault.
CAPTURED_TOL = 1e-6
# The captured epoch's first NaN batch (1-based); it and every later batch
# of the epoch are NaN.
FREEZE_STEP = 4
# One mnist step on the card against the same step on the CPU, batch 8:
# ten ResNet couplers of 17 convs, the Hutchinson surrogate through a JVP
# and a VJP of the decode, and its second-order gradient, each side summing
# in its own order.
MNIST_LOSS_TOL = 1e-4
MNIST_GRAD_TOL = 1e-3
# Samples through the kernel against the same noise through the conv
# modules: max |err| / max |ref|, data space [0, 256).
SAMPLE_TOL = 1e-4
MNIST_SAMPLE_BATCH = 250
MNIST_COUPLINGS = 10
# H100 SXM peaks (NVIDIA data sheet), at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12

TRAIN_ARGV = [
    "--model", "non-square", "--dataset", "miniboone", "--synthetic-data", "--nosave",
    "--config", "likelihood_warmup=False", "--config", "max_epochs=2",
    "--config", "max_dataset_size=4000", "--config", "seed=0",
    # The training step alone: no run dir, validation or FID (the default
    # phase runs those).
    "--config", "early_stopping=False", "--config", "use_fid=False",
]
# The flagship's own likelihood warm-up (start 25, end 50): 25 epochs of
# reconstruction alone, then the likelihood; two flag keys, two graphs.
TRAIN_WARMUP_ARGV = [
    "--model", "non-square", "--dataset", "miniboone", "--synthetic-data", "--nosave",
    "--config", "max_epochs=27", "--config", "max_dataset_size=800", "--config", "seed=0",
    "--config", "early_stopping=False", "--config", "use_fid=False",
]
# The flagship's default run, every other setting published: warm-up 25 -> 50,
# early stopping from epoch 50 (20 bad epochs), FID on 10,000 samples in
# chunks of 500, a test every 5 epochs, checkpoints `both'.
DEFAULT_ARGV = [
    "--model", "non-square", "--dataset", "miniboone", "--synthetic-data",
    "--config", "max_epochs=53", "--config", "max_dataset_size=800", "--config", "seed=0",
]
DEFAULT_RESUME_EPOCHS = 55
# The mnist image model's default run (every published setting but these
# cuts): 100 images (2 steps of 50), the warm-up from epoch 2 to 4 (so early
# stopping, and the FID as the validation loss, from epoch 4), 7 epochs. The
# FID keeps 10,000 samples in chunks of 50 and the test its 10-epoch period.
# No run dir: the card has no matplotlib for the image visualiser's figure.
MNIST_DEFAULT_ARGV = [
    "--model", "non-square", "--dataset", "mnist", "--synthetic-data", "--nosave",
    "--config", "max_dataset_size=100", "--config", "likelihood_warmup_start=2",
    "--config", "likelihood_warmup_end=4", "--config", "max_epochs=7", "--config", "seed=0",
]
MNIST_TEST_SAMPLES = 50_000
# The README's quick start (sphere: D=3, d=2, the affine prior, batch 1000,
# validation by -elbo every epoch, a test every 50), every published default
# but the depth: 60 epochs (published 1000), so 600 steps and tests after
# epochs 1 and 51. No run dir: the card has no matplotlib for its figures.
SPHERE_EPOCHS = 60
SPHERE_ARGV = [
    "--model", "non-square", "--dataset", "sphere", "--nosave",
    "--config", f"max_epochs={SPHERE_EPOCHS}", "--config", "seed=0",
]
# The CMF-vs-RNF battery's hemisphere protocol (analysis/ab_battery.py: lr
# 0.001, d=6 in D=6), 30 epochs an arm; the arm sets g_ij_loss.
HEMISPHERE_ARGV = [
    "--model", "non-square", "--dataset", "hemisphere-2-6", "--nosave",
    "--config", "lr=0.001", "--config", "latent_dimension=6", "--config", "max_epochs=30",
    "--config", "seed=0",
]
# The canonical-metric summary on the card against the CPU, same weights and
# 256 test points: a vmap of six JVPs through five couplings, then 6x6 Grams
# and cosines in fp32, each side summing in its own order.
METRIC_TOL = 1e-4
METRIC_POINTS = 256
# InceptionV3 on the card against the golden features (tests/test_eval.py's
# tolerance) and against the same network on the CPU: 94 fp32 conv layers,
# each side summing in its own order.
INCEPTION_GOLDEN_TOL = 2e-3
INCEPTION_CPU_TOL = 1e-4
# OOD features on the card against the CPU: the exact log-det of a 20x20
# Gram of JVP columns through ten ResNet couplers, fp32 both sides.
OOD_TOL = 1e-4
OOD_IMAGES = 100
# The image metric analysis of the phase-11 mnist model: its defaults (256
# images, d = 20), the centring at 8, the per-dimension FID at 512 samples a
# k in batches of 128. Kernel-routed calls (encodes, decodes, fixed samples;
# each crosses the 10 couplings): image_metric_analysis 2 encodes + 4 sweeps
# + 5 cumulative, 1 + 15 combined and 1 + 4 hierarchical grid samples; the
# effective-z curves 1 encode + 11 decodes; the centring 2 + 2;
# cumulative_dim_fid 1 encode + 20 x 4 decodes.
METRIC_IMAGES = 256
CENTERING_POINTS = 8
CUMULATIVE_FID_SAMPLES = 512
METRIC_ROUTED_CALLS = (2 + 4 + 5 + 16 + 5) + (1 + 11) + 4 + (1 + 20 * 4)
METRIC_TIMED_BATCHES = [1, 10, 64, 256]
# Card against CPU: the Jacobian's numbers at 4 points (a full-width JVP of
# 20 tangents on the CPU takes seconds an image), the effective-z curves at
# 16. Their reconstruction MSE is a mean of squared differences of decodes
# that carry the kernel's 3xTF32 error (1e-5 of the data range): 1e-4
# relative; the FID of the centred image means, 1e-3 relative.
METRIC_CPU_JAC_POINTS = 4
METRIC_CPU_CURVE_POINTS = 16
CURVE_RECON_TOL = 1e-4
CURVE_FID_TOL = 1e-3
# --profile-dir: miniboone for 3 epochs of 2 steps with the likelihood on,
# so epoch 2, the one traced, replays the graph of both Gram/log-det kernels.
PROFILE_ARGV = [
    "--model", "non-square", "--dataset", "miniboone", "--synthetic-data", "--nosave",
    "--config", "likelihood_warmup=False", "--config", "max_epochs=3", "--config", "max_dataset_size=800",
    "--config", "early_stopping=False", "--config", "use_fid=False", "--config", "seed=0",
]
TRAIN_MNIST_ARGV = [
    "--model", "non-square", "--dataset", "mnist", "--synthetic-data", "--nosave",
    "--config", "likelihood_warmup=False", "--config", "early_stopping=False",
    "--config", "use_fid=False", "--config", "max_epochs=1",
    "--config", "max_dataset_size=500", "--config", "seed=0",
]


def rel_err(got, ref):
    """max |got - ref| / max(1, max |ref|)."""
    got, ref = got.double(), ref.double()
    scale = max(1.0, float(ref.abs().max()))
    return float((got - ref).abs().max()) / scale


def cuda_ms(fn, iters=200, warmup=10):
    """Mean time per call of back-to-back calls, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_device_ms(fn, name, iters=50):
    """Device time per call of the kernels whose name contains ``name``: the
    summed durations of their events in a torch.profiler trace (its
    ``key_averages`` came back without device time in later phases); None
    where the trace holds none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(float(e.get("dur", 0)) for e in trace_events(prof)
                   if e.get("ph") == "X" and e.get("cat") == "kernel" and name in e.get("name", ""))
    return total_us / iters / 1e3 if total_us else None


def bound_ms(n_bytes, n_flops, n_tf32_flops=0):
    """The least time for the work: bytes over the memory rate against
    fp32-pipe FLOPs over 67 TFLOP/s plus tensor-core TF32 FLOPs over 495."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (n_flops / PEAK_FP32_FLOP_PER_S + n_tf32_flops / PEAK_TF32_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    import torch
    from cmf_tpu_torch.device import pin_fp32

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] nvidia-smi: {smi}")
    name = torch.cuda.get_device_name(0)
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, {name}, "
          f"{torch.cuda.device_count()} device(s)")
    pin_fp32()
    return name, smi


KERNEL_SOURCES = ["gram_logdet", "coupler_stack"]


def phase_build():
    from cmf_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build(KERNEL_SOURCES)
    for name in KERNEL_SOURCES:
        cuda_build.load_library(name)
    print(f"[build] {', '.join(KERNEL_SOURCES)} built in parallel and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in KERNEL_SOURCES:
        for line in ptxas_report(cuda_build.BUILD_LOGS.get(name, "")):
            print(f"[build]   {name}: {line}")
    for d, b, big_d in [MAIN_SHAPE] + EDGE_SHAPES:
        warps, fwd_smem, bwd_smem = gram_logdet_geometry(d, big_d)
        blocks = -(-b // warps)
        print(f"[build]   gram_logdet: gram_logdet_fwd_kernel at d,B,D={(d, b, big_d)}: {warps} warps a block, "
              f"{blocks} blocks, {fwd_smem} B dynamic shared memory a block")
        print(f"[build]   gram_logdet: gram_logdet_bwd_kernel<{-(-big_d // 32)}> at d,B,D={(d, b, big_d)}: "
              f"{warps} warps a block, {blocks} blocks, {bwd_smem} B dynamic shared memory a block")


def gram_logdet_geometry(d, big_d):
    """(warps a block, the forward's and the backward's dynamic shared bytes
    a block) of the Gram/log-det kernels at (d, D), as their C entries
    launch them."""
    import ctypes

    from cmf_tpu_torch.ops import gram_logdet as gl

    i, pi = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    fn = gl._lib().cmf_gram_logdet_geometry
    fn.argtypes, fn.restype = [i, i, pi, pi, pi], None
    w, fwd_smem, bwd_smem = i(), i(), i()
    fn(d, big_d, ctypes.byref(w), ctypes.byref(fwd_smem), ctypes.byref(bwd_smem))
    return w.value, fwd_smem.value, bwd_smem.value


def ptxas_report(log):
    """One line per compiled kernel from nvcc's -Xptxas -v output: its name
    (template arguments kept), registers, static shared memory, spills."""
    import re

    lines, entry = [], None
    for raw in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", raw)
        if m:
            mangled = m.group(1)
            name = re.search(r"[a-z_]+_kernel", mangled)
            args = re.findall(r"Li(\d+)E", mangled)
            entry = (name.group(0) if name else mangled) + (f"<{','.join(args)}>" if args else "")
        elif "spill" in raw and entry:
            spills = raw.strip()
        elif "Used" in raw and "registers" in raw and entry:
            lines.append(f"{entry}: {raw.split(':', 1)[1].strip()}; {spills}")
            entry = None
        elif "error" in raw:
            lines.append(raw.strip())
    return lines


def phase_kernels():
    import torch
    from cmf_tpu_torch.ops import gram_logdet as gl

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def cols(d, b, big_d):
        return torch.randn((d, b, big_d), device=dev, generator=gen)

    def fwd_errs(j):
        g_k, ld_k, l_k = gl.gram_logdet_fwd_cuda(j)
        g_p, ld_p, l_p = gl.gram_logdet_plain(j)
        torch.cuda.synchronize()
        rel = max(rel_err(g_k, g_p), rel_err(l_k, l_p), rel_err(ld_k, ld_p))
        absd = max(float((a - b).abs().max()) for a, b in ((g_k, g_p), (l_k, l_p), (ld_k, ld_p)))
        return rel, absd

    def loss_terms(j, w_ld, c_off):
        d = j.shape[0]
        off = 1.0 - torch.eye(d, device=dev)
        return lambda g, ld: (ld * w_ld).sum() + c_off * (g * off).abs().sum()

    def bwd_errs(j):
        b = j.shape[1]
        w_ld = torch.randn((b,), device=dev, generator=gen)
        f = loss_terms(j, w_ld, 0.3)
        jk = j.clone().requires_grad_(True)
        f(*gl.fused_gram_logdet(jk)).backward()
        jp = j.clone().requires_grad_(True)
        g_p, ld_p, _ = gl.gram_logdet_plain(jp)
        f(g_p, ld_p).backward()
        torch.cuda.synchronize()
        return rel_err(jk.grad, jp.grad), float((jk.grad - jp.grad).abs().max())

    results = {}
    for shape in [MAIN_SHAPE] + EDGE_SHAPES:
        j = cols(*shape)
        f_rel, f_abs = fwd_errs(j)
        b_rel, b_abs = bwd_errs(j)
        print(f"[kernels] d,B,D={shape}: fwd max rel err {f_rel:.3e} (tol {FWD_TOL:g}), "
              f"abs {f_abs:.3e}; bwd max rel err {b_rel:.3e} (tol {BWD_TOL:g}), abs {b_abs:.3e}")
        assert f_rel <= FWD_TOL, f"forward kernel disagrees with its plain version at {shape}"
        assert b_rel <= BWD_TOL, f"backward kernel disagrees with autograd through the plain version at {shape}"
        results[shape] = (f_abs, b_abs)

    # The backward kernel on its own against the plain dJ formula, with a
    # nonzero Ḡ and ḡ_ld.
    d, b, big_d = MAIN_SHAPE
    j = cols(d, b, big_d)
    _, _, l_k = gl.gram_logdet_fwd_cuda(j)
    gbar = torch.randn((b, d, d), device=dev, generator=gen)
    ldbar = torch.randn((b,), device=dev, generator=gen)
    # The kernel reads only L's lower triangle: NaN above it changes nothing.
    iu = torch.triu_indices(d, d, 1, device=dev)
    l_up = l_k.clone()
    l_up[:, iu[0], iu[1]] = float("nan")
    dj_k = gl.gram_logdet_bwd_cuda(j, l_up, gbar, ldbar)
    dj_p = gl.gram_logdet_bwd_plain(j, l_k, gbar, ldbar)
    direct = rel_err(dj_k, dj_p)
    print(f"[kernels] bwd kernel (NaN above L's diagonal) vs plain dJ formula at {MAIN_SHAPE}: "
          f"max rel err {direct:.3e} (tol {BWD_TOL:g})")
    assert direct <= BWD_TOL, "backward kernel disagrees with the plain dJ formula"

    # The fallback case beside the normal one in one batch: every third
    # element has a NaN factor and ḡ_ld = 0, the rest a finite factor and
    # ḡ_ld ≠ 0. The gradient must be finite where ḡ_ld = 0 and equal the
    # plain version everywhere.
    bad = torch.arange(b, device=dev) % 3 == 0
    l_mix = l_k.clone()
    l_mix[bad] = float("nan")
    ld_mix = torch.where(bad, torch.zeros_like(ldbar), ldbar)
    dj_k = gl.gram_logdet_bwd_cuda(j, l_mix, gbar, ld_mix)
    dj_p = gl.gram_logdet_bwd_plain(j, l_mix, gbar, ld_mix)
    mixed = rel_err(dj_k, dj_p)
    finite = bool(torch.isfinite(dj_k).all())
    print(f"[kernels] bwd kernel, mixed batch ({int(bad.sum())} of {b} elements with a NaN factor and "
          f"ḡ_ld = 0): all finite {finite}; max rel err vs plain {mixed:.3e} (tol {BWD_TOL:g})")
    assert finite, "backward kernel: a NaN factor with ḡ_ld = 0 made the gradient non-finite"
    assert mixed <= BWD_TOL, "backward kernel disagrees with the plain version on the mixed batch"

    # Rank-deficient Jacobian (rank 2 < d): the log-det must not be finite.
    base = cols(2, 64, big_d)
    j_def = torch.cat([base, base[:1], base[1:2]], dim=0).contiguous()
    _, ld_def, _ = gl.gram_logdet_fwd_cuda(j_def)
    n_bad = int((~torch.isfinite(ld_def)).sum())
    print(f"[kernels] rank-deficient J (d=4, rank 2, B=64): {n_bad}/64 non-finite log-dets")
    assert n_bad > 0, "rank-deficient Jacobian gave an all-finite log-det"

    # Non-PD elements beside PD ones in one batch: every third element gets
    # a rank-2 J. The forward's non-finite log-dets must fall on the same
    # elements as the plain version's, and the rest must agree.
    j_mix = cols(d, b, big_d)
    base = torch.randn((2, int(bad.sum()), big_d), device=dev, generator=gen)
    coef = torch.randn((d, 2, int(bad.sum())), device=dev, generator=gen)
    j_mix[:, bad] = torch.einsum("ice,ceD->ieD", coef, base)
    g_k, ld_k, l_k = gl.gram_logdet_fwd_cuda(j_mix)
    g_p, ld_p, l_p = gl.gram_logdet_plain(j_mix)
    torch.cuda.synchronize()
    nf_k, nf_p = ~torch.isfinite(ld_k), ~torch.isfinite(ld_p)
    ok = ~nf_k & ~nf_p
    mixed = max(rel_err(g_k, g_p), rel_err(ld_k[ok], ld_p[ok]), rel_err(l_k[ok], l_p[ok]))
    same = bool((nf_k == nf_p).all())
    print(f"[kernels] fwd kernel, mixed batch ({int(bad.sum())} of {b} elements with a rank-2 J): "
          f"{int(nf_k.sum())} non-finite log-dets (plain {int(nf_p.sum())}), same elements {same}; "
          f"max rel err vs plain on the rest {mixed:.3e} (tol {FWD_TOL:g})")
    assert same, "forward kernel: non-finite log-dets on other elements than the plain version's"
    assert mixed <= FWD_TOL, "forward kernel disagrees with the plain version on the mixed batch"

    # Times at the main-path shape. J (1.4 MB) stays in the 50 MB L2 between
    # calls, as it does in a training step right after the decode.
    j = cols(*MAIN_SHAPE)
    _, _, l_k = gl.gram_logdet_fwd_cuda(j)
    gbar = torch.randn((b, d, d), device=dev, generator=gen)
    ldbar = torch.randn((b,), device=dev, generator=gen)
    kernels = []
    for name, times in gram_logdet_times(j, l_k, gbar, ldbar, "kernels").items():
        kernels.append({
            "name": name, "route": "cuda", "source": "cmf_tpu_torch/csrc/gram_logdet.cu",
            "replaces": GRAM_REPLACES[name], "launches": None, "_launches_key": GRAM_LAUNCHES_KEY[name],
            "max_abs_err": results[MAIN_SHAPE][0 if name.endswith("fwd") else 1], **times,
        })

    # A quarter of the batch: one warp an element leaves the card's 528
    # schedulers under-filled either way, so a warp's latency sets the time.
    b4 = b // 4
    j4, l4, g4, ld4 = j[:, :b4].contiguous(), l_k[:b4].contiguous(), gbar[:b4].contiguous(), ldbar[:b4]
    for name, fn in (("gram_logdet_fwd", lambda: gl.gram_logdet_fwd_cuda(j4)),
                     ("gram_logdet_bwd", lambda: gl.gram_logdet_bwd_cuda(j4, l4, g4, ld4))):
        dev4 = profiled_device_ms(fn, f"{name}_kernel")
        dev4_txt = "not measured" if dev4 is None else f"{dev4:.6f} ms"
        print(f"[kernels] {name} at d,B,D={(d, b4, big_d)}: kernel device time {dev4_txt}")
    return kernels


GRAM_REPLACES = {"gram_logdet_fwd": "cmf_tpu/ops/pallas/gram_logdet.py:75",
                 "gram_logdet_bwd": "cmf_tpu/ops/pallas/gram_logdet.py:109"}
GRAM_LAUNCHES_KEY = {"gram_logdet_fwd": "GRAM_FWD", "gram_logdet_bwd": "GRAM_BWD"}


def gram_logdet_times(j, l_k, gbar, ldbar, tag):
    """Both Gram/log-det kernels at J's shape (d, B, D): ms per call back to
    back (CUDA events), the kernel's device time (profiler), the plain
    version's and the library yardstick's ms (``bmm`` + ``cholesky_ex``;
    ``cholesky_inverse`` + ``bmm``), and the bound. {name: numbers}."""
    import torch
    from cmf_tpu_torch.ops import gram_logdet as gl

    d, b, big_d = j.shape

    def fwd_library():
        g = torch.bmm(j.permute(1, 0, 2), j.permute(1, 2, 0))
        l, _ = torch.linalg.cholesky_ex(g)
        return 2.0 * torch.log(torch.diagonal(l, dim1=-2, dim2=-1)).sum(-1)

    jt = j.permute(1, 0, 2)  # (B, d, D)

    def bwd_library():
        m = gbar + gbar.transpose(-1, -2) + 2.0 * ldbar[:, None, None] * torch.cholesky_inverse(l_k)
        return torch.bmm(m, jt)

    # Each input read once, each output written once, fp32. Forward: J in;
    # G, L and the log-det out. Backward: J, L, Ḡ and ḡ_ld in; dJ out.
    f32 = 4
    fwd_bytes = f32 * (d * b * big_d + 2 * b * d * d + b)
    fwd_flops = b * (d * (d + 1) * big_d + d ** 3 / 3 + 2 * d)
    bwd_bytes = f32 * (2 * d * b * big_d + 2 * b * d * d + b)
    bwd_flops = b * (2 * d ** 3 / 3 + 2 * d * d * big_d + 3 * d * d)
    out = {}
    for name, kern, plain, lib, n_bytes, n_flops in (
        ("gram_logdet_fwd", lambda: gl.gram_logdet_fwd_cuda(j), lambda: gl.gram_logdet_plain(j),
         fwd_library, fwd_bytes, fwd_flops),
        ("gram_logdet_bwd", lambda: gl.gram_logdet_bwd_cuda(j, l_k, gbar, ldbar),
         lambda: gl.gram_logdet_bwd_plain(j, l_k, gbar, ldbar), bwd_library, bwd_bytes, bwd_flops),
    ):
        ms = cuda_ms(kern)
        device_ms = profiled_device_ms(kern, f"{name}_kernel")
        plain_ms = cuda_ms(plain, iters=20, warmup=2)
        library_ms = cuda_ms(lib, iters=50, warmup=3)
        b_ms, b_by = bound_ms(n_bytes, n_flops)
        dev_txt = "not measured" if device_ms is None else f"{device_ms:.6f} ms"
        print(f"[{tag}] {name} at d,B,D={(d, b, big_d)}: {ms:.6f} ms per call back to back, kernel "
              f"device time {dev_txt}, plain {plain_ms:.6f} ms, library {library_ms:.6f} ms, bound "
              f"{b_ms:.6f} ms ({b_by}: {n_bytes} B, {n_flops:.4g} FLOP)")
        out[name] = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms}
    return out


def conditioned_cols(d, b, big_d, gen):
    """(d, B, D) Jacobian columns with singular values in [0.5, 2] (so G's
    condition number is at most 16), each element's from its own random
    orthonormal bases. At d = D a Gaussian J's Gram reaches condition
    numbers near 1e8, where neither fp32 version is accurate and a pivot can
    round below zero: ``gaussian_vs_fp64`` holds both versions against fp64
    there."""
    import torch

    dev = gen.device
    q, _ = torch.linalg.qr(torch.randn((b, big_d, d), device=dev, generator=gen))
    r, _ = torch.linalg.qr(torch.randn((b, d, d), device=dev, generator=gen))
    s = 0.5 + 1.5 * torch.rand((b, 1, d), device=dev, generator=gen)
    return ((q * s) @ r).permute(2, 0, 1).contiguous()


def phase_kernels_small():
    """Both Gram/log-det kernels against their plain versions at the 2-D
    zoo's shapes: d = 1, 2, 6 and D = 2, 3, 6, B up to the test split's 5000
    and a tail warp; the forward's outputs, autograd through each with a
    loss on the Gram (a non-zero Ḡ), and the backward kernel alone with a
    random Ḡ, with ḡ_ld random and with ḡ_ld = 0."""
    import torch
    from cmf_tpu_torch.ops import gram_logdet as gl

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    for shape in SMALL_SHAPES:
        d, b, big_d = shape
        j = conditioned_cols(d, b, big_d, gen)
        g_k, ld_k, l_k = gl.gram_logdet_fwd_cuda(j)
        g_p, ld_p, l_p = gl.gram_logdet_plain(j)
        fwd = max(rel_err(g_k, g_p), rel_err(l_k, l_p), rel_err(ld_k, ld_p))
        w_ld = torch.randn((b,), device=dev, generator=gen)
        off = 1.0 - torch.eye(d, device=dev)
        grads = []
        for fn in (gl.fused_gram_logdet, lambda jj: gl.gram_logdet_plain(jj)[:2]):
            jj = j.clone().requires_grad_(True)
            g, ld = fn(jj)
            ((ld * w_ld).sum() + 0.3 * (g * off).abs().sum() + 0.2 * torch.diagonal(g, dim1=-2, dim2=-1).abs().sum()).backward()
            grads.append(jj.grad)
        autograd = rel_err(*grads)
        gbar = torch.randn((b, d, d), device=dev, generator=gen)
        ldbar = torch.randn((b,), device=dev, generator=gen)
        direct = rel_err(gl.gram_logdet_bwd_cuda(j, l_k, gbar, ldbar), gl.gram_logdet_bwd_plain(j, l_p, gbar, ldbar))
        zero = torch.zeros_like(ldbar)
        gbar_only = rel_err(gl.gram_logdet_bwd_cuda(j, l_k, gbar, zero), gl.gram_logdet_bwd_plain(j, l_p, gbar, zero))
        torch.cuda.synchronize()
        print(f"[kernels-small] d,B,D={shape}: fwd max rel err {fwd:.3e} (tol {FWD_TOL:g}); autograd "
              f"with a loss on G {autograd:.3e}; bwd kernel with random Ḡ and ḡ_ld {direct:.3e}, with "
              f"ḡ_ld = 0 {gbar_only:.3e} (tol {BWD_TOL:g})")
        assert fwd <= FWD_TOL, f"forward kernel disagrees with its plain version at {shape}"
        assert max(autograd, direct, gbar_only) <= BWD_TOL, f"backward kernel disagrees at {shape}"
        if shape in SMALL_TIMED:
            gram_logdet_times(j, l_k, gbar, ldbar, "kernels-small")
    gaussian_vs_fp64(gen)


def gaussian_vs_fp64(gen):
    """The forward kernel and its plain version on Gaussian columns at
    GAUSSIAN_SHAPE against the Gram and log-det in fp64 on the card."""
    import torch
    from cmf_tpu_torch.ops import gram_from_columns
    from cmf_tpu_torch.ops import gram_logdet as gl

    j = torch.randn(GAUSSIAN_SHAPE, device=gen.device, generator=gen)
    g64 = gram_from_columns(j.double())
    l64, info = torch.linalg.cholesky_ex(g64)
    ld64 = 2.0 * torch.log(torch.diagonal(l64, dim1=-2, dim2=-1)).sum(-1)
    cond = torch.linalg.cond(g64)
    worst = int(cond.argmax())
    readings = {}
    for name, (g, ld, _) in (("kernel", gl.gram_logdet_fwd_cuda(j)), ("plain", gl.gram_logdet_plain(j))):
        finite = torch.isfinite(ld)
        err = (ld.double() - ld64).abs().where(finite, torch.zeros_like(ld64))
        readings[name] = (finite, float(err.max()), int(err.argmax()), rel_err(g, g64))
    print(f"[kernels-small] Gaussian J at d,B,D={GAUSSIAN_SHAPE}: fp64 Cholesky failures {int((info > 0).sum())}; "
          f"cond(G) median {float(cond.median()):.3e}, max {float(cond[worst]):.3e} (element {worst}), "
          f"{int((cond > 1e6).sum())} elements above 1e6, {int((cond > 1e7).sum())} above 1e7")
    for name, (finite, err, at, gram_err) in readings.items():
        print(f"[kernels-small]   {name}: Gram vs fp64 max rel err {gram_err:.3e}; non-finite log-dets "
              f"{int((~finite).sum())} at {(~finite).nonzero().flatten().tolist()}; max |log-det - fp64| "
              f"over finite elements {err:.3e} at element {at} (cond {float(cond[at]):.3e})")
    (fin_k, err_k, _, gram_k), (fin_p, err_p, _, gram_p) = readings["kernel"], readings["plain"]
    safe = cond <= 1.0 / (20 * GAUSSIAN_SHAPE[0] ** 1.5 * torch.finfo(torch.float32).eps)
    differ = (fin_k != fin_p).nonzero().flatten().tolist()
    print(f"[kernels-small]   {int(safe.sum())} elements under the breakdown-free bound "
          f"{1.0 / (20 * GAUSSIAN_SHAPE[0] ** 1.5 * torch.finfo(torch.float32).eps):.3e}; finite in one "
          f"version only: {[(i, 'kernel' if bool(fin_k[i]) else 'plain', f'{float(cond[i]):.3e}') for i in differ]}")
    assert int((info > 0).sum()) == 0, "the fp64 reference Cholesky failed"
    assert max(gram_k, gram_p) <= FWD_TOL, "a Gram disagrees with fp64"
    assert bool((fin_k & fin_p)[safe].all()), "a log-det is non-finite where fp32 Cholesky cannot break down"
    assert err_k <= GAUSSIAN_ERR_RATIO * err_p + FWD_TOL, \
        "the kernel's log-det is further from fp64 than the plain version's allows"


def step_time(step, x, flags, n_steps, tag, route=""):
    """Host-clock ms per training step of ``step`` (a trainer's ``step`` or
    ``eager_step``), after one warm-up step."""
    import torch

    step(x, flags)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step(x, flags)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_steps * 1e3
    print(f"[{tag}] {route}{step_ms:.4f} ms per step, {x.shape[0] / step_ms * 1e3:.1f} samples/s "
          f"(batch {x.shape[0]}, {n_steps} steps, host clock)")
    return step_ms


def host_ms(fn, n):
    """Host-clock ms per call of ``n`` calls that end in a synchronize,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def trace_events(prof):
    """The events of a finished torch.profiler run's Chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


def device_union_and_span(prof):
    """The union of a trace's device intervals (kernels, copies, fills) and
    their span (first start to last end), in µs; (0, 0) for none."""
    intervals = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
        for e in trace_events(prof)
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
    )
    if not intervals:
        return 0.0, 0.0
    union, (cur_start, cur_end) = 0.0, intervals[0]
    for start, end in intervals[1:]:
        if start > cur_end:
            union += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    union += cur_end - cur_start
    return union, max(end for _, end in intervals) - intervals[0][0]


def profile_steps(step, x, flags, n_steps, tag, route="", unit="step"):
    """Where a step's (a ``unit``'s) device time goes, under torch.profiler,
    and the device's idle share from the same trace: one less the union of
    the device intervals over their span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(x, flags)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side events only (kernels, copies, fills): an aten op's own
    # device time would count its kernels a second time, and so would the
    # spans on the device timeline named after a host region (the
    # optimizer's step and zero_grad), which overlap the kernels they hold.
    averages = prof.key_averages()
    host_keys = {e.key for e in averages if e.device_type == torch.autograd.DeviceType.CPU}
    rows = sorted(
        (
            (getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)), e.key, e.count)
            for e in averages
            if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host_keys
        ),
        reverse=True,
    )
    busy = sum(r[0] for r in rows)
    ops = sum(r[2] for r in rows) // n_steps
    union, span = device_union_and_span(prof)
    if busy and span:
        units = unit + ("es" if unit.endswith("s") else "s")
        print(f"[{tag}] {route}profile of {n_steps} {units}: {ops} device ops/{unit}, busy "
              f"{busy / n_steps / 1e3:.4f} ms/{unit} summed, {union / n_steps / 1e3:.4f} ms/{unit} as the "
              f"union of the device intervals over their span of {span / n_steps / 1e3:.4f} ms/{unit} "
              f"(idle share {1 - union / span:.4f}; wall {wall_us / n_steps / 1e3:.4f} ms/{unit})")
        for dt, key, count in rows[:12]:
            print(f"[{tag}]   {dt / n_steps / 1e3:9.4f} ms/{unit}  x{count // n_steps:<4d} {key[:90]}")
    else:
        print(f"[{tag}] {route}profile: no device time in the trace (not measured)")
    return ops, busy / n_steps / 1e3, wall_us / n_steps / 1e3


def card_vs_cpu(setup, x, flags, tag, loss_tol, grad_tol, **draws):
    """One step's loss and every gradient on the card against the CPU (plain
    path), same weights, batch and draws."""
    import torch
    from cmf_tpu_torch.models import get_density
    from cmf_tpu_torch.training import elbo_loss

    gpu = setup["density"]
    cpu = get_density(setup["schema"], x_shape=tuple(x.shape[1:]), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    results = []
    for model, dev in ((gpu, x.device), (cpu, torch.device("cpu"))):
        model.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        loss = elbo_loss(model, x.to(dev), flags, **{k: v.to(dev) for k, v in draws.items()})
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        results.append((loss.item(), grads, time.perf_counter() - t0))
    (loss_g, grads_g, s_g), (loss_c, grads_c, s_c) = results
    loss_err = abs(loss_g - loss_c) / max(1.0, abs(loss_c))
    scale = max(float(g.abs().max()) for g in grads_c.values())
    worst = max(grads_c, key=lambda n: float((grads_g[n] - grads_c[n]).abs().max()))
    grad_err = float((grads_g[worst] - grads_c[worst]).abs().max()) / scale
    print(f"[{tag}] card vs CPU step (batch {x.shape[0]}; {s_g:.2f} s card, {s_c:.2f} s CPU): "
          f"loss {loss_g:.8g} vs {loss_c:.8g}, rel err {loss_err:.3e} (tol {loss_tol:g}); "
          f"max grad err / max |grad| {grad_err:.3e} (tol {grad_tol:g}) over {len(grads_c)} "
          f"tensors, worst `{worst}'")
    assert loss_err <= loss_tol, f"{tag}: loss on the card disagrees with the CPU step"
    assert grad_err <= grad_tol, f"{tag}: gradients on the card disagree with the CPU step"


def captured_steps(trainer):
    """The trainer's captured graphs, one a flag key."""
    return [g for g in trainer.graphs.values() if g is not None]


def phase_train():
    import torch
    from cmf_tpu_torch.densities import nonsquare
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.ops import gram_logdet as gl

    gl.reset_launch_counts()
    nonsquare.reset_logdet_fallbacks()
    t0 = time.perf_counter()
    (setup,) = cli_main(TRAIN_ARGV)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fwd, bwd = gl.launch_counts()
    counts = {"GRAM_FWD": fwd, "GRAM_BWD": bwd}
    fallbacks = nonsquare.logdet_fallbacks()

    trainer = setup["trainer"]
    graphs = captured_steps(trainer)
    losses = [h[1] for h in trainer.history]
    lik_steps = sum(1 for h in trainer.history if not h[3])
    print(f"[train] {len(losses)} steps in {train_s:.2f} s (first epoch includes warm-up and capture); "
          f"losses {losses[0]:.6g} -> {losses[-1]:.6g}")
    print(f"[train] route: {'captured' if trainer.captured else 'eager'}; {len(graphs)} graph(s) captured")
    print(f"[train] likelihood steps {lik_steps}; Gram/log-det kernel launches (fwd, bwd) {fwd}, {bwd} "
          f"(counted on the device, under replay); jitter fallbacks {fallbacks}")
    assert all(torch.isfinite(torch.tensor(losses))), "non-finite training loss"
    assert lik_steps == len(losses) > 0, "the likelihood was off for some steps"
    assert trainer.captured and len(graphs) == 1, "the exact path did not train through one CUDA graph"
    assert fwd == lik_steps, "forward kernel launches != likelihood steps"
    assert bwd == lik_steps, "backward kernel launches != likelihood steps"

    flags = trainer.objective.for_epoch(trainer.epoch)
    x = next(iter(trainer.train_loader))
    gl.reset_launch_counts()
    trainer.step(x, flags)
    replay = gl.launch_counts()
    print(f"[train] Gram/log-det kernel launches (fwd, bwd) in one replay: {replay}")
    assert replay == (1, 1), "a replay does not launch each Gram/log-det kernel once"
    step_time(trainer.step, x, flags, 20, "train", "captured: ")
    step_time(trainer.eager_step, x, flags, 20, "train", "eager: ")
    replay_ms = cuda_ms(lambda: trainer.step(x, flags), iters=50, warmup=3)
    print(f"[train] captured: {replay_ms:.4f} ms per step back to back (CUDA events: the device's span "
          f"of a replay with its input copy and output clone)")
    ops, busy, wall = profile_steps(trainer.step, x, flags, 5, "train", "captured: ")
    eager_ops, _, _ = profile_steps(trainer.eager_step, x, flags, 5, "train", "eager: ")
    if ops < eager_ops // 2:
        print(f"[train] captured: the profiler resolves {ops} of the eager step's {eager_ops} device "
              f"ops a step: it does not see the kernels inside a graph replay, so the captured idle "
              f"share above is not measured")
    card_vs_cpu(setup, x, flags, "train", STEP_LOSS_TOL, STEP_GRAD_TOL)
    return counts, replay_ms


def train_state(trainer):
    """The parameters and every optimizer state tensor, cloned."""
    state = [v for p in trainer.params for v in trainer.optimizer.state[p].values()]
    return [t.detach().clone() for t in list(trainer.params) + state]


def max_rel_diff(got, ref):
    """Max over tensors of max |got - ref| / max |ref|."""
    worst = 0.0
    for g, r in zip(got, ref):
        diff = float((g.double() - r.double()).abs().max())
        scale = float(r.double().abs().max())
        worst = max(worst, diff / scale if scale else diff)
    return worst


def fresh_setup(argv):
    """The CLI's setup for ``argv`` (the smoke's weights, seed 0), before any
    step."""
    from cmf_tpu_torch.main import main as cli_main

    (setup,) = cli_main(argv + ["--config", "max_epochs=0"])
    return setup


def captured_vs_eager(argv, tag):
    """A fresh trainer's captured steps against another's eager steps of the
    same step function, from the same weights, on the train loader's first
    epoch of batches. Returns (captured, eager, flags, batches)."""
    import torch

    captured, eager = fresh_setup(argv)["trainer"], fresh_setup(argv)["trainer"]
    flags = captured.objective.for_epoch(1)
    batches = list(captured.train_loader)
    n = len(batches)

    # The likelihood weight changes every step, as in the warmup: a graph
    # must read it as an input.
    step_flags = [{**flags, "likelihood_wt": 0.5 + 0.05 * i} for i in range(n)]
    out_c = torch.stack([torch.stack(captured.step(x, f)) for x, f in zip(batches, step_flags)])
    out_e = torch.stack([torch.stack(eager.eager_step(x, f)) for x, f in zip(batches, step_flags)])
    state_c, state_e = train_state(captured), train_state(eager)
    loss_rel = float(((out_c - out_e).abs() / out_e.abs()).max())
    state_rel = max_rel_diff(state_c, state_e)
    exact = all(torch.equal(a, b) for a, b in zip(state_c, state_e))
    print(f"[{tag}] {n} captured vs {n} eager steps from the same weights, likelihood weight 0.5 to "
          f"{step_flags[-1]['likelihood_wt']:g}: max rel diff of the losses "
          f"and grad norms {loss_rel:.3e}, of {len(state_c)} parameter and Adam state tensors "
          f"{state_rel:.3e} (tol {CAPTURED_TOL:g}); bit-equal {exact}; "
          f"{len(captured_steps(captured))} graph(s) captured")
    assert captured.captured and len(captured_steps(captured)) == 1, f"{tag}: the steps ran no graph"
    assert loss_rel <= CAPTURED_TOL and state_rel <= CAPTURED_TOL, f"{tag}: captured steps drift from eager steps"
    return captured, eager, flags, batches


def phase_captured(step_ms):
    import torch
    from cmf_tpu_torch.densities import nonsquare
    from cmf_tpu_torch.ops import cholesky_logdet, gram_from_columns, jittered_cholesky

    # Captured against eager: the same step function, weights and batches.
    captured, eager, flags, batches = captured_vs_eager(TRAIN_ARGV, "captured")
    n = len(batches)

    # No host read in the eager exact step.
    x = batches[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager.eager_step(x, flags)
        captured.step(x, flags)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print("[captured] one eager exact step and one replay under set_sync_debug_mode('error'): no sync")

    # The freeze: batches k..n are NaN in a captured epoch.
    k = FREEZE_STEP
    poisoned = [x if i < k - 1 else torch.full_like(x, float("nan")) for i, x in enumerate(batches)]
    snaps = []

    def loader():
        for x in poisoned:
            yield x
            snaps.append(train_state(captured))

    for x in poisoned[: k - 1]:
        eager.eager_step(x, flags)
    ref = train_state(eager)
    captured.train_loader = loader()
    raised = False
    try:
        captured._train_epoch(2)
    except FloatingPointError:
        raised = True
    before, at_k = snaps[k - 2], snaps[k - 1]
    vs_eager = max_rel_diff(before, ref)
    frozen = all(torch.equal(a, b) for a, b in zip(at_k, before))
    still = all(torch.equal(a, b) for s in snaps[k:] for a, b in zip(s, at_k))
    print(f"[captured] NaN batches from step {k} of {n}: FloatingPointError at the epoch's end {raised}; "
          f"state after step {k - 1} vs eager max rel diff {vs_eager:.3e}; state after step {k} equals "
          f"it {frozen}; steps {k + 1}-{n} changed nothing {still}")
    assert raised, "a NaN loss in a captured epoch did not raise at its end"
    assert vs_eager <= CAPTURED_TOL, "the captured state before the NaN step differs from the eager one"
    assert frozen and still, "a NaN step changed the parameters or the Adam state"

    # The head's log-det captured, with its jitter fallback.
    dev = x.device
    gen = torch.Generator(device=dev).manual_seed(3)
    d, b, big_d = MAIN_SHAPE
    j_ok = torch.randn(MAIN_SHAPE, device=dev, generator=gen)
    j_bad = j_ok.clone()
    zero_rows = torch.arange(b, device=dev) % 50 == 7
    j_bad[3, zero_rows] = 0.0
    w = torch.randn((b,), device=dev, generator=gen)
    static = j_ok.clone().requires_grad_(True)

    def head_log_det():
        gram, ld = nonsquare.exact_log_det_from_columns(static)
        (grad,) = torch.autograd.grad((ld * w).sum(), static)
        return gram, ld, grad

    graph, out = capture(head_log_det)
    for j, want in ((j_bad, 1), (j_ok, 0)):
        nonsquare.reset_logdet_fallbacks()
        with torch.no_grad():
            static.copy_(j)
        graph.replay()
        gram, ld, grad = (t.detach() for t in out)
        torch.cuda.synchronize()
        fallbacks = nonsquare.logdet_fallbacks()
        ref_gram = gram_from_columns(j)
        ref_ld, ref_total = cholesky_logdet(ref_gram)
        total = jittered_cholesky(gram)[1]
        err = rel_err(ld, ref_ld)
        finite = bool(torch.isfinite(grad).all())
        print(f"[captured] head log-det in a graph, {int(zero_rows.sum()) if want else 0} of {b} elements "
              f"with a zero row: fallbacks {fallbacks} (want {want}); jitter {float(total):g} vs eager "
              f"{float(ref_total):g}; log-det vs eager cholesky_logdet(gram_from_columns(J)) max rel err "
              f"{err:.3e} (tol {FWD_TOL:g}); gradient finite {finite}")
        assert fallbacks == want, "the captured head took the wrong branch"
        assert torch.equal(total, ref_total), "the captured fallback took another jitter level"
        assert err <= FWD_TOL and finite, "the captured fallback disagrees or its gradient is not finite"

    # What the fallback costs a step: its forward and backward, alone.
    g_static = gram_from_columns(j_ok).detach().requires_grad_(True)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    eye = torch.eye(d, device=dev)

    def fallback():
        ld, _ = cholesky_logdet(torch.where(ok, eye, g_static))
        return torch.autograd.grad(ld.sum(), g_static)

    graph, _ = capture(fallback)
    fallback_ms = cuda_ms(graph.replay, iters=50, warmup=3)
    print(f"[captured] the jitter fallback's forward and backward at B={b}, d={d}, captured: "
          f"{fallback_ms:.4f} ms a replay, {fallback_ms / step_ms:.3f} of the captured step's {step_ms:.4f} ms")


def phase_warmup():
    """The miniboone CLI with its default warm-up, across the epoch where the
    likelihood comes in: each flag key trains through its own graph."""
    import torch
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.ops import gram_logdet as gl

    gl.reset_launch_counts()
    t0 = time.perf_counter()
    (setup,) = cli_main(TRAIN_WARMUP_ARGV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    trainer = setup["trainer"]
    fwd, bwd = gl.launch_counts()
    history = trainer.history
    lik_steps = sum(1 for h in history if not h[3])
    graphs = captured_steps(trainer)
    print(f"[warmup] {trainer.epoch} epochs, {len(history)} steps ({lik_steps} with the likelihood) in "
          f"{seconds:.2f} s; {len(graphs)} graph(s) captured; Gram/log-det launches (fwd, bwd) {fwd}, {bwd}; "
          f"losses {history[0][1]:.6g} -> {history[-1][1]:.6g}")
    assert all(math.isfinite(h[1]) for h in history), "non-finite loss in the warm-up run"
    assert 0 < lik_steps < len(history), "the warm-up run did not span the likelihood's introduction"
    assert trainer.captured and len(graphs) == 2, "the warm-up run did not train through one graph a key"
    assert fwd == bwd == lik_steps, "Gram/log-det launches != likelihood steps in the warm-up run"


def _scalar_steps(run_dir, tag):
    """{step: value} of one scalar of a run dir's ``scalars.jsonl``."""
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == f"miniboone/{tag}"}


def _restore_streams(streams):
    """The CLI's writer tees stdout and stderr into its run dir; the smoke's
    own lines go to the streams it started with."""
    sys.stdout.flush()
    sys.stdout, sys.stderr = streams


def phase_default(smi, root):
    """The miniboone CLI with the published defaults into ``root``, then
    ``--resume`` and ``--test --resume`` on its run dir; returns the run
    dir."""
    import torch
    from cmf_tpu_torch.densities import nonsquare
    from cmf_tpu_torch.eval import fid
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.ops import gram_logdet as gl
    from cmf_tpu_torch.training import experiment
    from cmf_tpu_torch.training.checkpoint import make_checkpoint

    streams = sys.stdout, sys.stderr
    try:
        # The main path: the counts are read right after it.
        gl.reset_launch_counts()
        nonsquare.reset_logdet_fallbacks()
        t0 = time.perf_counter()
        (setup,) = cli_main(DEFAULT_ARGV + ["--logdir-root", root])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        _restore_streams(streams)
        fwd, bwd = gl.launch_counts()
        trainer = setup["trainer"]
        run_dir = setup["writer"].logdir
        history = trainer.history
        lik_steps = sum(1 for h in history if not h[3])
        graphs = captured_steps(trainer)
        valid = _scalar_steps(run_dir, "valid/loss")
        test_fid = _scalar_steps(run_dir, "test/fid")
        checkpoints = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
        timings = trainer.timings
        fid_n, fid_s = timings["fid"]
        ckpt_n, ckpt_s = timings["checkpoint"]
        train_s = timings["train"][1]
        print(f"[default] {trainer.epoch} epochs, {len(history)} steps ({lik_steps} with the likelihood); "
              f"{len(graphs)} graph(s) captured; Gram/log-det launches (fwd, bwd) {fwd}, {bwd}; "
              f"log-det fallbacks {nonsquare.logdet_fallbacks()}; losses {history[0][1]:.6g} -> "
              f"{history[-1][1]:.6g}")
        print(f"[default] valid/loss (FID) at epochs {sorted(valid)}: "
              f"{', '.join(f'{v:.6g}' for _, v in sorted(valid.items()))}; test/fid at epochs "
              f"{sorted(test_fid)}: first {test_fid[min(test_fid)]:.6g}, last {test_fid[max(test_fid)]:.6g}; "
              f"checkpoints {checkpoints}")
        assert all(math.isfinite(h[1]) for h in history), "non-finite loss in the default run"
        assert sorted(valid) == [50, 51, 52, 53], "valid/loss not written at epochs 50-53"
        assert sorted(test_fid) == list(range(1, 52, 5)), "test/fid not written at epochs 1, 6, ..., 51"
        assert all(math.isfinite(v) for v in list(valid.values()) + list(test_fid.values())), "non-finite FID"
        assert {"best_valid.pt", "latest.pt"} <= set(checkpoints), "a checkpoint is missing"
        assert trainer.captured and len(graphs) == 2, "the default run did not train through one graph a key"
        assert fwd == bwd == lik_steps > 0, "Gram/log-det launches != likelihood steps in the default run"
        assert fid_n == len(valid) + len(test_fid), "FID passes != validations + tests"
        print(f"[default] {smi}: the run took {seconds:.4f} s; {fid_s / fid_n * 1e3:.4f} ms per FID pass "
              f"({setup['config']['num_fid_samples']:,} samples, {fid_n} passes); {ckpt_s / ckpt_n * 1e3:.4f} ms per checkpoint save "
              f"({ckpt_n} saves); training epochs {train_s:.4f} s, so {1 - train_s / seconds:.4f} of the "
              f"run's wall time outside training steps (host clock)")

        # Where a FID pass goes: its sample calls on the card, the host's sqrtm.
        density, chunk = setup["density"], setup["config"]["test_batch_size"]
        gen = torch.Generator(device=setup["device"]).manual_seed(1)
        sample_ms = host_ms(lambda: density.sample(chunk, generator=gen), 10)
        stats = [fid.activation_statistics([density.sample(chunk, generator=gen) for _ in range(4)])
                 for _ in range(2)]
        sqrtm_ms = host_ms(lambda: fid.frechet_distance(*stats[0], *stats[1]), 5)
        calls = setup["config"]["num_fid_samples"] // chunk
        print(f"[default] {smi}: a FID pass's parts: sample({chunk}) {sample_ms:.4f} ms a call, "
              f"{calls} calls a pass ({calls * sample_ms:.4f} ms); frechet_distance (scipy sqrtm of a "
              f"{stats[0][1].shape[0]}x{stats[0][1].shape[0]} product on the host) {sqrtm_ms:.4f} ms (host clock)")
        profile_steps(lambda *_: trainer.fid_function(density, gen), None, None, 1, "default",
                      "one FID pass: ", unit="pass")

        # Resumed: a copy of the run dir trained on to epoch 55.
        resumed_dir = run_dir + "_resumed"
        shutil.copytree(run_dir, resumed_dir)
        with open(os.path.join(resumed_dir, "config.json")) as f:
            config = json.load(f)
        config["max_epochs"] = DEFAULT_RESUME_EPOCHS
        with open(os.path.join(resumed_dir, "config.json"), "w") as f:
            json.dump(config, f)
        saved = torch.load(os.path.join(resumed_dir, "checkpoints", "latest.pt"), weights_only=True)
        gl.reset_launch_counts()
        setup_r = experiment.setup_experiment(config, resume_dir=resumed_dir)
        trainer_r = setup_r["trainer"]
        loaded = make_checkpoint(trainer_r)
        tensors = [(s, k) for s in ("params", "model_state", "opt_states") for k in saved[s]]
        same = all(torch.equal(loaded[s][k], saved[s][k]) for s, k in tensors)
        same_rest = all(loaded[k] == saved[k] for k in ("epoch", "iteration", "best_valid_loss",
                                                        "num_bad_valid_epochs"))
        same_rng = torch.equal(loaded["rng"], saved["rng"])
        print(f"[default] resumed from `{trainer_r.restored_from}' after epoch {saved['epoch']}: "
              f"{len(tensors)} parameter, buffer and Adam state tensors bit-equal {same}; bookkeeping "
              f"equal {same_rest}; generator state equal {same_rng}")
        assert trainer_r.restored_from == "latest", "the resumed run did not load `latest'"
        assert same and same_rest and same_rng, "the restored state differs from the saved checkpoint"
        trainer_r.train()
        torch.cuda.synchronize()
        _restore_streams(streams)
        fwd_r, bwd_r = gl.launch_counts()
        history_r = trainer_r.history
        lik_r = sum(1 for h in history_r if not h[3])
        print(f"[default] resumed: epochs {sorted({h[0] for h in history_r})}, {len(history_r)} steps "
              f"({lik_r} with the likelihood), {len(captured_steps(trainer_r))} graph(s) captured, "
              f"Gram/log-det launches (fwd, bwd) {fwd_r}, {bwd_r}; valid/loss at epochs "
              f"{sorted(_scalar_steps(resumed_dir, 'valid/loss'))}")
        assert [h[0] for h in history_r] == [54, 54, 55, 55], "the resumed run trained other epochs"
        assert all(math.isfinite(h[1]) for h in history_r), "non-finite loss in the resumed run"
        assert trainer_r.captured and len(captured_steps(trainer_r)) == 1, "the resumed epochs ran no graph"
        assert fwd_r == bwd_r == lik_r == 4, "Gram/log-det launches != likelihood steps in the resumed run"

        # Tested: the run dir's best checkpoint, FID on 50,000 samples.
        best_epoch = min(valid, key=lambda e: (valid[e], e))
        t0 = time.perf_counter()
        (tested,) = cli_main(["--test", "--resume", run_dir])
        test_s = time.perf_counter() - t0
        _restore_streams(streams)
        with open(os.path.join(run_dir, "metrics.json")) as f:
            metrics = json.load(f)
        print(f"[default] --test --resume: loaded `{tested['trainer'].restored_from}' after epoch "
              f"{tested['trainer'].epoch} (best valid/loss at epoch {best_epoch}); metrics.json {metrics}; "
              f"{test_s:.4f} s")
        assert tested["trainer"].restored_from == "best_valid", "--test did not load `best_valid'"
        assert tested["trainer"].epoch == best_epoch, "--test loaded another epoch than the best"
        assert math.isfinite(metrics["fid"]) and metrics["feature_extractor"] == "raw-features"
    finally:
        _restore_streams(streams)
    return run_dir


def phase_default_sphere(smi):
    """The README's first command under ``--nosave``: sphere with every
    published default, cut to 60 epochs."""
    import torch
    from cmf_tpu_torch.densities import nonsquare
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.ops import gram_logdet as gl

    # The main path: the counts are read right after it.
    with _Recorded() as rec:
        gl.reset_launch_counts()
        nonsquare.reset_logdet_fallbacks()
        t0 = time.perf_counter()
        (setup,) = cli_main(SPHERE_ARGV)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        fwd, bwd = gl.launch_counts()
    trainer = setup["trainer"]
    history = trainer.history
    valid, test = rec.steps("valid/loss"), rec.steps("test/loss")
    graphs = captured_steps(trainer)
    evals = len(valid) * len(trainer.valid_loader) + len(test) * len(trainer.test_loader)
    train_s = trainer.timings["train"][1]
    print(f"[default-sphere] {trainer.epoch} epochs, {len(history)} steps; {len(graphs)} graph(s) captured; "
          f"Gram/log-det launches (fwd, bwd) {fwd}, {bwd} ({evals} evaluation batches); log-det "
          f"fallbacks {nonsquare.logdet_fallbacks()}; losses {history[0][1]:.6g} -> {history[-1][1]:.6g}; "
          f"valid/loss (-elbo) at {len(valid)} epochs, {valid[min(valid)]:.6g} -> {valid[max(valid)]:.6g}; "
          f"test/loss at epochs {sorted(test)}: {', '.join(f'{v:.6g}' for _, v in sorted(test.items()))}")
    assert all(math.isfinite(h[1]) for h in history), "non-finite loss in the sphere run"
    assert sorted(valid) == list(range(1, trainer.epoch + 1)) and trainer.epoch == SPHERE_EPOCHS
    assert sorted(test) == [1, 51], "test/loss not written at epochs 1 and 51"
    assert all(math.isfinite(v) for v in list(valid.values()) + list(test.values())), "non-finite elbo"
    assert trainer.captured and len(graphs) == 1, "the sphere run did not train through one graph"
    assert bwd == len(history) and fwd == len(history) + evals, \
        "Gram/log-det launches != training steps (bwd) + evaluation batches (fwd)"
    print(f"[default-sphere] {smi}: the run took {seconds:.4f} s; training epochs {train_s:.4f} s, so "
          f"{1 - train_s / seconds:.4f} of the run's wall time outside training steps (host clock)")

    flags = trainer.objective.for_epoch(trainer.epoch)
    x = next(iter(trainer.train_loader))
    step_time(trainer.step, x, flags, 20, "default-sphere", "captured: ")
    step_ms = cuda_ms(lambda: trainer.step(x, flags), iters=50, warmup=3)
    print(f"[default-sphere] captured: {step_ms:.4f} ms per step back to back (CUDA events)")
    profile_steps(trainer.step, x, flags, 20, "default-sphere", "captured: ")
    step_time(trainer.eager_step, x, flags, 10, "default-sphere", "eager: ")
    card_vs_cpu(setup, x, flags, "default-sphere", STEP_LOSS_TOL, STEP_GRAD_TOL)
    captured_vs_eager(SPHERE_ARGV, "default-sphere")


def phase_cmf_battery(smi):
    """The CMF-vs-RNF battery's hemisphere arms under ``--nosave``, 30
    epochs each; their canonical-metric summaries on the card against the
    CPU; then one captured miniboone step with the off-diagonal metric term
    against the CPU."""
    import torch
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.models import get_density
    from cmf_tpu_torch.viz.metric_analysis import canonical_metric_summary, macs

    for arm, g_ij in (("cmf", True), ("rnf", False)):
        argv = HEMISPHERE_ARGV + ["--config", f"g_ij_loss={g_ij}"]
        with _Recorded() as rec:
            t0 = time.perf_counter()
            (setup,) = cli_main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        trainer, density = setup["trainer"], setup["density"]
        history = trainer.history
        valid = rec.steps("valid/loss")
        print(f"[cmf-battery] {arm} (g_ij_loss={g_ij}): {trainer.epoch} epochs, {len(history)} steps in "
              f"{seconds:.4f} s ({smi}); {len(captured_steps(trainer))} graph(s); losses {history[0][1]:.6g} "
              f"-> {history[-1][1]:.6g}; valid/loss {valid[min(valid)]:.6g} -> {valid[max(valid)]:.6g}")
        assert all(math.isfinite(h[1]) for h in history), f"{arm}: non-finite loss"
        assert trainer.captured and len(captured_steps(trainer)) == 1, f"{arm}: no graph"
        assert all(math.isfinite(v) for v in valid.values()), f"{arm}: non-finite valid/loss"

        x = next(iter(trainer.test_loader))[:METRIC_POINTS]
        cpu = get_density(setup["schema"], x_shape=tuple(x.shape[1:]), device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in density.state_dict().items()})
        got, ref = canonical_metric_summary(density, x), canonical_metric_summary(cpu, x.cpu())
        got["macs_of_latents"] = macs(density, density.extract_latent(x))[0]
        ref["macs_of_latents"] = macs(cpu, cpu.extract_latent(x.cpu()))[0]
        errs = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12) for k in ref}
        print(f"[cmf-battery] {arm}: MACS {got['macs']:.6g} (CPU {ref['macs']:.6g}); summary on the card "
              f"{got}; max rel err vs the CPU {max(errs.values()):.3e} (tol {METRIC_TOL:g})")
        assert all(e <= METRIC_TOL for e in errs.values()), f"{arm}: the metric summary disagrees with the CPU"
        if g_ij:
            flags = trainer.objective.for_epoch(trainer.epoch)
            card_vs_cpu(setup, next(iter(trainer.train_loader)), flags, "cmf-battery", STEP_LOSS_TOL,
                        STEP_GRAD_TOL)
            captured_vs_eager(argv, "cmf-battery")
    # The README's second command: miniboone with the off-diagonal term.
    argv = TRAIN_ARGV + ["--config", "g_ij_loss=True"]
    setup = fresh_setup(argv)
    trainer = setup["trainer"]
    flags = trainer.objective.for_epoch(1)
    assert flags["add_offdiagonal_metric_reg"], "g_ij_loss=True did not turn on the off-diagonal term"
    card_vs_cpu(setup, next(iter(trainer.train_loader)), flags, "cmf-battery", STEP_LOSS_TOL, STEP_GRAD_TOL)
    captured_vs_eager(argv, "cmf-battery")


def capture(fn):
    """``fn`` warmed up once on a side stream, then captured: (graph, its
    outputs)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    return graph, out


def random_coupler(b, c_in, c_out, hw, hidden, blocks, gen):
    """The port's ResNet coupler on the card with random weights (the head's
    ones and zeros perturbed too) and a random input."""
    import torch
    from cmf_tpu_torch.nets import ResNet

    net = ResNet(c_in, [hidden] * blocks, c_out, generator=gen).cuda()
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen).cuda())
    x = torch.randn((b, c_in, hw, hw), generator=gen).cuda()
    return net, x


def phase_coupler_kernel():
    """The coupler kernel against its plain version, the library yardstick
    (the port's ResNet module through F.conv2d, cuDNN, TF32 off) and its
    bounds, at the main-path and edge shapes, with the launch plan."""
    import torch
    from cmf_tpu_torch.device import pin_fp32
    from cmf_tpu_torch.ops import coupler_stack as cs

    gen = torch.Generator().manual_seed(0)
    summary = None
    for shape in COUPLER_MAIN + COUPLER_EDGE:
        b, c_in, c_out, hw, hidden, blocks = shape
        net, x = random_coupler(*shape, gen)
        plan = cs.plan_launch(b, c_in, hidden, hw, hw)
        tag = "main" if shape in COUPLER_MAIN else "edge"
        with torch.no_grad():
            params = net.kernel_params()
            got = cs.coupler_stack_cuda(x, params)
            ref = cs.coupler_stack_plain(x, params)
            torch.cuda.synchronize()
            abs_err = float((got - ref).abs().max())
            err = abs_err / float(ref.abs().max())
            ok = err <= COUPLER_TOL and bool(torch.isfinite(got).all())
            print(f"[kernels] coupler_stack {tag} B={b} {c_in}->{c_out} {hw}x{hw} hidden {hidden} "
                  f"blocks {blocks}: max err / max |ref| {err:.3e} (tol {COUPLER_TOL:g}), abs {abs_err:.3e}; "
                  f"plan: cluster {plan.cluster} ({cs.max_active_clusters(plan, hw, hw)} active at once), "
                  f"band {plan.rows} rows, {plan.tiles} n-tiles a warp, {plan.kc}-channel weight chunks, "
                  f"{plan.smem_bytes} B shared memory a CTA")
            assert ok, f"coupler kernel disagrees with its plain version at {shape}"
            if tag == "edge":
                continue
            iters = 20 if b * hw * hw > 50 * 14 * 14 else 50
            ms = cuda_ms(lambda: cs.coupler_stack_cuda(x, params), iters=iters, warmup=3)
            device_ms = profiled_device_ms(lambda: cs.coupler_stack_cuda(x, params),
                                           "coupler_stack_kernel", iters=10)
            pack_ms = cuda_ms(lambda: cs.pack_weights(params, c_in, hidden, c_out, x.device, plan.kc),
                              iters=iters, warmup=3)
            plain_ms = cuda_ms(lambda: cs.coupler_stack_plain(x, params), iters=5, warmup=1)
            library_ms = cuda_ms(lambda: net(x), iters=iters, warmup=3)
            # cuDNN in TF32: other numerics (about 1e-2 off, like single-pass
            # TF32), shown beside the fp32 yardstick and never used as it.
            torch.backends.cudnn.allow_tf32 = True
            try:
                tf32_ms = cuda_ms(lambda: net(x), iters=iters, warmup=3)
                tf32_err = rel_err(net(x), ref)
            finally:
                pin_fp32()
        n_weights = sum(p.numel() for p in net.parameters())
        n_bytes = 4 * (x.numel() + n_weights + got.numel())
        n_flops = cs.flops(b, c_in, hidden, c_out, blocks, hw, hw)
        n_tc = cs.tensor_core_flops(b, hidden, blocks, hw, hw)
        b_ms, b_by = bound_ms(n_bytes, n_flops - n_tc, 3 * n_tc)
        fp32_b_ms, _ = bound_ms(n_bytes, n_flops)
        dev_txt = "not measured" if device_ms is None else f"{device_ms:.6f} ms"
        print(f"[kernels] coupler_stack B={b} {c_in}->{c_out} {hw}x{hw}: {ms:.6f} ms per call back to "
              f"back (of which packing the weights {pack_ms:.6f} ms), kernel device time {dev_txt}, "
              f"plain {plain_ms:.6f} ms, library (cuDNN module, fp32) {library_ms:.6f} ms; "
              f"cuDNN module in TF32 (other numerics, max err / max |ref| {tf32_err:.3e}) {tf32_ms:.6f} ms")
        print(f"[kernels] coupler_stack B={b} {c_in}->{c_out} {hw}x{hw} bounds: 3xTF32 tensor cores "
              f"{b_ms:.6f} ms ({b_by}: {n_bytes} B, {n_tc:.6g} FLOP x3 at 495 TFLOP/s + "
              f"{n_flops - n_tc:.6g} FLOP at 67), share {b_ms / ms:.3f}; fp32 pipes {fp32_b_ms:.6f} ms "
              f"({n_flops:.6g} FLOP at 67 TFLOP/s), share {fp32_b_ms / ms:.3f}")
        if summary is None:
            summary = {
                "name": "coupler_stack", "route": "cuda", "source": "cmf_tpu_torch/csrc/coupler_stack.cu",
                "replaces": "cmf_tpu/ops/pallas/coupler_stack.py:124", "launches": None,
                "_launches_key": "COUPLER_LAUNCHES", "shape": list(shape), "max_abs_err": abs_err,
                "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "bound": "3xTF32 on the tensor cores",
                "fp32_bound_ms": fp32_b_ms, "library_ms": library_ms,
            }
    return summary


def mnist_head(density):
    from cmf_tpu_torch.densities import NonSquareHeadDensity

    return next(m for m in density.modules() if isinstance(m, NonSquareHeadDensity))


def phase_train_mnist():
    import torch
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.ops import coupler_stack as cs

    cs.reset_launch_counts()
    t0 = time.perf_counter()
    (setup,) = cli_main(TRAIN_MNIST_ARGV)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trainer = setup["trainer"]
    losses = [h[1] for h in trainer.history]
    lik_steps = sum(1 for h in trainer.history if not h[3])
    print(f"[train-mnist] {len(losses)} steps in {train_s:.2f} s (set-up and warm-up included); "
          f"losses {losses[0]:.6g} -> {losses[-1]:.6g}; coupler kernel launches {cs.LAUNCHES}")
    assert all(torch.isfinite(torch.tensor(losses))), "non-finite mnist training loss"
    assert lik_steps == len(losses) == 10, "expected 10 likelihood steps"
    assert cs.LAUNCHES == 0, "a training step went through the forward-only coupler kernel"

    flags = trainer.objective.for_epoch(trainer.epoch)
    x = next(iter(trainer.train_loader))
    step_time(trainer.step, x, flags, 5, "train-mnist")
    profile_steps(trainer.step, x, flags, 3, "train-mnist")
    head = mnist_head(setup["density"])
    gen = torch.Generator(device=x.device).manual_seed(1)
    xb = x[:8]
    noise = torch.rand(xb.shape, generator=gen, device=x.device)
    eps = torch.randn((xb.shape[0], head.latent_dimension, head.num_hutchinson_samples),
                      generator=gen, device=x.device)
    card_vs_cpu(setup, xb, flags, "train-mnist", MNIST_LOSS_TOL, MNIST_GRAD_TOL,
                dequantization_noise=noise, hutchinson_eps=eps)
    return setup


def phase_sample(setup):
    import torch
    from cmf_tpu_torch.ops import coupler_stack as cs

    density = setup["density"]
    dev = setup["device"]
    gen = torch.Generator(device=dev).manual_seed(2)
    x_shape = tuple(setup["train_loader"].x_shape)

    # The main path: the counts are read right after it.
    cs.reset_launch_counts()
    samples = density.sample(MNIST_SAMPLE_BATCH, generator=gen)
    after_sample = cs.LAUNCHES
    fixed = density.fixed_sample()
    torch.cuda.synchronize()
    launches = cs.LAUNCHES
    print(f"[sample] sample({MNIST_SAMPLE_BATCH}) {tuple(samples.shape)}, fixed_sample() "
          f"{tuple(fixed.shape)}; coupler kernel launches {after_sample} + {launches - after_sample}")
    assert after_sample == MNIST_COUPLINGS, "sample(): coupler launches != couplings"
    assert launches - after_sample == MNIST_COUPLINGS, "fixed_sample(): coupler launches != couplings"
    assert tuple(samples.shape) == (MNIST_SAMPLE_BATCH, *x_shape)
    assert tuple(fixed.shape[1:]) == x_shape
    assert bool(torch.isfinite(samples).all()) and bool(torch.isfinite(fixed).all()), "non-finite samples"

    # The same noise through the kernel and through the conv modules.
    latent = mnist_head(density).latent_dimension
    noise = torch.randn((MNIST_SAMPLE_BATCH, latent), generator=gen, device=dev)
    got = density.fixed_sample(noise)
    with torch.no_grad():
        ref = density._fixed_sample(noise)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    print(f"[sample] kernel route vs conv route, same noise: max err / max |ref| {err:.3e} "
          f"(tol {SAMPLE_TOL:g}); samples in [{float(ref.min()):.4g}, {float(ref.max()):.4g}]")
    assert err <= SAMPLE_TOL, "samples through the coupler kernel disagree with the conv route"

    n_calls = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        density.sample(MNIST_SAMPLE_BATCH, generator=gen)
    torch.cuda.synchronize()
    kernel_ms = (time.perf_counter() - t0) / n_calls * 1e3
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(n_calls):
            density._sample(MNIST_SAMPLE_BATCH, generator=gen)
    torch.cuda.synchronize()
    conv_ms = (time.perf_counter() - t0) / n_calls * 1e3
    print(f"[sample] sample({MNIST_SAMPLE_BATCH}): {kernel_ms:.4f} ms per call through the kernel, "
          f"{conv_ms:.4f} ms through the conv modules (host clock, {n_calls} calls each)")


def phase_inception(smi):
    import numpy as np
    import torch
    from cmf_tpu_torch.eval.inception_v3 import InceptionFeatures, InceptionV3, random_state_dict

    golden_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                               "inception_pipeline_golden.npz")
    golden = np.load(golden_path)["features"]
    cpu = InceptionFeatures(InceptionV3.from_state_dict(random_state_dict(0)))
    card = InceptionFeatures(InceptionV3.from_state_dict(random_state_dict(0))).cuda()
    x = np.random.default_rng(42).integers(0, 256, (4, 1, 28, 28)).astype(np.float32)
    with torch.inference_mode():
        got = card(torch.tensor(x).cuda()).cpu().numpy()
        ref = cpu(torch.tensor(x)).numpy()
    golden_err = float(np.abs(got - golden).max())
    cpu_err = float(np.abs(got - ref).max()) / float(np.abs(ref).max())
    print(f"[inception] features {got.shape}: against the golden file max |err| {golden_err:.3e} "
          f"(rtol = atol = {INCEPTION_GOLDEN_TOL:g}); against the CPU max err / max |feature| "
          f"{cpu_err:.3e} (tol {INCEPTION_CPU_TOL:g})")
    assert np.allclose(got, golden, rtol=INCEPTION_GOLDEN_TOL, atol=INCEPTION_GOLDEN_TOL), \
        "InceptionV3 on the card disagrees with the golden features"
    assert cpu_err <= INCEPTION_CPU_TOL, "InceptionV3 on the card disagrees with the CPU"
    chunk = torch.randint(0, 256, (50, 1, 28, 28), generator=torch.Generator().manual_seed(0))
    chunk = chunk.float().cuda()
    with torch.inference_mode():
        ms = cuda_ms(lambda: card(chunk), iters=20, warmup=3)
    print(f"[inception] {smi}: {ms:.4f} ms a chunk of 50 mnist images (CUDA events, fp32, TF32 off), "
          f"so {ms * 200:.4f} ms per 10,000 images (derived)")


class _Recorded:
    """Record what a ``DummyWriter`` is given (the CLI under ``--nosave``
    writes through one), for the smoke to read the scalars back."""

    def __init__(self):
        from cmf_tpu_torch.training.writer import DummyWriter

        self.cls, self.rows, self.saved = DummyWriter, [], {}

    def __enter__(self):
        rows = self.rows
        for name in ("write_scalar", "write_textfile"):
            self.saved[name] = getattr(self.cls, name)
        self.cls.write_scalar = lambda w, tag, value, global_step=None: rows.append((tag, value, global_step))
        self.cls.write_textfile = lambda w, tag, text: rows.append((tag, text, None))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)

    def steps(self, tag):
        return {step: value for t, value, step in self.rows if t == tag}


def phase_default_mnist(smi):
    """The mnist CLI with the published defaults under ``--nosave``, then
    ``Trainer.test()`` at 50,000 samples."""
    import torch
    from cmf_tpu_torch.eval import fid, get_feature_fn
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.ops import coupler_stack as cs

    # The main path: the counts are read right after it.
    with _Recorded() as rec:
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        (setup,) = cli_main(MNIST_DEFAULT_ARGV)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = cs.LAUNCHES
    trainer, config = setup["trainer"], setup["config"]
    history = trainer.history
    valid, test_fid = rec.steps("valid/loss"), rec.steps("test/fid")
    stamp = rec.steps("test_feature_extractor")
    fid_n, fid_s = trainer.timings["fid"]
    train_s = trainer.timings["train"][1]
    chunk = config["test_batch_size"]
    calls = config["num_fid_samples"] // chunk
    print(f"[default-mnist] {trainer.epoch} epochs, {len(history)} steps "
          f"({sum(1 for h in history if not h[3])} with the likelihood); losses {history[0][1]:.6g} -> "
          f"{history[-1][1]:.6g}; valid/loss (FID) at epochs {sorted(valid)}: "
          f"{', '.join(f'{v:.6g}' for _, v in sorted(valid.items()))}; test/fid at epochs "
          f"{sorted(test_fid)}: {', '.join(f'{v:.6g}' for _, v in sorted(test_fid.items()))}; "
          f"feature extractor {list(stamp.values())}; coupler kernel launches {launches} in {fid_n} FID "
          f"passes")
    assert all(math.isfinite(h[1]) for h in history), "non-finite loss in the mnist default run"
    assert sorted(valid) == [4, 5, 6, 7], "valid/loss not written at epochs 4-7"
    assert sorted(test_fid) == [1], "test/fid not written at epoch 1"
    assert all(math.isfinite(v) for v in list(valid.values()) + list(test_fid.values())), "non-finite FID"
    assert list(stamp.values()) == ["proxy"], "the FID is not stamped `proxy'"
    assert fid_n == len(valid) + len(test_fid), "FID passes != validations + tests"
    assert launches == fid_n * calls * MNIST_COUPLINGS, "coupler launches != 10 a sample call"
    print(f"[default-mnist] {smi}: the run took {seconds:.4f} s; training epochs {train_s:.4f} s, so "
          f"{1 - train_s / seconds:.4f} of the run's wall time outside training steps; "
          f"{fid_s / fid_n * 1e3:.4f} ms per FID pass ({config['num_fid_samples']:,} samples, {fid_n} "
          f"passes; host clock)")

    # One FID pass alone: its launches, its time and its parts.
    density, gen = setup["density"], torch.Generator(device=setup["device"]).manual_seed(1)
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fid_function(density, gen)
    pass_ms = (time.perf_counter() - t0) * 1e3
    print(f"[default-mnist] one FID pass: {cs.LAUNCHES} coupler kernel launches ({calls} sample({chunk}) "
          f"calls), {pass_ms:.4f} ms (host clock)")
    assert cs.LAUNCHES == calls * MNIST_COUPLINGS, "a FID pass did not launch the kernel 10 times a call"
    features = get_feature_fn(config, setup["device"])
    sample_ms = host_ms(lambda: density.sample(chunk, generator=gen), 20)
    x = density.sample(chunk, generator=gen)
    with torch.inference_mode():
        feature_ms = cuda_ms(lambda: features(x), iters=50, warmup=3)
        stats = [fid.activation_statistics([density.sample(chunk, generator=gen) for _ in range(20)], features)
                 for _ in range(2)]
    sqrtm_ms = host_ms(lambda: fid.frechet_distance(*stats[0], *stats[1]), 3)
    dim = stats[0][1].shape[0]
    print(f"[default-mnist] {smi}: a FID pass's parts: sample({chunk}) {sample_ms:.4f} ms a call (host "
          f"clock), {calls} a pass ({calls * sample_ms:.4f} ms); proxy features {feature_ms:.4f} ms a chunk "
          f"(CUDA events), {calls * feature_ms:.4f} ms a pass; frechet_distance (scipy sqrtm of a "
          f"{dim}x{dim} product on the host) {sqrtm_ms:.4f} ms (host clock)")
    profile_steps(lambda *_: trainer.fid_function(density, gen), None, None, 1, "default-mnist",
                  "one FID pass: ", unit="pass")

    # The test pass of the run's model at 50,000 samples, as --test asks.
    loader = trainer.test_loader if config.get("use_test_fid", False) else trainer.train_loader
    trainer.fid_function = fid.get_fid_function({**config, "num_fid_samples": MNIST_TEST_SAMPLES}, loader,
                                                features)
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    results = trainer.test()
    test_s = time.perf_counter() - t0
    print(f"[default-mnist] {smi}: Trainer.test() at {MNIST_TEST_SAMPLES:,} samples: {results}; "
          f"{cs.LAUNCHES} coupler kernel launches; {test_s:.4f} s (host clock)")
    assert math.isfinite(results["fid"]) and results["feature_extractor"] == "proxy"
    assert cs.LAUNCHES == MNIST_TEST_SAMPLES // chunk * MNIST_COUPLINGS
    return setup, launches


def phase_ood(setup, smi):
    """``density.ood`` of the default run's model, card against CPU."""
    import numpy as np
    import torch
    from cmf_tpu_torch.data import get_image_datasets
    from cmf_tpu_torch.models import get_density
    from cmf_tpu_torch.training.experiment import best_stump_accuracy

    card = setup["density"]
    cpu = get_density(setup["schema"], x_shape=(1, 28, 28), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    outputs = {}
    for dataset in ("mnist", "fashion-mnist"):
        test_x = get_image_datasets(dataset, synthetic=True, seed=0)[2][0]
        x = torch.tensor(test_x[:OOD_IMAGES].astype(np.float32))
        xc = x.cuda()
        with torch.no_grad():
            card.ood(xc)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = card.ood(xc)
            torch.cuda.synchronize()
            card_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            parts = [cpu.ood(xb) for xb in x.split(25)]
            cpu_s = time.perf_counter() - t0
        ref = {k: torch.cat([part[k] for part in parts]) for k in parts[0]}
        errs = {k: rel_err(got[k].cpu(), ref[k]) for k in ref}
        outputs[dataset] = np.stack([got["likelihood"].cpu().numpy(), got["reconstruction-error"].cpu().numpy()], 1)
        print(f"[ood] {dataset}: {OOD_IMAGES} images, {card_ms:.4f} ms on the card (host clock, {smi}), "
              f"{cpu_s:.2f} s on the CPU; likelihood mean {float(ref['likelihood'].mean()):.6g}, "
              f"reconstruction error mean {float(ref['reconstruction-error'].mean()):.6g}; card vs CPU "
              f"max err / max(1, max |ref|): {', '.join(f'{k} {e:.3e}' for k, e in errs.items())} "
              f"(tol {OOD_TOL:g})")
        assert np.isfinite(outputs[dataset]).all(), f"non-finite OOD features of {dataset}"
        assert all(e <= OOD_TOL for e in errs.values()), f"OOD features of {dataset} disagree with the CPU"
    for j, feature in enumerate(("likelihood", "reconstruction-error")):
        acc = best_stump_accuracy(outputs["mnist"][:, j], outputs["fashion-mnist"][:, j])
        print(f"[ood] stump accuracy, mnist against fashion-mnist, on the {feature}: {acc:.4f}")


class _RoutedCalls:
    """Counts the density's encodes, decodes and fixed samples made under
    inference mode, the coupler kernel's route: each crosses every
    coupling once."""

    NAMES = ("extract_latent", "decode", "_fixed_sample")

    def __init__(self, density):
        self.density, self.n = density, 0

    def __enter__(self):
        import torch

        for name in self.NAMES:
            def counted(*args, _fn=getattr(self.density, name), **kw):
                if torch.is_inference_mode_enabled():
                    self.n += 1
                return _fn(*args, **kw)

            setattr(self.density, name, counted)
        return self

    def __exit__(self, *exc):
        for name in self.NAMES:
            delattr(self.density, name)


class _PartTimes:
    """Seconds spent in the named functions of ``module`` while in use, each
    call synchronised with the card on both ends."""

    def __init__(self, module, names):
        self.module, self.names, self.seconds = module, names, dict.fromkeys(names, 0.0)

    def __enter__(self):
        import torch

        self.saved = {name: getattr(self.module, name) for name in self.names}
        for name, fn in self.saved.items():
            def timed(*args, _fn=fn, _name=name, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*args, **kw)
                torch.cuda.synchronize()
                self.seconds[_name] += time.perf_counter() - t0
                return out

            setattr(self.module, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def centred_means(x):
    """Each image's mean value less 128, the middle of the data range: one
    feature, over which the effective-z and per-dimension FIDs are well
    posed. On raw pixels, or on region means, the one-pass fp32 covariance
    (s2 - n mu mu^T, the JAX package's formula) of decodes from one active
    latent has eigenvalues below the last jitter, and both packages raise
    (ROADMAP §3); the centred mean's variance keeps its sign."""
    return (x.mean(dim=(1, 2, 3)) - 128.0)[:, None]


def timed_s(fn):
    """(fn(), seconds), synchronised with the card on both ends."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _against(tag, got, ref, tol):
    """max |got - ref| / max |ref| within ``tol``, printed."""
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)
    print(f"[metric-mnist] {tag}: max err / max |ref| {err:.3e} (tol {tol:g})")
    assert np.isfinite(got).all() and np.isfinite(ref).all(), f"{tag}: non-finite values"
    assert err <= tol, f"{tag}: disagrees"
    return err


def phase_metric_mnist(setup, default_run_dir, root, smi):
    """The image metric and centering analyses of the phase-11 mnist model on
    the card; kernel route against conv route at every batch size of the
    path; card against CPU; the two-dim manifold; ``load_run``,
    ``--print-model`` and ``--profile-dir``."""
    import contextlib
    import io

    import numpy as np
    import torch
    from cmf_tpu_torch.config import get_schema
    from cmf_tpu_torch.eval import fid
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.models import get_density
    from cmf_tpu_torch.ops import coupler_stack as cs
    from cmf_tpu_torch.ops import gram_logdet as gl
    from cmf_tpu_torch.training import experiment
    from cmf_tpu_torch.training.checkpoint import make_checkpoint
    from cmf_tpu_torch.viz import metric_analysis as ma

    phase_t0 = time.perf_counter()
    density, dev = setup["density"], setup["device"]
    x_all = torch.tensor(setup["train_loader"].x[:METRIC_IMAGES], device=dev)
    latent = mnist_head(density).latent_dimension
    fid_noise = torch.randn((CUMULATIVE_FID_SAMPLES, latent), generator=torch.Generator().manual_seed(3))
    parts = ("g_kk_sort", "macs", "latent_variance_sort", "prominent_z_sweeps", "prominent_z_cumulative",
             "prominent_z_combined", "prominent_z_hierarchical")

    # The main path: the counts are read right after it.
    with _RoutedCalls(density) as routed, _PartTimes(ma, parts) as times:
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        out = ma.image_metric_analysis(density, x_all)
        torch.cuda.synchronize()
        core_s = time.perf_counter() - t0
        order = out["metric_analysis"]["latent_variance_order"]
        (recon, fids), curves_s = timed_s(lambda: ma.effective_z_curves(density, x_all, order, centred_means))
        (centred, centred_c), centring_s = timed_s(lambda: ma.centering_recons(density, x_all[:CENTERING_POINTS]))
        curve, cumulative_s = timed_s(lambda: ma.cumulative_dim_fid(density, x_all, fid_noise, order,
                                                                    centred_means))
        launches = cs.LAUNCHES
    seconds = core_s + curves_s + centring_s + cumulative_s
    payload = out["metric_analysis"]
    jac_s = times.seconds["g_kk_sort"] + times.seconds["macs"]
    grids_s = sum(times.seconds[k] for k in parts[3:])
    print(f"[metric-mnist] image_metric_analysis at {METRIC_IMAGES} images, d={latent}: MACS "
          f"{payload['macs']:.6g}, g_kk {payload['g_kk_sorted'][0]:.6g} .. {payload['g_kk_sorted'][-1]:.6g}, "
          f"cumulative variance at 5 axes {payload['cumulative_variance'][4]:.6g}; sweeps "
          f"{out['sweeps'].shape}; grids {', '.join(f'{k} {v[0].shape} nrow {v[1]}' for k, v in out['grids'].items())}")
    print(f"[metric-mnist] effective-z (centred image means) recon {', '.join(f'{k}: {v:.6g}' for k, v in recon.items())}; "
          f"FID {', '.join(f'{k}: {v:.6g}' for k, v in fids.items())}")
    print(f"[metric-mnist] cumulative_dim_fid (centred image means, {CUMULATIVE_FID_SAMPLES} samples a k): "
          f"{', '.join(f'{v:.6g}' for v in curve)}; centring recons {centred.shape}, {centred_c.shape}")
    print(f"[metric-mnist] {smi}: the battery took {seconds:.4f} s: image_metric_analysis {core_s:.4f} s "
          f"(Jacobians: g_kk_sort {times.seconds['g_kk_sort']:.4f} + macs {times.seconds['macs']:.4f} = "
          f"{jac_s:.4f} s; latent_variance_sort {times.seconds['latent_variance_sort']:.4f} s; sweeps and grids "
          f"{grids_s:.4f} s), effective-z curves {curves_s:.4f} s, centring {centring_s:.4f} s, "
          f"cumulative_dim_fid {cumulative_s:.4f} s (host clock, synchronised)")
    print(f"[metric-mnist] {routed.n} kernel-routed calls (expected {METRIC_ROUTED_CALLS}), coupler kernel "
          f"launches {launches} (expected {routed.n} x {MNIST_COUPLINGS})")
    assert all(np.isfinite(v) for v in list(recon.values()) + list(fids.values()) + curve)
    assert np.isfinite(payload["macs"]) and np.isfinite(out["sweeps"]).all()
    assert all(np.isfinite(v[0]).all() for v in out["grids"].values())
    assert routed.n == METRIC_ROUTED_CALLS, "the battery made another number of routed calls"
    assert launches == routed.n * MNIST_COUPLINGS, "coupler launches != routed calls x couplings"

    # At defaults the effective-z FID is on raw pixels: the covariance of the
    # k = 1 decodes, against the 1e-2 jitter that frechet_distance tries last.
    z_all = ma.encode(density, x_all)
    one = ma.decode(density, z_all * ma._mask(latent, order[:1], dev))
    eig = np.linalg.eigvalsh(fid.activation_statistics(iter([one]))[1].astype(np.float64))
    print(f"[metric-mnist] raw-pixel effective-z FID at k=1 (the defaults): the fp32 covariance of the "
          f"{METRIC_IMAGES} decodes has eigenvalues {eig[0]:.6g} .. {eig[-1]:.6g}, {int((eig < -1e-2).sum())} "
          f"below -1e-2: cmf_tpu's frechet_distance raises there, and so does the port's (ROADMAP §3)")

    # Kernel route against conv route at each batch size of the path.
    noise, seeds = (t.to(dev) for t in ma.prominent_z_noise(order))
    sweep = z_all.mean(dim=0).repeat(7, 1)
    cases = {
        1: [("fixed_sample", noise[:1])],
        4: [("fixed_sample", noise[:4])],
        7: [("decode", sweep)],
        8: [("extract_latent", x_all[:8]), ("decode", z_all[:8]), ("fixed_sample", noise[:8])],
        10: [("fixed_sample", noise)],
        16: [("fixed_sample", torch.cat([noise] * 2)[:16])],
        32: [("fixed_sample", torch.cat([noise] * 4)[:32])],
        128: [("decode", z_all[:128])],
        256: [("extract_latent", x_all), ("decode", z_all)],
    }
    cs.reset_launch_counts()
    for b, calls in sorted(cases.items()):
        for name, arg in calls:
            kernel = {"fixed_sample": lambda a: density.fixed_sample(a),
                      "decode": lambda a: ma.decode(density, a),
                      "extract_latent": lambda a: ma.encode(density, a)}[name](arg)
            with torch.no_grad():
                conv = (density._fixed_sample(arg) if name == "fixed_sample" else getattr(density, name)(arg))
            _against(f"B={b} {name}: kernel route vs conv route", kernel.cpu(), conv.cpu(), SAMPLE_TOL)
    n_compared = sum(len(c) for c in cases.values())
    assert cs.LAUNCHES == n_compared * MNIST_COUPLINGS

    # The two-dim manifold: a full-width d=2 model, its 8x8 grid (B=64).
    schema2 = get_schema({**setup["config"], "latent_dimension": 2})
    gen = torch.Generator().manual_seed(0)
    two = get_density(schema2, x_shape=(1, 28, 28), device=dev, generator=gen)
    cs.reset_launch_counts()
    grid = experiment.two_dim_manifold_grid(two)
    torch.cuda.synchronize()
    grid_launches = cs.LAUNCHES
    latents = torch.as_tensor(experiment.two_dim_manifold_latents(), device=dev)
    with torch.no_grad():
        grid_conv = two.decode(latents).cpu().numpy()
    two_cpu = get_density(schema2, x_shape=(1, 28, 28), device="cpu")
    two_cpu.load_state_dict({k: v.cpu() for k, v in two.state_dict().items()})
    grid_cpu = experiment.two_dim_manifold_grid(two_cpu)
    print(f"[metric-mnist] two-dim manifold grid {grid.shape} in [{grid.min():.4g}, {grid.max():.4g}], "
          f"{grid_launches} coupler launches")
    assert grid.shape == (64, 1, 28, 28) and grid_launches == MNIST_COUPLINGS
    _against("B=64 two-dim manifold: kernel route vs conv route", grid, grid_conv, SAMPLE_TOL)
    _against("two-dim manifold: card vs CPU", grid, grid_cpu, SAMPLE_TOL)

    # Card against CPU on the same weights and draws.
    cpu = get_density(setup["schema"], x_shape=(1, 28, 28), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in density.state_dict().items()})
    z4 = z_all[:METRIC_CPU_JAC_POINTS]
    t0 = time.perf_counter()
    card_g, card_order = ma.g_kk_sort(density, z4)
    cpu_g, cpu_order = ma.g_kk_sort(cpu, z4.cpu())
    card_macs, card_cos = ma.macs(density, z4)
    cpu_macs, cpu_cos = ma.macs(cpu, z4.cpu())
    jac_cpu_s = time.perf_counter() - t0
    _against(f"g_kk at {METRIC_CPU_JAC_POINTS} points: card vs CPU", card_g, cpu_g, METRIC_TOL)
    print(f"[metric-mnist] g_kk order equal {bool((card_order == cpu_order).all())}; MACS card "
          f"{card_macs:.8g}, CPU {cpu_macs:.8g} ({jac_cpu_s:.2f} s for both sides)")
    _against("MACS: card vs CPU", [card_macs], [cpu_macs], METRIC_TOL)
    _against("|cos| matrix: card vs CPU", card_cos, cpu_cos, METRIC_TOL)
    x16 = x_all[:METRIC_CPU_CURVE_POINTS]
    t0 = time.perf_counter()
    card_rec, card_fid = ma.effective_z_curves(density, x16, order, centred_means)
    cpu_rec, cpu_fid = ma.effective_z_curves(cpu, x16.cpu(), order, centred_means)
    curves_cpu_s = time.perf_counter() - t0
    print(f"[metric-mnist] effective-z at {METRIC_CPU_CURVE_POINTS} points, card vs CPU ({curves_cpu_s:.2f} s):")
    _against("  recon", list(card_rec.values()), list(cpu_rec.values()), CURVE_RECON_TOL)
    _against("  FID", list(card_fid.values()), list(cpu_fid.values()), CURVE_FID_TOL)
    t0 = time.perf_counter()
    for name, fn, draw in (("samples_cumulative", ma.prominent_z_cumulative, noise),
                           ("samples_sequential", ma.prominent_z_combined, noise),
                           ("samples_hierarchical", ma.prominent_z_hierarchical, seeds)):
        imgs, nrow = fn(cpu, order, draw.cpu())
        assert nrow == out["grids"][name][1]
        _against(f"{name} grid: card vs CPU", out["grids"][name][0], imgs, SAMPLE_TOL)
    print(f"[metric-mnist] grids on the CPU: {time.perf_counter() - t0:.2f} s")
    _against("sweeps: card vs CPU", out["sweeps"], ma.prominent_z_sweeps(cpu, z_all.cpu(), order), SAMPLE_TOL)

    # The coupler kernel's time at the path's batch sizes: the 28x28
    # checkerboard coupler (1->2 channels, hidden 64, 8 blocks).
    net = next(m for m in density.modules() if type(m).__name__ == "ResNet" and m.conv_in.w.shape[1] == 1)
    blocks, hidden, c_out = len(net.blocks), net.c_hidden, net.conv_out.w.shape[0]
    n_weights = sum(p.numel() for p in net.parameters())
    for b in METRIC_TIMED_BATCHES:
        xb = torch.randn((b, 1, 28, 28), generator=torch.Generator().manual_seed(b)).to(dev)
        with torch.no_grad():
            params = net.kernel_params()
            ms = cuda_ms(lambda: cs.coupler_stack_cuda(xb, params), iters=20, warmup=3)
            device_ms = profiled_device_ms(lambda: cs.coupler_stack_cuda(xb, params), "coupler_stack_kernel",
                                           iters=10)
            library_ms = cuda_ms(lambda: net(xb), iters=20, warmup=3)
        n_flops = cs.flops(b, 1, hidden, c_out, blocks, 28, 28)
        n_tc = cs.tensor_core_flops(b, hidden, blocks, 28, 28)
        b_ms, b_by = bound_ms(4 * (xb.numel() + n_weights + b * c_out * 28 * 28), n_flops - n_tc, 3 * n_tc)
        dev_txt = "not measured" if device_ms is None else f"{device_ms:.6f} ms"
        print(f"[metric-mnist] {smi}: coupler_stack B={b} 1->2 28x28 (plan: cluster "
              f"{cs.plan_launch(b, 1, hidden, 28, 28).cluster}): {ms:.6f} ms a call back to back (CUDA "
              f"events), kernel device time {dev_txt}; bound {b_ms:.6f} ms ({b_by}, 3xTF32); cuDNN module "
              f"(fp32) {library_ms:.6f} ms")

    # load_run on the default run dir: bit-equal to its best_valid checkpoint.
    run = experiment.load_run(default_run_dir)
    saved = torch.load(os.path.join(default_run_dir, "checkpoints", "best_valid.pt"), weights_only=True)
    loaded = make_checkpoint(run["trainer"])
    tensors = [(sec, k) for sec in ("params", "model_state", "opt_states") for k in saved[sec]]
    same = all(torch.equal(loaded[sec][k], saved[sec][k]) for sec, k in tensors)
    print(f"[metric-mnist] load_run: restored `{run['trainer'].restored_from}' after epoch "
          f"{run['trainer'].epoch}; {len(tensors)} tensors bit-equal to best_valid.pt {same}")
    assert run["trainer"].restored_from == "best_valid" and same, "load_run differs from best_valid"

    # --print-model on the card and on the CPU.
    texts = []
    for extra in ([], ["--device", "cpu"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_main(["--model", "non-square", "--dataset", "mnist", "--synthetic-data", "--print-model"] + extra)
        texts.append(buf.getvalue())
    print(f"[metric-mnist] --print-model: {texts[0].count(chr(10))} lines, card and CPU equal {texts[0] == texts[1]}")
    assert texts[0] == texts[1] and texts[0].startswith("DequantizationDensity")

    # --profile-dir: a torch.profiler trace of epoch 2 of a miniboone run.
    profile_dir = os.path.join(root, "profile")
    gl.reset_launch_counts()
    (prof_setup,) = cli_main(PROFILE_ARGV + ["--profile-dir", profile_dir])
    path = prof_setup["trainer"].profile_path
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    kernels = sorted(n for n in names if "gram_logdet" in n and "kernel" in n)
    print(f"[metric-mnist] --profile-dir: {os.path.basename(path)}, {len(names)} event names; Gram/log-det "
          f"kernels named: {kernels}")
    assert path.endswith("trace_epoch2.json")
    assert any("gram_logdet_fwd_kernel" in n for n in kernels), "the trace names no forward kernel"
    assert any("gram_logdet_bwd_kernel" in n for n in kernels), "the trace names no backward kernel"
    print(f"[metric-mnist] the phase took {time.perf_counter() - phase_t0:.2f} s")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run", file=sys.stderr)
        return 1
    name, smi = phase_device()
    phase_build()
    kernels = phase_kernels() + [phase_coupler_kernel()]
    phase_kernels_small()
    counts, step_ms = phase_train()
    phase_captured(step_ms)
    phase_warmup()
    runs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs")
    os.makedirs(runs, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_", dir=runs)
    try:
        default_run_dir = phase_default(smi, root)
        phase_default_sphere(smi)
        phase_cmf_battery(smi)
        setup = phase_train_mnist()
        phase_sample(setup)
        phase_inception(smi)
        mnist_setup, coupler_launches = phase_default_mnist(smi)
        counts["COUPLER_LAUNCHES"] = coupler_launches
        phase_ood(mnist_setup, smi)
        phase_metric_mnist(setup, default_run_dir, root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k in kernels:
        k["launches"] = counts[k.pop("_launches_key")]
        assert k["launches"] > 0, f"{k['name']} was never launched on its path"
    print(json.dumps({"kernels": kernels}))
    print(f"{smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
