#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``cmf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on its own failure:

1. device      -- the card's name and power limit; TF32 off.
2. build       -- nvcc builds ``cmf_tpu_torch/csrc/*.cu`` for sm_90a, one
                  process per source, all at once; each kernel's ptxas line
                  and the Gram/log-det kernels' launch geometry.
3. kernels     -- each kernel against its plain PyTorch version on the card,
                  at the main-path shapes and edge shapes (the Gram/log-det
                  kernels also at the other tabular defaults' shapes, each
                  timed: power, gas, gas --baseline, hepmass, bsds300); a
                  rank-deficient
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
15. ood        -- ``density.ood`` of that model on 25 synthetic mnist and
                  25 synthetic fashion-mnist test images, card against CPU
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
17. mflow      -- the M-flow baseline: miniboone --baseline at full width
                  with the published defaults, the warm-up cut to 1 -> 2, 6
                  epochs of 2 batches into a run dir (epoch 1 skipped, the
                  two optimizers on alternate epochs, FID validation at
                  epochs 4 and 6, one graph a key, no Gram/log-det launch);
                  10 captured steps of each key against 10 eager ones, each
                  leaving the other group's parameters and optimizer state
                  bit-equal, no Gram/log-det launch; ms a step and idle
                  share of each key; one step of each key on the card
                  against the CPU; the run dir resumed to epoch 8 (both
                  optimizers' states bit-equal to `latest'); mnist
                  --baseline with the published defaults, cut the same
                  way under --nosave (FID validation at 4 and 6 through
                  the coupler kernel, then sample(50): 10 coupler
                  launches, against the conv route); sphere
                  --baseline (forward launches = evaluation batches, no
                  backward); the optimizer options (adamax, sgd, cosine,
                  clipping that acts, weight decay, and all at once under
                  M-flow): 5 captured steps a key against eager ones, the
                  ms of a captured step beside Adam's, one update on the
                  card against the CPU's from the same state and gradients,
                  the rate read back from the device against the formula.
18. square-cif -- the tabular square NSF and CIFs at miniboone's published
                  widths: ``--model maf``, ``--model nsf-ar --baseline``,
                  ``--model nsf-ar`` and ``--model cond-affine`` (a two-job
                  grid), each into a run dir for 1-2 epochs of 3 steps
                  (validation by FID where early stopping is on, a test
                  pass at epoch 1 with FID on 10,000 samples, checkpoints),
                  with no Gram/log-det or coupler launch over the runs;
                  each run dir resumed one epoch (its restored state and
                  generator bit-equal to ``latest``, trained through a
                  graph) and tested (``--test --resume``, 50,000 FID
                  samples); then for each model 3 captured steps against 3
                  eager ones (the CIF's u drawn inside the graph from the
                  trainer's registered generator), ms a captured step and
                  its idle share, ms an eager step, a card step against the
                  CPU on the same u, and one ``sample(5000)`` call under the
                  profiler (not the CIF NSF's: its inverse is the square
                  NSF's); the spline knots' running sum by ``torch.cumsum``
                  against the port's triangular product.
19. image-square -- the image square flows and image CIFs at their published
                  widths and depths: ``--dataset mnist --model realnvp`` with
                  and without ``--baseline`` (batch-norm ResNet couplers),
                  ``--dataset cifar10 --model glow --baseline`` and
                  ``--dataset mnist --model glow`` (LU invconvs, GlowCNN),
                  after the image grid's refusal of a run dir on a card
                  without matplotlib and each ``--print-num-params``
                  against the published count: each under ``--nosave`` for
                  one epoch of 3 steps at the published batch (FID on
                  1,000 samples; glow at lr 1e-6, after one epoch at its
                  published 5e-4, whose second step's loss is not finite
                  in either package: the freeze and the raise checked),
                  with no Gram/log-det or coupler launch
                  over the runs; each trainer saved, restored into a fresh
                  setup (every tensor bit-equal, the batch-norm running
                  statistics among them), trained a second epoch and tested
                  (``Trainer.test()``, as ``--test`` runs it); ms an eager
                  step by the host clock and by CUDA events, one step's
                  device ops, busy ms and idle share, ms a FID pass,
                  ``sample(n)`` at the test chunk under the profiler; a card
                  step at batch 8 against the CPU's from the same weights
                  and draws: in fp64 the loss within 1e-4 and every
                  gradient within 1e-3 of max |grad|; in fp32 the loss
                  within 1e-4 and the running statistics within 1e-5 (a
                  batch-norm network's fp32 gradients at batch 8 are
                  further than 1e-3 apart on any two devices: each side's
                  are held within 0.2 of the fp64 step's max |grad|).
20. square-2d  -- the 2-D zoo's square flows and CIFs: the 14 published 2-D
                  commands on 2uniforms (``--model sos|planar|bnaf|maf|
                  realnvp|nsf-ar``, each with and without ``--baseline``,
                  ``affine --baseline``, and the coupled spline ``nsf-ar
                  --baseline --config autoregressive=False``) at their
                  published widths, depths and batch of 1000 under
                  ``--nosave``, for 2 epochs of 3 steps with a validation
                  each epoch and a test pass at epoch 1, with no
                  Gram/log-det or coupler launch over the runs; ``sample``
                  raising for the forward-only sos, planar and BNAF; for
                  each, 3 captured steps against 3 eager ones, ms a captured
                  step, its device ops and idle share, a card step against
                  the CPU's on the same u; then the coupled spline at
                  miniboone's published widths into a run dir (resumed one
                  epoch bit-equal, ``--test --resume`` with 50,000 FID
                  samples, its captured steps, card against CPU, one
                  ``sample(5000)`` profiled beside the AR NSF's); and one
                  sos layer at the published tabular widths (D = 43, [200]x2,
                  K = 5, r = 4) over 1000 rows, card against CPU, with the
                  finite rows of the published 8 layers without batch-norm.
21. hutch-gram -- the flagship's Hutchinson run (``--config
                  log_jacobian_method=hutch_with_cg``), whose 'auto' solver is
                  the exact Gram: into a run dir with the published warm-up
                  for 28 epochs of 2 batches (the likelihood from epoch index
                  26, one graph a flag key, the probes drawn inside the
                  graph; no Gram/log-det launch, since a FID dataset's
                  non-square run validates by FID and tests a zero loss),
                  resumed one epoch and ``--test --resume``d; with
                  ``likelihood_warmup=False`` (FID validation at epochs 1
                  and 2); the sphere's Hutchinson run, whose Gram/log-det
                  forward launches must equal its evaluation batches (no
                  backward launch); 10 captured against 10 eager steps; ms a
                  captured step beside the exact step's, its idle share, an
                  eager step; a card step against the CPU on the same probes.
22. batchnorm  -- the published tabular batch-norm models on miniboone
                  (``--model realnvp``, ``realnvp --baseline``, ``maf
                  --baseline``, ``sos --baseline`` validated by -log-prob,
                  since sos has no inverse and so no FID) at their widths and
                  depths into run dirs, one epoch of 3 steps: one graph each,
                  a refresh over the stored rows before each evaluation, no
                  Gram/log-det or coupler launch; each resumed and tested;
                  for each, 3 captured against 3 eager steps (the statistics
                  too), ms a captured step and its idle share, a card step
                  against the CPU, a test pass that leaves the training
                  statistics bit-equal, one refresh over the whole synthetic
                  train split timed; sos's finite rows at init with its
                  batch-norm.
23. tabular-table -- the paper's tabular table: power's published non-square
                  model (D = 6, d = 2, batch 5000) from a raw-format
                  ``power/data.npy`` of 62,000 x 8 rows (10 steps an
                  epoch), an RNF arm (lambda 0) and a CMF arm (lambda 1,
                  g_ij) of 2 seeds each for 3 epochs into run dirs, each
                  arm's seeds over two CLI calls with ``--grid-shard 0/2``
                  and ``1/2``: one graph a run, Gram/log-det launches equal
                  to the training steps (added to the kernels line); each
                  run ``--test --test-fid --resume``d (50,000 samples);
                  ``collect_fid`` and ``collect_test_loss`` of
                  ``cmf_tpu_torch.analysis`` over the runs, one row an arm
                  with n = 2, and ``python -m cmf_tpu_torch.analysis
                  tabular``; ms a captured step. Where the card's machine
                  has no matplotlib, the 4/6-D visualiser of the run dirs
                  draws into a stand-in (its numbers are computed, its
                  figures are empty files).
24. nonsquare-bn -- the flagship with ``--config batch_norm=True`` at
                  published widths into a run dir, 2 epochs of 3 steps with
                  the likelihood from step 1 (the decode through the dense
                  program's 10 ``bn`` steps): one graph, Gram/log-det
                  launches equal to the steps (backward) and the steps plus
                  the refreshes (forward), added to the kernels line;
                  resumed one epoch bit-equal and ``--test --resume``d; 3
                  captured against 3 eager steps, the statistics too; ms a
                  captured step; a card step against the CPU; then mnist's
                  non-square model with ``resnet_batchnorm=True`` (each
                  coupler 2 blocks of the published 8, width 64) for 3
                  Hutchinson steps (no kernel launch), ms an eager step,
                  and a card step at batch 8 against the CPU on the same
                  noise and probes (fp64 and fp32, the running statistics
                  too).

The phases of ``compute_dtype="bfloat16"`` and the dense decode program's
conv stages:

3b. coupler-bf16 -- the coupler kernel's ``bf16=True`` variant against its
                  plain version (bf16-rounded operands, fp32 sums) at the
                  main-path and edge shapes, with the model's own weight
                  scale, within 1e-2 of max |ref| and within a third of the
                  plain bf16 version's gap to fp32, where a version that
                  rounds only the weights must fail; its times, bound (the
                  hidden convs at 989 TFLOP/s) and the ``ResNet`` module
                  under the bf16 policy (cuDNN bf16) as its yardstick.
25. bf16-flagship -- the flagship under ``--config compute_dtype=bfloat16``
                  at its published width, 2 epochs of 10 steps with the
                  likelihood from step 1: one graph, one launch of each
                  Gram/log-det kernel a step (added to the kernels line);
                  10 captured against 10 eager steps; ms a captured step
                  beside the fp32 one of phase 5; a card step against the
                  CPU (loss within 1e-2, gradients within 5e-2 of max
                  |grad|).
26. bf16-mnist -- mnist non-square at full width under bf16, 3 Hutchinson
                  steps; ms a step beside the fp32 model's; a card step at
                  batch 8 against the CPU at phase 25's limits;
                  ``sample(250)`` through the coupler kernel's bf16 variant
                  (10 bf16 launches, the kernels line's count, and no fp32
                  one) and against the conv route.
27. conv-gram  -- mnist at full width with ``--config
                  hutchinson_solver=gram`` in fp32 and in bf16, 3 steps
                  each: the d columns through the dense program's conv
                  stages, against the vmap of JVPs at 10 images (1e-3 in
                  fp32; in bf16 1e-1 on the card, the CPU test's 1e-2 on a
                  CPU copy at 2 images, and the program at least a quarter
                  as far from the fp32 columns as the bf16 JVP's); one bf16
                  conv against its once-rounded exact sum; ms a step; the
                  route, and the
                  gram-route loss and backward captured in a CUDA graph
                  with their draws passed in, against eager.
28. mesh       -- the parallel slice on the one card: the flagship (one
                  epoch of 10 steps) through ``torchrun --nproc_per_node 1
                  chip_smoke.py --mesh-rank`` (the CLI with ``--mesh
                  data=1`` over NCCL, captured) against the un-meshed run of
                  the same seed (1e-6 relative), each captured step's ms and
                  the NCCL kernels inside one trace of replays; the
                  flagship's head under a (1 x 1) column partition, every
                  step through kernel 4 (``fused_gram_logdet_sharded``, its
                  launches the kernels line's count); kernel 4 alone
                  against ``fused_gram_logdet`` at the main shape, its ms,
                  device ms and the collectives'; two ranks on the card over
                  gloo (``chip_smoke.py --gloo-rank``): each collective the
                  step and kernel 4 need on CUDA tensors, and a data=2 step
                  against one rank's where gloo takes them.

The phases of the asynchronous checkpoint backend and of the ``sigmoid``
and u-channel ``acl`` layers:

29. async-ckpt -- the flagship's published defaults with the likelihood from
                  step 1 (FID validation and ``best_valid`` from epoch 1)
                  into a run dir for 4 epochs of 2 batches, once with
                  ``--config checkpoint_backend=orbax`` (the save on a
                  worker thread) and once with the default, from one seed:
                  Gram/log-det launches equal to the likelihood steps (added
                  to the kernels line); both runs' ``latest`` and
                  ``best_valid`` equal tensor for tensor; each run dir
                  resumed to epoch 6 and equal again; the ms a save blocks
                  training and the ms of its write, each backend.
30. cif-u      -- an image CIF at mnist's shape from a schema: mnist's logit
                  preprocessing with a ``sigmoid`` layer, four checkerboard
                  ``acl`` layers with one u-channel and batch-norm-free
                  ResNet couplers at mnist's widths ([64]x8; p and q
                  [64]x2): 3 steps on the card, each against the CPU's from
                  the same weights and draws; ``sample(250)``, whose 8
                  coupler kernel launches (added to the kernels line) take
                  the passthrough and u channels (C_in 2 and 5), each call
                  held against the kernel's plain version; the samples
                  against the conv route; the kernel's ms at C_in 2.

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
# The other tabular defaults' shapes (d, train batch, D): power, gas, gas
# under --baseline (d=4), hepmass, bsds300; each checked and timed.
TABULAR_SHAPES = [(2, 5000, 6), (2, 2500, 8), (4, 2500, 8), (10, 750, 21), (30, 250, 63)]
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
MNIST_HIDDEN = 64  # the width of the mnist ResNet couplers ([64]x8)
# H100 SXM peaks (NVIDIA data sheet), at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_BF16_FLOP_PER_S = 989e12
# The coupler kernel's bf16=True instance against its plain version
# (bf16-rounded operands, fp32 sums), max |err| / max |ref|: the two sum in
# other orders, so a later conv's bf16 rounding of an activation can land
# one bf16 ulp (2^-8 relative) apart. Within 1e-2, and within a third of the
# plain bf16 version's own gap to fp32 at the same inputs: on an H100 the
# kernel lands at 0.26 of that gap or less at every shape, a version that
# rounds only the weights at 0.59 of it or more, and the fp32 arithmetic at
# the whole of it.
COUPLER_BF16_TOL = 1e-2
COUPLER_BF16_GAP_SHARE = 1 / 3

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
OOD_IMAGES = 25  # a dataset; the CPU side takes about half a second an image
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

# compute_dtype=bfloat16: the coupler nets' matmuls and convs on
# bf16-rounded operands, the rest fp32. The card against the CPU in bf16:
# both round the same tensors, and differ where another order of fp32 sums
# moves a bf16 rounding, so the limits are the CPU tests' against cmf_tpu.
BF16_LOSS_TOL = 1e-2
BF16_GRAD_TOL = 5e-2
BF16 = ["--config", "compute_dtype=bfloat16"]
# The flagship at its published width (D 43, d 21, 10 couplings of [128]x4,
# prior 5 x [32]x2, batch 400) under bf16: TRAIN_ARGV's 2 epochs of 10 steps.
BF16_FLAGSHIP_ARGV = TRAIN_ARGV + BF16
# mnist non-square at full width (ResNet [64]x8, d 20, batch 50), Hutchinson
# + CG: 3 steps of 50.
BF16_MNIST_ARGV = [a if a != "max_dataset_size=500" else "max_dataset_size=150" for a in TRAIN_MNIST_ARGV]
# The same with --config hutchinson_solver=gram: the d columns through the
# dense program's conv stages; its columns and reconstruction against the
# vmap of JVPs at CONV_GRAM_CHECK_BATCH images, max |err| / max |ref|.
# In fp32 cuDNN sums the program's merged (d+1)·B batch and the JVPs'
# primal and tangent batches in other orders, and the trained model grows
# those roundings: on an H100 each route's columns lie from 3e-7 to 7e-4
# of the fp64 columns, and the two routes from 2e-4 to past 1e-3 of each
# other, from run to run. So the program is held to the JVPs where both
# sum alike: in fp64 on a copy of the model within CONV_GRAM_FP64_TOL
# (4e-16 to 6e-16 on an H100), and in fp32 with cuDNN off (the native conv
# sums each image alike whatever the batch) within CONV_GRAM_TOL (1.6e-7
# to 2.7e-7). Under cuDNN, as the path runs, its fp32 results are held
# within CONV_GRAM_CUDNN_TOL of the fp64 ones, which a program in bf16
# (3e-2 from fp32) fails.
CONV_GRAM_ARGV = BF16_MNIST_ARGV + ["--config", "hutchinson_solver=gram"]
CONV_GRAM_CHECK_BATCH = 10
CONV_GRAM_TOL = 1e-3
CONV_GRAM_FP64_TOL = 1e-9
CONV_GRAM_CUDNN_TOL = 1e-2
# In bf16 the two routes agree on the CPU, where a conv's outputs do not
# depend on its batch: there (a copy of the model, CONV_GRAM_CPU_BATCH
# images) they are held to the CPU test's limit, 1e-2 and below the bf16
# gap to fp32 (tests/test_torch_decode_jac.py); an H100 machine's CPU gave
# 2.6e-4 on the columns and 0 on the reconstruction. On the card cuDNN
# sums the merged batch and the vmapped one in other orders: one bf16 conv
# rounds its exact sum once but for ~3e-4 of its outputs (the phase prints
# it), and ten couplings grow those moved roundings until the two routes'
# columns lie 2.6e-2 to 3.7e-2 apart, about as far as each lies from the
# fp32 columns (2e-2 to 5e-2, four batches on an H100). There the columns
# are held within 1e-1 and the reconstruction within the CPU test's 1e-2;
# and the program's bf16 results must lie at least a quarter as far from
# the fp32 JVP's as the bf16 JVP's do (0.63 to 1.67 on an H100), which a
# program that ignores the policy (0.05 or less) fails.
CONV_GRAM_CPU_BATCH = 2
CONV_GRAM_CPU_TOL = 1e-2
CONV_GRAM_BF16_TOL = 1e-1
CONV_GRAM_BF16_REC_TOL = 1e-2
CONV_GRAM_BF16_MIN_SHARE = 0.25

# The M-flow baseline (--baseline) on miniboone at full width with the
# published defaults, cut to 6 epochs of 2 batches and the warm-up to start
# 1, end 2: engine epoch 1 is skipped (the likelihood is not in yet), then
# reconstruction (optimizer 0) on even and the likelihood (optimizer 1) on
# odd epochs; FID validation from epoch 4 every second epoch; a run dir;
# then resumed to epoch 8.
MFLOW_ARGV = [
    "--model", "non-square", "--dataset", "miniboone", "--synthetic-data", "--baseline",
    "--config", "max_epochs=6", "--config", "max_dataset_size=800", "--config", "seed=0",
    "--config", "likelihood_warmup_start=1", "--config", "likelihood_warmup_end=2",
]
MFLOW_RESUME_EPOCHS = 8
# Captured against eager: this many steps of each flag key.
MFLOW_STEPS = 10
# mnist --baseline with the published defaults under --nosave, cut as the
# miniboone run is: 100 images (2 steps of 50), the warm-up 1 -> 2, 6
# epochs, so FID validation (10,000 samples, proxy features) at epochs 4
# and 6 and the test at 1; then sample(50) through the coupler kernel.
MFLOW_MNIST_ARGV = [
    "--model", "non-square", "--dataset", "mnist", "--synthetic-data", "--baseline", "--nosave",
    "--config", "max_dataset_size=100", "--config", "likelihood_warmup_start=1",
    "--config", "likelihood_warmup_end=2", "--config", "max_epochs=6", "--config", "seed=0",
]
MFLOW_SAMPLE_BATCH = 50
# The README's sphere under --baseline: validation (-elbo through the exact
# log-det) every second epoch, the test after epoch 1.
MFLOW_SPHERE_ARGV = [
    "--model", "non-square", "--dataset", "sphere", "--baseline", "--nosave",
    "--config", "max_epochs=4", "--config", "seed=0",
]
# The optimizer options on miniboone at full width (TRAIN_ARGV's model and
# data, the likelihood on): each alone, and all at once under M-flow.
# OPTION_STEPS captured steps a key against eager ones; the clip's maximum
# is a quarter of the first step's measured gradient norm, so that it acts.
OPTION_STEPS = 5
OPTION_CONFIG = {"likelihood_warmup": False, "max_dataset_size": 4000, "seed": 0, "max_epochs": 2,
                 "early_stopping": False, "use_fid": False, "synthetic_data": True, "nosave": True}
# The optimizer's update on the card against the same update on the CPU from
# the same state and gradients: elementwise fp32 (a sqrt, a pow, a cos, the
# group norm summed in another order), so a few rounding units. Each state
# tensor: max |diff| / max |ref|. The parameters: the same over each
# parameter tensor, where one rounding unit of p is 1.2e-7 of it.
OPT_TOL = 1e-5
OPT_PARAM_TOL = 1e-6
# The tabular square NSF and CIFs: miniboone's published configs at full
# width (``config/defaults/tabular.py``), each run into a run dir for a few
# steps: (tag, CLI model arguments, dataset cap, epochs, jobs). The cap
# applies to every split, so it sets the steps an epoch (3 at the published
# batch, 1000 for maf and cond-affine, 64 for the NSFs) and the test split's
# rows; the FID keeps its published 10,000 samples in chunks of 5,000.
SQUARE_CIF_RUNS = [
    ("maf", ["--model", "maf"], 3000, 1, 1),
    ("nsf-ar --baseline", ["--model", "nsf-ar", "--baseline"], 192, 2, 1),
    ("nsf-ar", ["--model", "nsf-ar"], 192, 2, 1),
    ("cond-affine", ["--model", "cond-affine"], 3000, 1, 2),
]
# The image square flows and image CIFs: the four published commands at
# their widths and depths (``config/defaults/images.py``): (tag, CLI
# arguments, rows of every split, the published parameter count). Each runs
# under --nosave (the card has no matplotlib for the image grid a run dir
# draws) for one epoch of 3 steps at the published batch (100 for realnvp,
# 64 for glow), the FID cut to IMAGE_SQUARE_FID_SAMPLES samples (published
# 10,000).
IMAGE_SQUARE_RUNS = [
    ("realnvp mnist --baseline", ["--model", "realnvp", "--dataset", "mnist", "--baseline"], 300, 5_932_070),
    ("realnvp mnist", ["--model", "realnvp", "--dataset", "mnist"], 300, 5_988_872),
    ("glow cifar10 --baseline", ["--model", "glow", "--dataset", "cifar10", "--baseline"], 192, 44_312_832),
    ("glow mnist", ["--model", "glow", "--dataset", "mnist"], 192, 9_731_584),
]
IMAGE_SQUARE_FID_SAMPLES = 500
# glow's published rate (adamax, 5e-4) does not survive its second step on
# the synthetic stand-in, in either package: the first adamax step moves
# every weight by ±lr, the zero-initialised output convs of every coupling
# among them, and the second step's loss leaves fp32's range at full width
# (``tests/_glow_rate_probe.py`` prints both packages' losses from the same
# weights at a cut width: a jump of five orders of magnitude in each). The
# phase holds the port to that at the published rate (the freeze keeps the
# first step's state, the epoch raises), then trains glow at this rate.
GLOW_SMOKE_LR = 1e-6
# The card step against the CPU's: batch 8, as the parity tests hold the
# port to cmf_tpu on the CPU; then every running statistic, max |diff| over
# max |ref| per tensor (one fp32 mean and variance update of a batch).
IMAGE_SQUARE_STEP_BATCH = 8
BN_STATE_TOL = 1e-5
# The gradients of a batch-norm network at batch 8 are ill-conditioned in
# fp32: its backward subtracts the batch means of the incoming gradient, and
# a conv weight's gradient is what is left of sums that cancel. On the
# realnvp models an fp32 step lands up to 1.3e-2 (the CPU) and 3.7e-2 (the
# card, whose cuDNN wgrad sums in a varying order) of max |grad| from the
# fp64 step, and varies from run to run. So the card is held to the CPU in
# fp64, where both compute the same function to ~1e-12, at STEP_LOSS_TOL and
# STEP_GRAD_TOL; in fp32, the loss at STEP_LOSS_TOL and each side's
# gradients within this of the fp64 step's max |grad|.
FP32_BN_GRAD_TOL = 0.2
# The runs whose sample(5000) the phase profiles: the CIF NSF inverts through
# the square NSF's AR splines, and a profile of its ~48,000 ops costs seconds.
SQUARE_CIF_SAMPLE_PROFILED = ("maf", "nsf-ar --baseline", "cond-affine")
# The 2-D zoo's square flows and CIFs: the published 2-D commands
# (``config/defaults/two_d.py``) on 2uniforms at every published width and
# depth and the published batch of 1000, under --nosave, cut to
# SQUARE_2D_EPOCHS epochs of 3 steps (every split capped at
# SQUARE_2D_ROWS rows), with a validation every epoch and a test pass at
# epoch 1. (tag, CLI model arguments).
SQUARE_2D_RUNS = [
    ("sos", ["--model", "sos"]),
    ("sos --baseline", ["--model", "sos", "--baseline"]),
    ("planar", ["--model", "planar"]),
    ("planar --baseline", ["--model", "planar", "--baseline"]),
    ("bnaf", ["--model", "bnaf"]),
    ("bnaf --baseline", ["--model", "bnaf", "--baseline"]),
    ("maf", ["--model", "maf"]),
    ("maf --baseline", ["--model", "maf", "--baseline"]),
    ("realnvp", ["--model", "realnvp"]),
    ("realnvp --baseline", ["--model", "realnvp", "--baseline"]),
    ("nsf-ar", ["--model", "nsf-ar"]),
    ("nsf-ar --baseline", ["--model", "nsf-ar", "--baseline"]),
    ("affine --baseline", ["--model", "affine", "--baseline"]),
    ("nsf-c --baseline", ["--model", "nsf-ar", "--baseline", "--config", "autoregressive=False"]),
]
SQUARE_2D_DATASET = "2uniforms"
SQUARE_2D_ROWS = 3000
SQUARE_2D_EPOCHS = 2
# The layers with no analytic inverse: a model with one has no ``sample``.
FORWARD_ONLY_MODELS = ("sos", "planar", "bnaf")
# The coupled spline at miniboone's published widths (``tabular.py``: a
# random permutation, an LU linear layer and ``nsf-c`` a layer), cut as the
# square-cif phase cuts the NSF: 192 rows, 3 steps of 64 an epoch, 2 epochs.
NSF_C_MINIBOONE = ["--model", "nsf-ar", "--baseline", "--config", "autoregressive=False"]
NSF_C_ROWS, NSF_C_EPOCHS = 192, 2
NSF_C_SAMPLES = 5000
# The AR NSF's sample(5000) that the square-cif phase profiled (PERF.md §5,
# PR 13's final run): its inverse is 43 sequential passes, the coupled
# spline's one.
AR_NSF_SAMPLE_MS = 1102.21
# One sos layer at the published tabular widths (``tabular.py``: D = 43,
# g_hidden [200]x2, K = 5, r = 4), over a batch of 1000 synthetic miniboone
# rows; and the published 8 layers with flips, forward only (without the
# batch-norm between them the degree-9 powers compound).
SOS_TABULAR = {"type": "sos", "hidden_channels": [200, 200], "activation": "tanh", "num_polynomials": 5,
               "polynomial_degree": 4}
SOS_TABULAR_LAYERS, SOS_TABULAR_BATCH = 8, 1000
# The flagship's Hutchinson run (``--config log_jacobian_method=hutch_with_cg``,
# every other setting published), whose 'auto' solver is the exact Gram:
# into a run dir with the published warm-up (25 -> 50), cut to HUTCH_EPOCHS
# epochs of 2 batches of 400, so epoch index 26 is the first through the
# solver; FID tests at epochs 1, 6, ..., 26 on 10,000 samples.
HUTCH_ARGV = ["--model", "non-square", "--dataset", "miniboone", "--synthetic-data",
              "--config", "log_jacobian_method=hutch_with_cg", "--config", "seed=0"]
HUTCH_EPOCHS, HUTCH_ROWS = 28, 800
# Its steps alone, the likelihood on from step 1: 10 batches of 400.
HUTCH_STEPS_ARGV = HUTCH_ARGV + ["--nosave", "--config", "likelihood_warmup=False", "--config", "max_dataset_size=4000",
                                 "--config", "early_stopping=False", "--config", "use_fid=False"]
# The sphere's Hutchinson run (published 2-D defaults otherwise): validation
# by -elbo every epoch and a test at epoch 1, both through the exact log-det.
HUTCH_SPHERE_ARGV = ["--model", "non-square", "--dataset", "sphere", "--nosave",
                     "--config", "log_jacobian_method=hutch_with_cg", "--config", "max_epochs=3", "--config", "seed=0"]
# The published tabular batch-norm models (``config/defaults/tabular.py``:
# batch-norm without affine in the CIF, with it under --baseline; momentum 1
# under the passthrough wrapper's 100,000 stored rows) on miniboone at their
# widths and depths: (tag, CLI model arguments). sos has no inverse, so no
# sample and no FID (ROADMAP §3): it validates by -log-prob.
BATCHNORM_RUNS = [
    ("realnvp", ["--model", "realnvp"]),
    ("realnvp --baseline", ["--model", "realnvp", "--baseline"]),
    ("maf --baseline", ["--model", "maf", "--baseline"]),
    ("sos --baseline", ["--model", "sos", "--baseline", "--config", "use_fid=False"]),
]
# Every split capped at 3,000 rows (3 steps of the published 1,000), one
# epoch into a run dir; the refresh timed over the whole synthetic train
# split (all of it stored).
BATCHNORM_ROWS, BATCHNORM_EPOCHS = 3000, 1
# sos's degree-9 polynomials overflow on about 1% of held-out rows through
# the snapshot statistics, on the same rows in both packages
# (tests/test_torch_batchnorm.py::test_sos_overflows_in_evaluation_as_cmf_tpu_does):
# its validation and test means are not finite, and the phase holds the
# card's overflowing rows to the CPU's instead.
EVAL_OVERFLOWS = ("sos --baseline",)
# The asynchronous checkpoint backend: the flagship's published defaults
# (early stopping, FID validation on 10,000 samples, a test every 5 epochs,
# checkpoints `both') with the likelihood from step 1, so that validation
# and `best_valid' start at epoch 1; 800 rows (2 steps of 400 an epoch) for
# ASYNC_EPOCHS epochs under each backend from one seed, then each run dir
# resumed to ASYNC_RESUME_EPOCHS.
ASYNC_ARGV = ["--model", "non-square", "--dataset", "miniboone", "--synthetic-data",
              "--config", "likelihood_warmup=False", "--config", "max_dataset_size=800", "--config", "seed=0"]
ASYNC_EPOCHS, ASYNC_RESUME_EPOCHS = 4, 6
# An image CIF at mnist's shape (1x28x28) built from a schema, since no
# published config gives an affine coupling u-channels: mnist's realnvp
# preprocessing (dequantization, (1 - 2e-6)/256, +1e-6, logit) with a
# `sigmoid' layer before its logit, then checkerboard `acl' layers with the
# images group's one u-channel: two at 28x28, a squeeze, two at 14x14 (the
# coupler's input C_in = passthrough + u = 1 + 1, then 4 + 1). Their couplers
# are batch-norm-free ResNets at the mnist non-square model's width ([64]x8),
# p(u|z) and q(u|x) at mnist realnvp's published p_nets and q_nets
# ([64]x2); a depth cut of the published 10 couplings.
CIF_U_CHANNELS = 1
CIF_U_LAM = 1e-6


def cif_u_schema():
    def resnet(blocks):
        return {"independent_nets": False,
                "shift_log_scale_net": {"type": "resnet", "hidden_channels": [MNIST_HIDDEN] * blocks,
                                        "batchnorm": False}}

    def acl(reverse):
        return {"type": "acl", "mask_type": "checkerboard", "reverse_mask": reverse,
                "num_u_channels": CIF_U_CHANNELS, "coupler": resnet(8), "p_coupler": resnet(2),
                "q_coupler": resnet(2)}

    return [{"type": "dequantization"}, {"type": "scalar-mult", "value": (1 - 2 * CIF_U_LAM) / 256},
            {"type": "scalar-add", "value": CIF_U_LAM}, {"type": "sigmoid"}, {"type": "logit"},
            acl(False), acl(True), {"type": "squeeze", "factor": 2}, acl(False), acl(True)]


# Each CIF layer's `sample' runs two ResNets through the coupler kernel:
# p(u|z)'s, then the coupling's inverse on [passthrough, u].
CIF_U_LAYERS, CIF_U_C_IN = 4, (2, 2, 5, 5)
CIF_U_STEPS, CIF_U_BATCH = 3, 8
CIF_U_LR = 1e-4


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
    ``key_averages`` came back without device time in later phases); a
    trace now and then holds none of the kernels' events, so a second one
    is taken then; None where both hold none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(float(e.get("dur", 0)) for e in trace_events(prof)
                       if e.get("ph") == "X" and e.get("cat") == "kernel" and name in e.get("name", ""))
        if total_us:
            return total_us / iters / 1e3
    return None


def bound_ms(n_bytes, n_flops, n_tf32_flops=0, n_bf16_flops=0):
    """The least time for the work: bytes over the memory rate against
    fp32-pipe FLOPs over 67 TFLOP/s plus tensor-core TF32 FLOPs over 495
    and bf16 FLOPs over 989."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (n_flops / PEAK_FP32_FLOP_PER_S + n_tf32_flops / PEAK_TF32_FLOP_PER_S
             + n_bf16_flops / PEAK_BF16_FLOP_PER_S) * 1e3
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
    for d, b, big_d in [MAIN_SHAPE] + EDGE_SHAPES + TABULAR_SHAPES:
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


def kernel_name(mangled):
    """A kernel's name out of its mangled one: the length-prefixed source
    name that ends in ``_kernel`` (``25coupler_stack_bf16_kernel``); a
    length's digits may follow other digits of the mangled name. Else the
    first run of lower-case letters and underscores that ends in
    ``_kernel``."""
    import re

    for i in range(len(mangled)):
        for j in range(i + 1, len(mangled)):
            if not mangled[j - 1].isdigit():
                break
            name = mangled[j : j + int(mangled[i:j])]
            if name[:1].isalpha() and name.endswith("_kernel") and int(mangled[i:j]) == len(name):
                return name
    plain = re.search(r"[a-z_]+_kernel", mangled)
    return plain.group(0) if plain else mangled


def ptxas_report(log):
    """One line per compiled kernel from nvcc's -Xptxas -v output: its name
    (template arguments kept), registers, static shared memory, spills."""
    import re

    lines, entry = [], None
    for raw in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", raw)
        if m:
            mangled = m.group(1)
            args = re.findall(r"Li(\d+)E", mangled)
            entry = kernel_name(mangled) + (f"<{','.join(args)}>" if args else "")
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
    for shape in [MAIN_SHAPE] + EDGE_SHAPES + TABULAR_SHAPES:
        j = cols(*shape)
        f_rel, f_abs = fwd_errs(j)
        b_rel, b_abs = bwd_errs(j)
        print(f"[kernels] d,B,D={shape}: fwd max rel err {f_rel:.3e} (tol {FWD_TOL:g}), "
              f"abs {f_abs:.3e}; bwd max rel err {b_rel:.3e} (tol {BWD_TOL:g}), abs {b_abs:.3e}")
        assert f_rel <= FWD_TOL, f"forward kernel disagrees with its plain version at {shape}"
        assert b_rel <= BWD_TOL, f"backward kernel disagrees with autograd through the plain version at {shape}"
        results[shape] = (f_abs, b_abs)
        if shape in TABULAR_SHAPES:
            d, b, _ = shape
            _, _, l_k = gl.gram_logdet_fwd_cuda(j)
            gbar = torch.randn((b, d, d), device=dev, generator=gen)
            ldbar = torch.randn((b,), device=dev, generator=gen)
            gram_logdet_times(j, l_k, gbar, ldbar, "kernels")

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


def device_events(prof):
    """(start µs, end µs, name) of a trace's device-side events: kernels,
    copies and fills. An aten op's own device time would count its kernels a
    second time, and so would the spans on the device timeline named after
    a host region (the optimizer's step and zero_grad), which overlap the
    kernels they hold."""
    return sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", ""))
        for e in trace_events(prof)
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
    )


def device_union_and_span(events):
    """The union of ``device_events`` intervals and their span (first start
    to last end), in µs; (0, 0) for none."""
    if not events:
        return 0.0, 0.0
    union, (cur_start, cur_end, _) = 0.0, events[0]
    for start, end, _ in events[1:]:
        if start > cur_end:
            union += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    union += cur_end - cur_start
    return union, max(end for _, end, _ in events) - events[0][0]


def profile_steps(step, x, flags, n_steps, tag, route="", unit="step"):
    """Where a step's (a ``unit``'s) device time goes, under torch.profiler,
    and the device's idle share from the same trace: one less the union of
    the device intervals over their span. Summed from the trace's device
    events by name (``key_averages`` of a step of ~30,000 ops takes tens of
    seconds on the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(x, flags)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = device_events(prof)
    by_name = {}
    for start, end, name in events:
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + end - start, count + 1)
    rows = sorted(((total, name, count) for name, (total, count) in by_name.items()), reverse=True)
    busy = sum(r[0] for r in rows)
    ops = len(events) // n_steps
    union, span = device_union_and_span(events)
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
        moved = {k: [t.to(dev) for t in v] if isinstance(v, list) else v.to(dev) for k, v in draws.items()}
        loss = elbo_loss(model, x.to(dev), flags, **moved)
        loss.backward()
        # A parameter the loss does not reach (the other M-flow group) has
        # no gradient: zero, as jax.grad gives it.
        grads = {n: torch.zeros(p.shape) if p.grad is None else p.grad.detach().cpu()
                 for n, p in model.named_parameters()}
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
    """The parameters and every optimizer's state tensors, cloned."""
    state = [v for opt in trainer.optimizers for v in opt.tensors()]
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
    return trainers_captured_vs_eager(fresh_setup(argv)["trainer"], fresh_setup(argv)["trainer"], tag)


def trainers_captured_vs_eager(captured, eager, tag):
    """``captured_vs_eager`` on two given trainers of the same weights."""
    import torch

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


def _scalar_steps(run_dir, tag, dataset="miniboone"):
    """{step: value} of one scalar of a run dir's ``scalars.jsonl``."""
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == f"{dataset}/{tag}"}


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


def init_scale_coupler(b, c_in, c_out, hw, hidden, blocks, gen):
    """The port's ResNet coupler on the card with its weights as the model
    draws them, the head's ones and zeros perturbed, and a random input."""
    import torch
    from cmf_tpu_torch.nets import ResNet

    net = ResNet(c_in, [hidden] * blocks, c_out, generator=gen).cuda()
    with torch.no_grad():
        for p in (net.head_w, net.head_b):
            p.add_(0.05 * torch.randn(p.shape, generator=gen).cuda())
    x = torch.randn((b, c_in, hw, hw), generator=gen).cuda()
    return net, x


def bf16_weights_only(params):
    """The coupler's kernel parameters with only the 3x3 conv weights
    rounded to bf16: through the fp32 plain version, a bf16 variant that
    forgot to round the activations."""
    from cmf_tpu_torch.ops.coupler_stack import bf16_round

    def conv(c):
        return {**c, "w": bf16_round(c["w"])}

    return {**params, "conv_in": conv(params["conv_in"]),
            "blocks": [{k: conv(v) for k, v in bp.items()} for bp in params["blocks"]]}


def phase_coupler_kernel_bf16():
    """The coupler kernel's bf16=True instance (``coupler_stack_bf16_kernel``:
    wgmma on bf16 maps, weights by bulk copy) against its plain version
    (``coupler_stack_plain(..., bf16=True)``) at the main-path and edge
    shapes, with the weights as the model draws them (the head perturbed),
    within COUPLER_BF16_TOL and within COUPLER_BF16_GAP_SHARE of the plain
    bf16 version's gap to fp32; a version that rounds only the weights
    must land outside that limit, so the check tells bf16 from fp32 and
    from a half-rounded arithmetic. At every main shape its launch plan,
    time, device time, plain time, bound (the 2K hidden convs at the bf16
    tensor-core rate), the library yardstick (the port's ``ResNet`` module
    under the bf16 policy, through cuDNN bf16 convs) and the fp32
    instance's device time in the same call."""
    import torch
    from cmf_tpu_torch.nets import compute_dtype
    from cmf_tpu_torch.ops import coupler_stack as cs

    gen = torch.Generator().manual_seed(0)
    summary = None
    for shape in COUPLER_MAIN + COUPLER_EDGE:
        b, c_in, c_out, hw, hidden, blocks = shape
        net, x = init_scale_coupler(*shape, gen)
        plan = cs.plan_launch_bf16(b, c_in, hidden, hw, hw)
        tag = "main" if shape in COUPLER_MAIN else "edge"
        with torch.no_grad():
            params = net.kernel_params()
            got = cs.coupler_stack_cuda(x, params, bf16=True)
            ref = cs.coupler_stack_plain(x, params, bf16=True)
            fp32 = cs.coupler_stack_plain(x, params)
            weights_only = cs.coupler_stack_plain(x, bf16_weights_only(params))
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            abs_err = float((got - ref).abs().max())
            err = abs_err / scale
            gap = float((fp32 - ref).abs().max()) / scale
            w_err = float((weights_only - ref).abs().max()) / scale
            limit = min(COUPLER_BF16_TOL, COUPLER_BF16_GAP_SHARE * gap)
            print(f"[kernels] coupler_stack bf16 {tag} B={b} {c_in}->{c_out} {hw}x{hw} hidden {hidden} "
                  f"blocks {blocks}: max err / max |ref| {err:.3e} (tol {limit:.3e}: {COUPLER_BF16_GAP_SHARE:.3f} "
                  f"of the fp32 arithmetic's {gap:.3e}, at most {COUPLER_BF16_TOL:g}), abs {abs_err:.3e}; "
                  f"rounding only the weights {w_err:.3e} ({w_err / gap:.3f} of the gap); plan: cluster "
                  f"{plan.cluster} ({cs.max_active_clusters(plan, hw, hw, c_in)} active at once), band {plan.rows} "
                  f"rows, {plan.n} pixels a warpgroup, {plan.cm} channels a map, {plan.stages} ring "
                  f"stages, {plan.smem_bytes} B shared memory a CTA")
            assert err <= limit and bool(torch.isfinite(got).all()), \
                f"coupler kernel's bf16 variant disagrees with its plain version at {shape}"
            assert w_err > limit, f"at {shape} the bf16 check cannot tell a weights-only rounding from bf16"
            if tag == "edge":
                continue
            iters = 20 if b * hw * hw > 50 * 14 * 14 else 50
            ms = cuda_ms(lambda: cs.coupler_stack_cuda(x, params, bf16=True), iters=iters, warmup=3)
            device_ms = profiled_device_ms(lambda: cs.coupler_stack_cuda(x, params, bf16=True),
                                           "coupler_stack_bf16_kernel", iters=10)
            fp32_device_ms = profiled_device_ms(lambda: cs.coupler_stack_cuda(x, params),
                                                "coupler_stack_kernel", iters=10)
            pack_ms = cuda_ms(lambda: cs.pack_weights(params, c_in, hidden, c_out, x.device, bf16=True),
                              iters=iters, warmup=3)
            plain_ms = cuda_ms(lambda: cs.coupler_stack_plain(x, params, bf16=True), iters=5, warmup=1)
            with compute_dtype("bfloat16"):
                library_ms = cuda_ms(lambda: net(x), iters=iters, warmup=3)
                library_err = float((net(x) - ref).abs().max()) / float(ref.abs().max())
        n_weights = sum(p.numel() for p in net.parameters())
        n_bytes = 4 * (x.numel() + n_weights + got.numel())
        n_flops = cs.flops(b, c_in, hidden, c_out, blocks, hw, hw)
        n_tc = cs.tensor_core_flops(b, hidden, blocks, hw, hw)
        b_ms, b_by = bound_ms(n_bytes, n_flops - n_tc, n_bf16_flops=n_tc)
        dev_txt = "not measured" if device_ms is None else f"{device_ms:.6f} ms ({b_ms / device_ms:.3f} of the bound)"
        fp32_txt = "not measured" if fp32_device_ms is None else f"{fp32_device_ms:.6f} ms"
        print(f"[kernels] coupler_stack bf16 B={b} {c_in}->{c_out} {hw}x{hw}: {ms:.6f} ms per call back to back "
              f"(of which packing the weights {pack_ms:.6f} ms), kernel device time {dev_txt}, the fp32 "
              f"instance's device time {fp32_txt} in the same call, plain {plain_ms:.6f} ms, library (the ResNet "
              f"module under the bf16 policy, cuDNN bf16, max err / max |ref| {library_err:.3e}) {library_ms:.6f} ms; "
              f"bound {b_ms:.6f} ms ({b_by}: {n_tc:.6g} FLOP at 989 TFLOP/s + {n_flops - n_tc:.6g} at 67, "
              f"{n_bytes} B), share {b_ms / ms:.3f}")
        if summary is None:
            summary = {
                "name": "coupler_stack_bf16", "route": "cuda", "source": "cmf_tpu_torch/csrc/coupler_stack.cu",
                "kernel": "coupler_stack_bf16_kernel",
                "replaces": "cmf_tpu/ops/pallas/coupler_stack.py:124", "launches": None,
                "_launches_key": "COUPLER_BF16_LAUNCHES", "shape": list(shape), "max_abs_err": abs_err,
                "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "bound": "bf16 on the tensor cores",
                "library_ms": library_ms, "fp32_device_ms": fp32_device_ms,
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


def _group_tensors(optimizer):
    return optimizer.params + optimizer.tensors()


def mflow_steps(captured, eager, epochs, n, tag):
    """``n`` captured steps of each flag key (one a listed engine epoch)
    against as many eager steps of another trainer from the same weights,
    each captured step leaving the other group's parameters and optimizer
    state bit-equal. Returns {key: (flags, x)}."""
    import torch

    batches = list(captured.train_loader)
    out_c, out_e, keys = [], [], {}
    untouched = True
    for epoch in epochs:
        flags = captured.objective.for_epoch(epoch)
        other = captured.optimizers[1 - flags["optimizer_index"]]
        for i in range(n):
            x = batches[i % len(batches)]
            before = [t.clone() for t in _group_tensors(other)]
            out_c.append(torch.stack(captured.step(x, flags)))
            untouched &= all(torch.equal(a, b) for a, b in zip(before, _group_tensors(other)))
            out_e.append(torch.stack(eager.eager_step(x, flags)))
        keys[flags["optimizer_index"]] = (flags, batches[0])
    out_c, out_e = torch.stack(out_c), torch.stack(out_e)
    loss_rel = float(((out_c - out_e).abs() / out_e.abs()).max())
    state_rel = max_rel_diff(train_state(captured), train_state(eager))
    graphs = len(captured_steps(captured))
    print(f"[{tag}] {n} captured vs {n} eager steps of each of {len(epochs)} keys: max rel diff of the "
          f"losses and grad norms {loss_rel:.3e}, of the parameters and both optimizers' state "
          f"{state_rel:.3e} (tol {CAPTURED_TOL:g}); the other group bit-equal after every step "
          f"{untouched}; {graphs} graph(s)")
    assert captured.captured and graphs == len(epochs), f"{tag}: not one graph a key"
    assert untouched, f"{tag}: a step moved the other group's parameters or optimizer state"
    assert loss_rel <= CAPTURED_TOL and state_rel <= CAPTURED_TOL, f"{tag}: captured steps drift from eager"
    return keys


def option_trainers(overrides, baseline=False):
    """Two trainers (for the captured and the eager route) of miniboone at
    full width under OPTION_CONFIG and ``overrides``, through the port's
    experiment set-up, from the same weights."""
    from cmf_tpu_torch.config import expand_grid, get_config
    from cmf_tpu_torch.training import experiment

    config = expand_grid(get_config("miniboone", "non-square", use_baseline=baseline))[0]
    config = {**config, "model": "non-square", "dataset": "miniboone", **OPTION_CONFIG, **overrides}
    return [experiment.setup_experiment(config, write_to_disk=False)["trainer"] for _ in range(2)]


def update_card_vs_cpu(trainer, x, flags, tag):
    """The epoch's optimizer's update on the card against the same update
    on the CPU, from the same parameters, state and gradients. Returns the
    group's gradient norm."""
    import torch
    from cmf_tpu_torch.training.optim import GroupOptimizer

    opt = trainer.optimizers[flags["optimizer_index"]]
    before = [p.detach().cpu().clone() for p in opt.params]
    params = [p.clone().requires_grad_(True) for p in before]
    cpu = GroupOptimizer(params, opt.lr, opt.rule, opt.schedule_steps, opt.max_grad_norm, opt.weight_decay)
    for src, dst in zip(opt.tensors(), cpu.tensors()):
        dst.copy_(src.cpu())
    trainer.eager_step(x, flags)
    for p, q in zip(params, opt.params):
        p.grad = q.grad.detach().cpu()
    cpu.step()
    group_norm = float(torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in params])))
    after = [p.detach().cpu() for p in opt.params]
    param_err = max_rel_diff(after, [p.detach() for p in params])
    moved = max_rel_diff(after, before)
    state = cpu.tensors()[1:]
    state_err = max_rel_diff([t.cpu() for t in opt.tensors()[1:]], state) if state else 0.0
    clip = "" if opt.max_grad_norm is None else (
        f"; the group's gradient norm {group_norm:.6g} vs max {opt.max_grad_norm:.6g}: the clip "
        f"{'acts' if group_norm >= opt.max_grad_norm else 'is idle'}")
    print(f"[{tag}] one update on the card vs the CPU from the same state and gradients (count "
          f"{int(opt.count)}, {len(opt.params)} tensors): parameters moved {moved:.3e} of their largest, "
          f"max err {param_err:.3e} (tol {OPT_PARAM_TOL:g}); state max err {state_err:.3e} (tol {OPT_TOL:g}){clip}")
    assert int(opt.count) == int(cpu.count), f"{tag}: the counts differ"
    assert param_err <= OPT_PARAM_TOL and state_err <= OPT_TOL, f"{tag}: the update on the card disagrees with the CPU"
    return group_norm


def phase_mflow(smi, root):
    """The M-flow baseline on the card: miniboone --baseline's default run,
    its captured steps, a card step of each key against the CPU, its resume;
    mnist --baseline's steps and samples; sphere --baseline's evaluation
    through the forward kernel; the optimizer options."""
    import torch
    from cmf_tpu_torch.densities import ManifoldFlowHeadDensity, nonsquare
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.ops import coupler_stack as cs
    from cmf_tpu_torch.ops import gram_logdet as gl
    from cmf_tpu_torch.training import experiment
    from cmf_tpu_torch.training.checkpoint import make_checkpoint

    phase_t0 = time.perf_counter()
    streams = sys.stdout, sys.stderr
    try:
        # The main path: the counts are read right after it.
        gl.reset_launch_counts()
        nonsquare.reset_logdet_fallbacks()
        t0 = time.perf_counter()
        (setup,) = cli_main(MFLOW_ARGV + ["--logdir-root", root])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        _restore_streams(streams)
        fwd, bwd = gl.launch_counts()
    finally:
        _restore_streams(streams)
    trainer = setup["trainer"]
    run_dir = setup["writer"].logdir
    history = trainer.history
    counts = [int(o.count) for o in trainer.optimizers]
    sizes = [sum(p.numel() for p in o.params) for o in trainer.optimizers]
    valid = _scalar_steps(run_dir, "valid/loss")
    graphs = captured_steps(trainer)
    epochs = sorted({h[0] for h in history})
    print(f"[mflow] miniboone --baseline: {type(setup['density']).__name__}; {trainer.epoch} epochs, trained "
          f"{epochs}, {len(history)} steps in {seconds:.4f} s ({smi}); optimizers' counts {counts} over "
          f"{sizes} parameters; {len(graphs)} graph(s); Gram/log-det launches (fwd, bwd) {fwd}, {bwd} "
          f"(counted on the device, under replay); valid/loss (FID) at epochs {sorted(valid)}: "
          f"{', '.join(f'{v:.6g}' for _, v in sorted(valid.items()))}; losses {history[0][1]:.6g} -> "
          f"{history[-1][1]:.6g}")
    assert isinstance(setup["density"], ManifoldFlowHeadDensity), "--baseline did not build the M-flow head"
    assert all(math.isfinite(h[1]) for h in history), "non-finite loss in the M-flow run"
    assert epochs == [2, 3, 4, 5, 6], "the M-flow run did not skip epoch 1 alone"
    assert counts == [6, 4], "the two optimizers did not step on alternate epochs"
    assert trainer.captured and len(graphs) == 2, "the M-flow run did not train through one graph a key"
    assert (fwd, bwd) == (0, 0), "a Gram/log-det kernel launched in M-flow training"
    assert sorted(valid) == [4, 6] and all(math.isfinite(v) for v in valid.values()), \
        "valid/loss (FID) not at epochs 4 and 6"

    # Captured against eager, the other group untouched, no log-det.
    argv = MFLOW_ARGV + ["--nosave"]
    captured, eager = fresh_setup(argv)["trainer"], fresh_setup(argv)["trainer"]
    gl.reset_launch_counts()
    keys = mflow_steps(captured, eager, [2, 3], MFLOW_STEPS, "mflow")
    torch.cuda.synchronize()
    launches = gl.launch_counts()
    print(f"[mflow] Gram/log-det launches (fwd, bwd) over those {4 * MFLOW_STEPS} steps: {launches}")
    assert launches == (0, 0), "a Gram/log-det kernel launched in an M-flow step"
    adam_ms = {}
    for index, (flags, x) in sorted(keys.items()):
        name = ("reconstruction", "likelihood")[index]
        step_time(captured.step, x, flags, 20, "mflow", f"{name} key, captured: ")
        replay_ms = adam_ms[("m-flow", index)] = cuda_ms(lambda: captured.step(x, flags), iters=50, warmup=3)
        print(f"[mflow] {smi}: {name} key, captured: {replay_ms:.4f} ms per step back to back (CUDA events)")
        step_time(captured.eager_step, x, flags, 10, "mflow", f"{name} key, eager: ")
        profile_steps(captured.step, x, flags, 10, "mflow", f"{name} key, captured: ")
        profile_steps(captured.eager_step, x, flags, 5, "mflow", f"{name} key, eager: ")
        card_vs_cpu(fresh_setup(argv), x, flags, f"mflow {name}", STEP_LOSS_TOL, STEP_GRAD_TOL)

    # Resumed: both optimizers' states bit-equal to `latest', then on to epoch 8.
    resumed_dir = run_dir + "_resumed"
    shutil.copytree(run_dir, resumed_dir)
    with open(os.path.join(resumed_dir, "config.json")) as f:
        config = json.load(f)
    config["max_epochs"] = MFLOW_RESUME_EPOCHS
    with open(os.path.join(resumed_dir, "config.json"), "w") as f:
        json.dump(config, f)
    saved = torch.load(os.path.join(resumed_dir, "checkpoints", "latest.pt"), weights_only=True)
    try:
        gl.reset_launch_counts()
        setup_r = experiment.setup_experiment(config, resume_dir=resumed_dir)
        trainer_r = setup_r["trainer"]
        loaded = make_checkpoint(trainer_r)
        groups = sorted({k.split("/")[0] for k in saved["opt_states"]})
        same = all(torch.equal(loaded[s][k], saved[s][k]) for s in ("params", "model_state", "opt_states")
                   for k in saved[s])
        trainer_r.train()
        torch.cuda.synchronize()
    finally:
        _restore_streams(streams)
    history_r = trainer_r.history
    print(f"[mflow] resumed from `{trainer_r.restored_from}' after epoch {saved['epoch']}: {len(saved['opt_states'])} "
          f"optimizer state tensors of groups {groups} and every parameter bit-equal {same}; then epochs "
          f"{sorted({h[0] for h in history_r})}, counts {[int(o.count) for o in trainer_r.optimizers]}, "
          f"{len(captured_steps(trainer_r))} graph(s), Gram/log-det launches {gl.launch_counts()}")
    assert trainer_r.restored_from == "latest" and groups == ["0", "1"] and same, \
        "the resumed M-flow state differs from `latest'"
    assert [h[0] for h in history_r] == [7, 7, 8, 8] and len(captured_steps(trainer_r)) == 2
    assert [int(o.count) for o in trainer_r.optimizers] == [8, 6] and gl.launch_counts() == (0, 0)

    # mnist --baseline: eager steps (the dequantization noise), FID passes
    # through the coupler kernel, then samples.
    with _Recorded() as rec:
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        (mnist,) = cli_main(MFLOW_MNIST_ARGV)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    mt = mnist["trainer"]
    run_launches = cs.LAUNCHES
    valid, test = rec.steps("valid/loss"), rec.steps("test/fid")
    fid_passes = mt.timings["fid"][0]
    gen = torch.Generator(device=mnist["device"]).manual_seed(3)
    samples = mnist["density"].sample(MFLOW_SAMPLE_BATCH, generator=gen)
    torch.cuda.synchronize()
    sample_launches = cs.LAUNCHES - run_launches
    latent = mnist_head(mnist["density"]).latent_dimension
    noise = torch.randn((MFLOW_SAMPLE_BATCH, latent), generator=gen, device=mnist["device"])
    got = mnist["density"].fixed_sample(noise)
    with torch.no_grad():
        ref = mnist["density"]._fixed_sample(noise)
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    print(f"[mflow] mnist --baseline: {type(mnist_head(mnist['density'])).__name__}, route "
          f"{'captured' if mt.captured else 'eager'}, epochs {sorted({h[0] for h in mt.history})}, "
          f"{len(mt.history)} steps in {seconds:.4f} s ({smi}), counts {[int(o.count) for o in mt.optimizers]}; "
          f"valid/loss (FID) at {sorted(valid)}: {', '.join(f'{v:.6g}' for _, v in sorted(valid.items()))}; "
          f"test/fid at {sorted(test)}; {run_launches} coupler launches in {fid_passes} FID passes; "
          f"sample({MFLOW_SAMPLE_BATCH}) {tuple(samples.shape)} with {sample_launches} coupler launches; "
          f"kernel vs conv route max err / max |ref| {err:.3e} (tol {SAMPLE_TOL:g})")
    assert all(math.isfinite(h[1]) for h in mt.history) and [int(o.count) for o in mt.optimizers] == [6, 4]
    assert sorted({h[0] for h in mt.history}) == [2, 3, 4, 5, 6], "mnist --baseline trained other epochs"
    assert sorted(valid) == [4, 6] and sorted(test) == [1], "mnist --baseline validated on other epochs"
    assert all(math.isfinite(v) for v in list(valid.values()) + list(test.values())), "non-finite FID"
    per_pass = mnist["config"]["num_fid_samples"] // mnist["config"]["test_batch_size"] * MNIST_COUPLINGS
    assert run_launches == fid_passes * per_pass, "coupler launches != FID passes x chunks x couplings"
    assert sample_launches == MNIST_COUPLINGS, "sample(): coupler launches != couplings"
    assert err <= SAMPLE_TOL and bool(torch.isfinite(samples).all())

    # sphere --baseline: the forward kernel in evaluation alone.
    with _Recorded() as rec:
        gl.reset_launch_counts()
        (sphere,) = cli_main(MFLOW_SPHERE_ARGV)
        torch.cuda.synchronize()
        fwd, bwd = gl.launch_counts()
    st = sphere["trainer"]
    valid, test = rec.steps("valid/loss"), rec.steps("test/loss")
    evals = len(valid) * len(st.valid_loader) + len(test) * len(st.test_loader)
    print(f"[mflow] sphere --baseline: {len(st.history)} steps, counts {[int(o.count) for o in st.optimizers]}, "
          f"{len(captured_steps(st))} graph(s); valid/loss at {sorted(valid)}, test/loss at {sorted(test)}; "
          f"Gram/log-det launches (fwd, bwd) {fwd}, {bwd} ({evals} evaluation batches)")
    assert sorted(valid) == [2, 4] and sorted(test) == [1], "sphere --baseline evaluated on other epochs"
    assert all(math.isfinite(v) for v in list(valid.values()) + list(test.values()))
    assert fwd == evals and bwd == 0, "Gram/log-det launches != evaluation batches (fwd), 0 (bwd)"
    assert len(captured_steps(st)) == 2

    # The optimizer options, each alone on CMF and all at once under M-flow.
    probe, _ = option_trainers({})
    x0 = next(iter(probe.train_loader))
    flags0 = probe.objective.for_epoch(1)
    first_norm = float(probe.eager_step(x0, flags0)[1])
    clip = 0.25 * first_norm
    adam_ms[("cmf", 0)] = cuda_ms(lambda: probe.step(x0, flags0), iters=20, warmup=3)
    options = [("adamax", {"opt": "adamax"}, False), ("sgd", {"opt": "sgd"}, False),
               ("cosine", {"lr_schedule": "cosine"}, False), ("clip", {"max_grad_norm": clip}, False),
               ("weight-decay", {"weight_decay": 0.1}, False),
               ("m-flow-all", {"opt": "adamax", "lr_schedule": "cosine", "max_grad_norm": clip,
                               "weight_decay": 0.1}, True)]
    print(f"[mflow] options: the first step's gradient norm {first_norm:.6g}, so max_grad_norm {clip:.6g}")
    for name, overrides, baseline in options:
        tag = f"mflow {name}"
        captured, eager = option_trainers(overrides, baseline)
        epochs = [1, 2] if baseline else [1]
        if baseline:
            keys = mflow_steps(captured, eager, epochs, OPTION_STEPS, tag)
        else:
            flags = captured.objective.for_epoch(1)
            batches = list(captured.train_loader)
            out_c = torch.stack([torch.stack(captured.step(batches[i % len(batches)], flags))
                                 for i in range(OPTION_STEPS)])
            out_e = torch.stack([torch.stack(eager.eager_step(batches[i % len(batches)], flags))
                                 for i in range(OPTION_STEPS)])
            loss_rel = float(((out_c - out_e).abs() / out_e.abs()).max())
            state_rel = max_rel_diff(train_state(captured), train_state(eager))
            print(f"[{tag}] {OPTION_STEPS} captured vs eager steps: max rel diff of the losses and grad "
                  f"norms {loss_rel:.3e}, of the parameters and optimizer state {state_rel:.3e} "
                  f"(tol {CAPTURED_TOL:g}); {len(captured_steps(captured))} graph(s)")
            assert captured.captured and len(captured_steps(captured)) == 1, f"{tag}: no graph"
            assert loss_rel <= CAPTURED_TOL and state_rel <= CAPTURED_TOL, f"{tag}: captured drifts from eager"
            keys = {0: (flags, batches[0])}
        for index, opt in enumerate(captured.optimizers):
            rate = float(opt.rate(opt.count))
            host = opt.host_rate(int(opt.count))
            rel = abs(rate - host) / opt.lr
            print(f"[{tag}] optimizer {index}: count {int(opt.count)}, rate read from the device {rate:.9g} vs "
                  f"the formula {host:.9g}, diff over lr {rel:.3e}" + (f" (lr {opt.lr:g}, T {opt.schedule_steps})"
                                                                      if opt.schedule_steps else ""))
            assert rel <= 1e-6, f"{tag}: the rate on the device disagrees with the formula"
            if opt.schedule_steps:
                assert rate < opt.lr, f"{tag}: the cosine rate did not move"
        for index, (flags, x) in sorted(keys.items()):
            ms = cuda_ms(lambda: captured.step(x, flags), iters=20, warmup=2)
            adam = adam_ms[("m-flow" if baseline else "cmf", index)]
            print(f"[{tag}] {smi}: key {index}, captured: {ms:.4f} ms per step back to back (CUDA events); "
                  f"with Adam alone {adam:.4f} ms")
            norm = update_card_vs_cpu(eager, x, flags, tag)
            if name == "clip":
                assert norm >= clip, "the clip did not act"
    print(f"[mflow] {smi}: the phase took {time.perf_counter() - phase_t0:.2f} s")


def square_cif_argv(model_args, cap, epochs):
    return model_args + ["--dataset", "miniboone", "--synthetic-data", "--config", f"max_dataset_size={cap}",
                         "--config", f"max_epochs={epochs}", "--config", "seed=0"]


def nosave_setup(model_args, dataset, cap, epochs):
    """The setup the CLI makes of ``model_args`` (``--model``, ``--baseline``
    and ``--config`` pairs) on ``dataset`` under ``--nosave``, every split
    capped at ``cap`` rows, before any step (``fresh_setup``'s
    ``max_epochs=0`` would give the cosine schedule no steps)."""
    from cmf_tpu_torch.config import expand_grid, get_config
    from cmf_tpu_torch.main import parse_config_arg
    from cmf_tpu_torch.training import experiment

    model = model_args[model_args.index("--model") + 1]
    pairs = [model_args[i + 1] for i, arg in enumerate(model_args) if arg == "--config"]
    config = expand_grid(get_config(dataset, model, use_baseline="--baseline" in model_args))[0]
    config = {**config, "model": model, "dataset": dataset, "synthetic_data": True, "nosave": True,
              **dict(parse_config_arg(kv) for kv in pairs), "max_dataset_size": cap, "max_epochs": epochs,
              "seed": 0}
    return experiment.setup_experiment(config, write_to_disk=False)


SQUARE_METRICS = ("elbo", "log-prob", "bpd", "elbo-gap", "fid")


def square_cif_resume_and_test(tag, run_dir, epochs, steps, phase="square-cif", metrics=SQUARE_METRICS,
                               finite=True):
    """A copy of the run dir trained one more epoch (its restored state
    bit-equal to ``latest``), then ``--test --resume`` on the run dir, whose
    ``metrics.json`` must hold ``metrics``, finite unless ``finite`` is
    off."""
    import torch
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.training import experiment
    from cmf_tpu_torch.training.checkpoint import make_checkpoint

    resumed_dir = run_dir + "_resumed"
    shutil.copytree(run_dir, resumed_dir)
    with open(os.path.join(resumed_dir, "config.json")) as f:
        config = json.load(f)
    config["max_epochs"] = epochs + 1
    with open(os.path.join(resumed_dir, "config.json"), "w") as f:
        json.dump(config, f)
    saved = torch.load(os.path.join(resumed_dir, "checkpoints", "latest.pt"), weights_only=True)
    setup_r = experiment.setup_experiment(config, resume_dir=resumed_dir)
    trainer_r = setup_r["trainer"]
    loaded = make_checkpoint(trainer_r)
    tensors = [(s, k) for s in ("params", "model_state", "opt_states") for k in saved[s]]
    same = all(torch.equal(loaded[s][k], saved[s][k]) for s, k in tensors) and \
        torch.equal(loaded["rng"], saved["rng"])
    trainer_r.train()
    torch.cuda.synchronize()
    history_r = trainer_r.history
    print(f"[{phase}] {tag}: resumed from `{trainer_r.restored_from}' after epoch {saved['epoch']}: "
          f"{len(tensors)} tensors and the generator state bit-equal {same}; then epochs "
          f"{sorted({h[0] for h in history_r})}, {len(history_r)} steps, {len(captured_steps(trainer_r))} graph(s)")
    assert trainer_r.restored_from == "latest" and same, f"{tag}: the resumed state differs from `latest'"
    assert [h[0] for h in history_r] == [epochs + 1] * steps, f"{tag}: the resumed run trained other epochs"
    assert all(math.isfinite(h[1]) for h in history_r), f"{tag}: non-finite loss in the resumed run"
    assert len(captured_steps(trainer_r)) == (1 if trainer_r.captured else 0)

    t0 = time.perf_counter()
    (tested,) = cli_main(["--test", "--resume", run_dir])
    test_s = time.perf_counter() - t0
    with open(os.path.join(run_dir, "metrics.json")) as f:
        results = json.load(f)
    shown = {k: (round(v, 6) if isinstance(v, float) else v) for k, v in results.items()}
    print(f"[{phase}] {tag}: --test --resume from `{tested['trainer'].restored_from}' "
          f"({tested['config']['num_fid_samples']:,} FID samples): metrics.json {shown}; {test_s:.4f} s")
    numbers = [v for k, v in results.items() if k != "feature_extractor"]
    assert set(metrics) <= set(results), f"{tag}: metrics.json lacks a metric"
    assert all(math.isfinite(v) for v in numbers) or not finite, f"{tag}: non-finite test metric"


def square_cif_run_checks(smi, label, model_args, epochs, setup, seconds, phase="square-cif"):
    """A tabular square or CIF run of the CLI into a run dir: its losses,
    steps, route, validations, test pass and FID passes."""
    from cmf_tpu_torch.densities import ELBODensity

    trainer, density, config = setup["trainer"], setup["density"], setup["config"]
    run_dir = setup["writer"].logdir
    history = trainer.history
    cif_layers = sum(isinstance(m, ELBODensity) for m in density.modules())
    steps = len(trainer.train_loader)
    valid = _scalar_steps(run_dir, "valid/loss")
    tests = {k: _scalar_steps(run_dir, f"test/{k}") for k in ("log-prob", "fid")}
    timings = trainer.timings
    train_s = timings["train"][1]
    fid_n, fid_s = timings.get("fid", (0, 0.0))
    print(f"[{phase}] {label}: {type(density).__name__} root, {cif_layers} CIF layers (u = "
          f"{config['num_u_channels'] if cif_layers else 0}), {sum(p.numel() for p in density.parameters()):,} "
          f"parameters; batch {config['train_batch_size']}, {config['opt']} lr {config['lr']:g}, schedule "
          f"{config['lr_schedule']}, max_grad_norm {config['max_grad_norm']}; {len(history)} steps over "
          f"epochs {sorted({h[0] for h in history})}, losses {history[0][1]:.6g} -> {history[-1][1]:.6g}; "
          f"route {'captured' if trainer.captured else 'eager'}, {len(captured_steps(trainer))} graph(s); "
          f"valid/loss (FID) at {sorted(valid)}: {', '.join(f'{v:.6g}' for v in valid.values())}; "
          f"test/log-prob {tests['log-prob']}, test/fid {tests['fid']}")
    print(f"[{phase}] {label} {smi}: the run took {seconds:.4f} s; {fid_n} FID pass(es) of "
          f"{config['num_fid_samples']:,} samples, {fid_s / max(fid_n, 1) * 1e3:.4f} ms each; training epochs "
          f"{train_s:.4f} s, so {1 - train_s / seconds:.4f} of the run outside training steps (host clock)")
    assert all(math.isfinite(h[1]) for h in history), f"{label}: non-finite training loss"
    assert len(history) == epochs * steps and steps >= 3, f"{label}: steps != epochs x batches"
    assert (cif_layers > 0) == ("--baseline" not in model_args), f"{label}: the wrong family was built"
    assert trainer.captured == (density.step_capturable and setup["device"].type == "cuda"), \
        f"{label}: the route does not follow the rule"
    assert len(captured_steps(trainer)) == (1 if trainer.captured else 0), f"{label}: not one graph"
    assert sorted(valid) == (list(range(1, epochs + 1)) if config["early_stopping"] else []), \
        f"{label}: validated on other epochs"
    assert sorted(tests["fid"]) == sorted(tests["log-prob"]) == [1], f"{label}: no test pass at epoch 1"
    assert all(math.isfinite(v) for d in [valid] + list(tests.values()) for v in d.values()), \
        f"{label}: a non-finite validation or test number"
    assert fid_n == len(valid) + 1, f"{label}: FID passes != validations + tests"


def phase_square_cif(smi, root):
    """The tabular square NSF and CIFs on the card: the four commands at
    their published widths into run dirs (validation by FID where early
    stopping is on, a test pass, checkpoints), each resumed one epoch and
    tested from its run dir; no Gram/log-det or coupler launch; then for
    each, captured steps against eager ones (the CIF's u drawn inside the
    graph from the trainer's generator), ms a step and the idle share of
    each route, and a card step against the CPU."""
    import torch
    from cmf_tpu_torch.densities import elbo
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.ops import coupler_stack as cs
    from cmf_tpu_torch.ops import gram_logdet as gl

    phase_t0 = time.perf_counter()
    streams = sys.stdout, sys.stderr
    print(f"[square-cif] CUDA graphs hold a draw of the caller's generator: {elbo.GRAPH_SAFE_GENERATORS} "
          f"(CUDAGraph.register_generator_state; torch {torch.__version__})")
    runs = []
    try:
        # The main path: the counts are read right after it.
        gl.reset_launch_counts()
        cs.reset_launch_counts()
        for tag, model_args, cap, epochs, jobs in SQUARE_CIF_RUNS:
            t0 = time.perf_counter()
            setups = cli_main(square_cif_argv(model_args, cap, epochs) + ["--logdir-root", root])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            _restore_streams(streams)
            assert len(setups) == jobs, f"{tag}: {len(setups)} jobs, expected {jobs}"
            for job, setup in enumerate(setups):
                label = f"{tag} (job {job}, q_nets {setup['config']['q_nets']})" if jobs > 1 else tag
                runs.append((tag, label, job, model_args, cap, epochs, setup, seconds / jobs))
        torch.cuda.synchronize()
        launches = gl.launch_counts(), cs.LAUNCHES

        for tag, label, job, model_args, cap, epochs, setup, seconds in runs:
            square_cif_run_checks(smi, label, model_args, epochs, setup, seconds)
        print(f"[square-cif] Gram/log-det launches (fwd, bwd) {launches[0]} and coupler launches {launches[1]} "
              f"over the {len(runs)} runs")
        assert launches == ((0, 0), 0), "a kernel launched on the tabular square and CIF runs"

        for tag, _, job, _, _, epochs, setup, _ in runs:
            if job == 0:
                square_cif_resume_and_test(tag, setup["writer"].logdir, epochs, len(setup["trainer"].train_loader))
                _restore_streams(streams)
    finally:
        _restore_streams(streams)

    # Each model's step: captured against eager, times, idle shares, the CPU.
    for tag, model_args, cap, epochs, jobs in SQUARE_CIF_RUNS:
        probe = nosave_setup(model_args, "miniboone", cap, epochs)
        density = probe["density"]
        second = nosave_setup(model_args, "miniboone", cap, epochs)
        if density.step_capturable:
            captured, eager, flags, batches = trainers_captured_vs_eager(
                probe["trainer"], second["trainer"], f"square-cif {tag}")
            x = batches[0]
            replay_ms = cuda_ms(lambda: captured.step(x, flags), iters=20, warmup=2)
            print(f"[square-cif] {smi}: {tag}, captured: {replay_ms:.4f} ms per step back to back (CUDA events), "
                  f"{x.shape[0] / replay_ms * 1e3:.1f} samples/s")
            profile_steps(captured.step, x, flags, 3, "square-cif", f"{tag}, captured: ")
        else:
            # The rule of ``ELBODensity.step_capturable``: no graph holds the
            # caller's generator in this PyTorch.
            assert not elbo.GRAPH_SAFE_GENERATORS, f"{tag}: the step is not capturable"
            eager = second["trainer"]
            flags, x = eager.objective.for_epoch(1), next(iter(eager.train_loader))
            print(f"[square-cif] {tag}: the step is eager by ELBODensity.step_capturable's rule")
        step_time(eager.eager_step, x, flags, 5, "square-cif", f"{tag}, eager: ")
        gen = torch.Generator(device=x.device).manual_seed(7)
        draws = u_draws(density, x, gen, probe["config"]["num_u_channels"])
        card_vs_cpu(second, x, flags, f"square-cif {tag}", STEP_LOSS_TOL, STEP_GRAD_TOL, **draws)
        # A FID chunk's samples: the inverse's sequential passes.
        if tag in SQUARE_CIF_SAMPLE_PROFILED:
            chunk = probe["config"]["test_batch_size"]
            profile_steps(lambda *_: density.sample(chunk, generator=gen), None, None, 1, "square-cif",
                          f"{tag}, sample({chunk}): ", unit="call")
    # The spline's knots sum K = 4 bins: torch.cumsum's scan against the
    # product with a triangle of ones that the port uses, at a sample's shape.
    sizes = torch.rand(5000, 43, 4, device="cuda")
    triangle = torch.ones(4, 4, device="cuda").triu()
    scan_ms = cuda_ms(lambda: torch.cumsum(sizes, dim=-1), iters=20, warmup=2)
    product_ms = cuda_ms(lambda: sizes @ triangle, iters=20, warmup=2)
    err = float((torch.cumsum(sizes, dim=-1) - sizes @ triangle).abs().max())
    print(f"[square-cif] {smi}: the knots' running sum over (5000, 43, 4): torch.cumsum {scan_ms:.4f} ms, "
          f"the triangular product {product_ms:.4f} ms (CUDA events), max diff {err:.3e}")
    print(f"[square-cif] {smi}: the phase took {time.perf_counter() - phase_t0:.2f} s")


def image_square_argv(model_args, rows, epochs):
    rate = ["--config", f"lr={GLOW_SMOKE_LR}"] if "glow" in model_args else []
    return model_args + rate + ["--synthetic-data", "--nosave", "--config", f"max_dataset_size={rows}",
                                "--config", f"max_epochs={epochs}", "--config",
                                f"num_fid_samples={IMAGE_SQUARE_FID_SAMPLES}", "--config", "seed=0"]


def glow_published_rate(tag, model_args):
    """One epoch of 2 steps at glow's published rate: the first step's loss
    finite, the second's not; the freeze keeps the first step's state (the
    optimizer's count stays 1, every parameter finite) and the epoch
    raises, as cmf_tpu's trainer does."""
    import torch
    from cmf_tpu_torch.config import expand_grid, get_config
    from cmf_tpu_torch.training import experiment

    dataset = model_args[model_args.index("--dataset") + 1]
    config = expand_grid(get_config(dataset, "glow", use_baseline="--baseline" in model_args))[0]
    config = {**config, "model": "glow", "dataset": dataset, "synthetic_data": True, "nosave": True,
              "max_dataset_size": 2 * config["train_batch_size"], "max_epochs": 1, "seed": 0}
    t0 = time.perf_counter()
    trainer = experiment.setup_experiment(config, write_to_disk=False)["trainer"]
    try:
        trainer.train()
        raised = None
    except FloatingPointError as e:
        raised = e
    losses = [h[1] for h in trainer.history]
    count = int(trainer.optimizers[0].count)
    finite = all(bool(torch.isfinite(p).all()) for p in trainer.params)
    print(f"[image-square] {tag} at the published rate ({config['opt']} {config['lr']:g}): losses {losses}; "
          f"raised {raised!r}; optimizer count {count}, parameters finite {finite}; {time.perf_counter() - t0:.2f} s")
    assert math.isfinite(losses[0]) and not math.isfinite(losses[1]), f"{tag}: the published rate's steps"
    assert raised is not None and count == 1 and finite, f"{tag}: the freeze did not keep the first step"


def image_square_draws(density, x, gen, num_u):
    """A step's draws for the card and the CPU alike: the dequantization
    noise, and each CIF layer's ε of u (outermost first; num_u channels at
    its input's height and width)."""
    import torch
    from cmf_tpu_torch.densities import ELBODensity

    draws = {"dequantization_noise": torch.rand(x.shape, generator=gen, device=x.device)}
    layers = [m for m in density.modules() if isinstance(m, ELBODensity)]
    if layers:
        draws["u_noise"] = [torch.randn(x.shape[0], num_u, *m.bijection.x_shape[1:], generator=gen, device=x.device)
                            for m in layers]
    return draws


def image_square_card_vs_cpu(setup, x, flags, tag, draws):
    """One step of batch ``x`` on the card and on the CPU, each in fp32 and
    in fp64, from the same weights and draws: in fp64 the loss and every
    gradient card against CPU at STEP_LOSS_TOL and STEP_GRAD_TOL; in fp32
    the loss card against CPU at STEP_LOSS_TOL, each side's gradients
    within FP32_BN_GRAD_TOL of the fp64 step, and every running statistic
    after the step card against CPU within BN_STATE_TOL."""
    import torch
    from cmf_tpu_torch.models import get_density
    from cmf_tpu_torch.training import elbo_loss

    state = {k: v.detach().cpu().clone() for k, v in setup["density"].state_dict().items()}
    steps = {}
    cpu = torch.device("cpu")
    for label, dev, dtype in (("card32", x.device, torch.float32), ("cpu32", cpu, torch.float32),
                              ("cpu64", cpu, torch.float64), ("card64", x.device, torch.float64)):
        if label == "card32":
            model = setup["density"]
        else:
            model = get_density(setup["schema"], x_shape=tuple(x.shape[1:]), device="cpu")
            model.load_state_dict(state)
            model.to(dev, dtype)
        model.zero_grad(set_to_none=True)
        moved = {k: [t.to(dev, dtype) for t in v] if isinstance(v, list) else v.to(dev, dtype)
                 for k, v in draws.items()}
        t0 = time.perf_counter()
        loss = elbo_loss(model, x.to(dev, dtype), flags, **moved)
        loss.backward()
        grads = {n: torch.zeros(p.shape, dtype=torch.float64) if p.grad is None else p.grad.detach().cpu().double()
                 for n, p in model.named_parameters()}
        stats = {n: b.detach().cpu().double() for n, b in model.named_buffers() if n.endswith((".mean", ".var"))}
        steps[label] = (loss.item(), grads, stats, time.perf_counter() - t0)
    card32, cpu32, card64, cpu64 = (steps[k] for k in ("card32", "cpu32", "card64", "cpu64"))
    scale = max(float(g.abs().max()) for g in cpu64[1].values())

    def grad_err(step, ref):
        worst = max(ref[1], key=lambda n: float((step[1][n] - ref[1][n]).abs().max()))
        return float((step[1][worst] - ref[1][worst]).abs().max()) / scale, worst

    def loss_err(step, ref):
        return abs(step[0] - ref[0]) / max(1.0, abs(ref[0]))

    (err64, worst64), (err_card, worst_card), (err_cpu, worst_cpu) = (
        grad_err(card64, cpu64), grad_err(card32, cpu64), grad_err(cpu32, cpu64))
    loss64, loss32 = loss_err(card64, cpu64), loss_err(card32, cpu32)
    state_err = max_rel_diff([card32[2][n] for n in cpu32[2]], [cpu32[2][n] for n in cpu32[2]])
    print(f"[{tag}] card vs CPU step (batch {x.shape[0]}; fp32 {card32[3]:.2f} s card, {cpu32[3]:.2f} s CPU; fp64 "
          f"{card64[3]:.2f} s card, {cpu64[3]:.2f} s CPU): fp64 loss rel err {loss64:.3e}, max grad err / max |grad| "
          f"{err64:.3e} (worst `{worst64}'; tols {STEP_LOSS_TOL:g}, {STEP_GRAD_TOL:g}); fp32 loss {card32[0]:.8g} vs "
          f"{cpu32[0]:.8g}, rel err {loss32:.3e}; fp32 gradients from the fp64 step's: card {err_card:.3e} (worst "
          f"`{worst_card}'), CPU {err_cpu:.3e} (worst `{worst_cpu}'), tol {FP32_BN_GRAD_TOL:g}; running statistics "
          f"card vs CPU {state_err:.3e} (tol {BN_STATE_TOL:g}) over {len(cpu32[2])} tensors")
    assert loss64 <= STEP_LOSS_TOL and err64 <= STEP_GRAD_TOL, f"{tag}: the card's fp64 step disagrees with the CPU's"
    assert loss32 <= STEP_LOSS_TOL, f"{tag}: the card's fp32 loss disagrees with the CPU's"
    assert max(err_card, err_cpu) <= FP32_BN_GRAD_TOL, f"{tag}: an fp32 step's gradients are far from the fp64 step"
    assert cpu32[2] and state_err <= BN_STATE_TOL, f"{tag}: running statistics on the card disagree with the CPU"


def image_square_restore(tag, setup, run_dir):
    """The trainer saved into ``run_dir``, restored into a fresh setup
    (every tensor bit-equal, the running statistics among them), trained a
    second epoch, then tested as ``--test`` tests."""
    import torch
    from cmf_tpu_torch.training import experiment
    from cmf_tpu_torch.training.checkpoint import make_checkpoint
    from cmf_tpu_torch.training.writer import Writer

    trainer = setup["trainer"]
    trainer.writer = Writer(run_dir, make_subdir=False, tee=False)
    trainer._save_checkpoint("latest")
    save_ms = trainer.timings["checkpoint"][1] * 1e3
    saved = torch.load(os.path.join(run_dir, "checkpoints", "latest.pt"), weights_only=True)
    setup_r = experiment.setup_experiment({**setup["config"], "max_epochs": 2}, resume_dir=run_dir,
                                          write_to_disk=False)
    trainer_r = setup_r["trainer"]
    loaded = make_checkpoint(trainer_r)
    tensors = [(s, k) for s in ("params", "model_state", "opt_states") for k in saved[s]]
    stats = [k for k in saved["model_state"] if k.endswith((".mean", ".var"))]
    same = all(torch.equal(loaded[s][k], saved[s][k]) for s, k in tensors)
    print(f"[image-square] {tag}: saved in {save_ms:.4f} ms; restored from `{trainer_r.restored_from}' after "
          f"epoch {saved['epoch']}: {len(tensors)} tensors ({len(stats)} running statistics) bit-equal {same}")
    assert trainer_r.restored_from == "latest" and same and stats, f"{tag}: the restored state differs"
    trainer_r.train()
    history_r = trainer_r.history
    assert [h[0] for h in history_r] == [2] * len(trainer_r.train_loader), f"{tag}: the resumed run"
    assert all(math.isfinite(h[1]) for h in history_r), f"{tag}: non-finite loss in the resumed run"
    t0 = time.perf_counter()
    results = trainer_r.test()
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    shown = {k: (round(v, 6) if isinstance(v, float) else v) for k, v in results.items()}
    print(f"[image-square] {tag}: epoch 2 trained ({len(history_r)} steps, last loss {history_r[-1][1]:.6g}); "
          f"Trainer.test() ({setup_r['config']['num_fid_samples']:,} FID samples): "
          f"{shown}; {test_s:.4f} s")
    assert {"elbo", "log-prob", "bpd", "fid"} <= set(results), f"{tag}: the test lacks a metric"
    assert all(math.isfinite(v) for k, v in results.items() if k != "feature_extractor"), f"{tag}: non-finite test"


def phase_image_square(smi, root):
    """The image square flows and image CIFs on the card: the four
    published commands at their widths and depths under --nosave, no
    Gram/log-det or coupler launch over them; each saved and restored
    bit-equal, trained on and tested; its step, FID pass and sample timed;
    a card step against the CPU with the running statistics."""
    import contextlib
    import io

    import torch
    from cmf_tpu_torch.config import expand_grid, get_config
    from cmf_tpu_torch.densities import ELBODensity
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.nets import BatchNorm2d, GlowCNN
    from cmf_tpu_torch.bijections import LUInvertible1x1ConvBijection
    from cmf_tpu_torch.ops import coupler_stack as cs
    from cmf_tpu_torch.ops import gram_logdet as gl
    from cmf_tpu_torch.training import experiment

    phase_t0 = time.perf_counter()
    # A run dir of an image model draws the image grid: refused by name
    # before any work where matplotlib does not import.
    tag0, args0, _, _ = IMAGE_SQUARE_RUNS[0]
    config0 = expand_grid(get_config("mnist", "realnvp", use_baseline=True))[0]
    config0 = {**config0, "model": "realnvp", "dataset": "mnist"}
    try:
        experiment.check_supported(config0)
        print("[image-square] matplotlib imports here: a run dir would draw the image grid")
    except ImportError as refusal:
        print(f"[image-square] {tag0} into a run dir is refused before any work: {refusal}")
        assert "ImageDensityVisualizer" in str(refusal)

    for tag, model_args, _, count in IMAGE_SQUARE_RUNS:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_main(model_args + ["--synthetic-data", "--print-num-params"])
        print(f"[image-square] {tag} --print-num-params: {out.getvalue().strip()} (published {count:,})")
        assert out.getvalue() == f"Number of parameters: {count}\n", f"{tag}: parameter count"

    print(f"[image-square] the refusal and the parameter counts took {time.perf_counter() - phase_t0:.2f} s")
    runs = []
    # The main path: the counts are read right after it.
    with _Recorded() as rec:
        gl.reset_launch_counts()
        cs.reset_launch_counts()
        for tag, model_args, rows, _ in IMAGE_SQUARE_RUNS:
            start = len(rec.rows)
            t0 = time.perf_counter()
            (setup,) = cli_main(image_square_argv(model_args, rows, 1))
            torch.cuda.synchronize()
            runs.append((tag, setup, time.perf_counter() - t0, rec.rows[start:]))
            if "glow" in model_args:
                glow_published_rate(tag, model_args)
        torch.cuda.synchronize()
        launches = gl.launch_counts(), cs.LAUNCHES
    print(f"[image-square] Gram/log-det launches (fwd, bwd) {launches[0]} and coupler launches {launches[1]} "
          f"over the {len(runs)} runs")
    assert launches == ((0, 0), 0), "a kernel launched on the image square and CIF runs"

    for i, (tag, setup, seconds, rows) in enumerate(runs):
        trainer, density, config = setup["trainer"], setup["density"], setup["config"]
        history = trainer.history
        scalars = {}
        for name, value, step in rows:
            scalars.setdefault(name, {})[step] = value
        valid, test_fid = scalars.get("valid/loss", {}), scalars.get("test/fid", {})
        norms = [m for m in density.modules() if isinstance(m, BatchNorm2d)]
        moving = [m for m in norms if m.updates_running]
        moved = sum(1 for m in moving if not torch.equal(m.var, torch.ones_like(m.var)))
        kept = all(torch.equal(m.var, torch.ones_like(m.var)) and not m.mean.any()
                   for m in norms if not m.updates_running)
        cif_layers = sum(isinstance(m, ELBODensity) for m in density.modules())
        fid_n, fid_s = trainer.timings["fid"]
        train_s = trainer.timings["train"][1]
        print(f"[image-square] {tag}: {cif_layers} CIF layers, {len(norms)} batch-norm layers ({len(moving)} "
              f"moving their statistics, {moved} moved; p's and q's kept {kept}), "
              f"{sum(isinstance(m, GlowCNN) for m in density.modules())} GlowCNNs, "
              f"{sum(isinstance(m, LUInvertible1x1ConvBijection) for m in density.modules())} LU invconvs; "
              f"batch {config['train_batch_size']}, {config['opt']} lr {config['lr']:g}, weight decay "
              f"{config['weight_decay']:g}; {len(history)} steps, losses {history[0][1]:.6g} -> "
              f"{history[-1][1]:.6g}; route {'captured' if trainer.captured else 'eager'}; valid/loss (FID) at "
              f"{sorted(valid)}: {list(valid.values())}; test/fid at {sorted(test_fid)}: {list(test_fid.values())}")
        print(f"[image-square] {tag} {smi}: the run took {seconds:.4f} s; {fid_n} FID pass(es) of "
              f"{config['num_fid_samples']:,} samples, {fid_s / fid_n * 1e3:.4f} ms each; training epochs "
              f"{train_s:.4f} s, so {1 - train_s / seconds:.4f} of the run outside training steps (host clock)")
        assert all(math.isfinite(h[1]) for h in history), f"{tag}: non-finite training loss"
        assert len(history) == len(trainer.train_loader) >= 3, f"{tag}: not one epoch of 3 steps"
        assert not trainer.captured and not density.step_capturable, f"{tag}: the dequantized step is eager"
        assert moving and moved == len(moving) and kept, f"{tag}: the running statistics"
        assert sorted(valid) == ([1] if config["early_stopping"] else []), f"{tag}: validated on other epochs"
        assert sorted(test_fid) == [1], f"{tag}: no test FID at epoch 1"
        assert all(math.isfinite(v) for v in list(valid.values()) + list(test_fid.values())), f"{tag}: FID"
        assert fid_n == len(valid) + 1, f"{tag}: FID passes != validations + tests"

        # Times of this model's step and sample.
        t_timing = time.perf_counter()
        flags, x = trainer.objective.for_epoch(1), next(iter(trainer.train_loader))
        step_time(trainer.eager_step, x, flags, 2, "image-square", f"{tag}, eager: ")
        events_ms = cuda_ms(lambda: trainer.eager_step(x, flags), iters=2, warmup=0)
        print(f"[image-square] {smi}: {tag}, eager: {events_ms:.4f} ms per step back to back (CUDA events), "
              f"{x.shape[0] / events_ms * 1e3:.1f} samples/s")
        profile_steps(trainer.eager_step, x, flags, 1, "image-square", f"{tag}, eager: ")
        gen = torch.Generator(device=x.device).manual_seed(7)
        chunk = config["test_batch_size"]
        profile_steps(lambda *_: density.sample(chunk, generator=gen), None, None, 1, "image-square",
                      f"{tag}, sample({chunk}): ", unit="call")

        t_restore = time.perf_counter()
        image_square_restore(tag, setup, os.path.join(root, f"image_square_{i}"))
        t_cpu = time.perf_counter()

        x8 = x[:IMAGE_SQUARE_STEP_BATCH]
        image_square_card_vs_cpu(setup, x8, flags, f"image-square {tag}",
                                 image_square_draws(density, x8, gen, config["num_u_channels"]))
        print(f"[image-square] {tag}: the checks after the run took {t_restore - t_timing:.2f} s (times and "
              f"profiles), {t_cpu - t_restore:.2f} s (save, restore, an epoch, the test), "
              f"{time.perf_counter() - t_cpu:.2f} s (card against CPU)")
    print(f"[image-square] {smi}: the phase took {time.perf_counter() - phase_t0:.2f} s")


def square_2d_argv(model_args):
    return model_args + ["--dataset", SQUARE_2D_DATASET, "--nosave", "--config", f"max_dataset_size={SQUARE_2D_ROWS}",
                         "--config", f"max_epochs={SQUARE_2D_EPOCHS}", "--config", "seed=0"]


def u_draws(density, x, gen, num_u):
    """One standard normal ε of u a CIF layer of ``density``, from ``gen``:
    the draws ``card_vs_cpu`` passes to both sides."""
    import torch
    from cmf_tpu_torch.densities import ELBODensity

    layers = [m for m in density.modules() if isinstance(m, ELBODensity)]
    noise = [torch.randn(x.shape[0], num_u, generator=gen, device=x.device) for _ in layers]
    return {"u_noise": noise} if noise else {}


def captured_step_numbers(tag, model_args, dataset, cap, epochs, smi, phase):
    """Captured steps against eager ones from the same weights (the CIF's u
    drawn inside the graph), the ms of a captured step, its device ops and
    idle share, and a card step against the CPU's on the same u."""
    import torch

    probe = nosave_setup(model_args, dataset, cap, epochs)
    second = nosave_setup(model_args, dataset, cap, epochs)
    assert probe["density"].step_capturable, f"{tag}: the step is not capturable"
    captured, eager, flags, batches = trainers_captured_vs_eager(probe["trainer"], second["trainer"],
                                                                 f"{phase} {tag}")
    x = batches[0]
    replay_ms = cuda_ms(lambda: captured.step(x, flags), iters=20, warmup=2)
    print(f"[{phase}] {smi}: {tag}, captured: {replay_ms:.4f} ms per step back to back (CUDA events), "
          f"{x.shape[0] / replay_ms * 1e3:.1f} samples/s")
    profile_steps(captured.step, x, flags, 3, phase, f"{tag}, captured: ")
    gen = torch.Generator(device=x.device).manual_seed(7)
    draws = u_draws(second["density"], x, gen, second["config"]["num_u_channels"])
    card_vs_cpu(second, x, flags, f"{phase} {tag}", STEP_LOSS_TOL, STEP_GRAD_TOL, **draws)
    return probe


def phase_square_2d(smi, root):
    """The 2-D zoo's square flows and CIFs on the card: the 14 published
    2-D commands at their widths and depths under --nosave, no Gram/log-det
    or coupler launch over them; each one's captured steps against eager
    ones, ms and idle share, and a card step against the CPU; ``sample``
    raising for the forward-only flows. Then the coupled spline at
    miniboone's published widths into a run dir (resumed, tested, its
    steps, one ``sample(5000)`` profiled), and one sos layer at the
    published tabular widths, card against CPU."""
    import torch
    from cmf_tpu_torch.config import expand_grid, get_config
    from cmf_tpu_torch.data.tabular import get_tabular_datasets
    from cmf_tpu_torch.densities import ELBODensity
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.models import get_density
    from cmf_tpu_torch.ops import coupler_stack as cs
    from cmf_tpu_torch.ops import gram_logdet as gl
    from cmf_tpu_torch.training import get_objective

    phase_t0 = time.perf_counter()
    runs = []
    # The main path: the counts are read right after it.
    with _Recorded() as rec:
        gl.reset_launch_counts()
        cs.reset_launch_counts()
        for tag, model_args in SQUARE_2D_RUNS:
            start = len(rec.rows)
            t0 = time.perf_counter()
            (setup,) = cli_main(square_2d_argv(model_args))
            torch.cuda.synchronize()
            runs.append((tag, model_args, setup, time.perf_counter() - t0, rec.rows[start:]))
        torch.cuda.synchronize()
        launches = gl.launch_counts(), cs.LAUNCHES
    print(f"[square-2d] Gram/log-det launches (fwd, bwd) {launches[0]} and coupler launches {launches[1]} "
          f"over the {len(runs)} runs")
    assert launches == ((0, 0), 0), "a kernel launched on the 2-D square and CIF runs"

    for tag, model_args, setup, seconds, rows in runs:
        trainer, density, config = setup["trainer"], setup["density"], setup["config"]
        history = trainer.history
        scalars = {}
        for name, value, step in rows:
            scalars.setdefault(name, {})[step] = value
        valid = scalars.get("valid/loss", {})
        tests = {name[len("test/"):]: steps for name, steps in scalars.items() if name.startswith("test/")}
        test = tests.get("log-prob", {})
        cif_layers = sum(isinstance(m, ELBODensity) for m in density.modules())
        layer_types = sorted({type(m).__name__ for m in density.modules() if hasattr(m, "inverse_point")})
        print(f"[square-2d] {tag}: {cif_layers} CIF layers, {sum(p.numel() for p in density.parameters()):,} "
              f"parameters, layers {', '.join(layer_types)}; batch {config['train_batch_size']}, {config['opt']} lr "
              f"{config['lr']:g}, schedule {config['lr_schedule']}; {len(history)} steps, losses "
              f"{history[0][1]:.6g} -> {history[-1][1]:.6g}; route {'captured' if trainer.captured else 'eager'}, "
              f"{len(captured_steps(trainer))} graph(s); valid/loss at {sorted(valid)}: "
              f"{', '.join(f'{v:.6g}' for v in valid.values())}; test/log-prob at {sorted(test)}: "
              f"{', '.join(f'{v:.6g}' for v in test.values())} (test keys {sorted(tests)}); the run took "
              f"{seconds:.4f} s (host clock)")
        assert all(math.isfinite(h[1]) for h in history), f"{tag}: non-finite training loss"
        assert len(history) == SQUARE_2D_EPOCHS * 3 == SQUARE_2D_EPOCHS * len(trainer.train_loader), \
            f"{tag}: not {SQUARE_2D_EPOCHS} epochs of 3 steps"
        assert (cif_layers > 0) == ("--baseline" not in model_args), f"{tag}: the wrong family was built"
        assert trainer.captured and len(captured_steps(trainer)) == 1, f"{tag}: not one graph"
        assert sorted(valid) == list(range(1, SQUARE_2D_EPOCHS + 1)), f"{tag}: validated on other epochs"
        assert set(tests) == {"elbo", "log-prob", "bpd", "elbo-gap"} and all(
            sorted(steps) == [1] for steps in tests.values()), f"{tag}: no test pass at epoch 1 alone"
        assert all(math.isfinite(v) for steps in [valid, *tests.values()] for v in steps.values()), \
            f"{tag}: a non-finite validation or test number"
        if model_args[1] in FORWARD_ONLY_MODELS:
            try:
                density.sample(4, generator=torch.Generator(device="cuda").manual_seed(0))
            except NotImplementedError as raised:
                print(f"[square-2d] {tag}: sample raises NotImplementedError: {raised}")
            else:
                raise AssertionError(f"{tag}: sample did not raise")
        captured_step_numbers(tag, model_args, SQUARE_2D_DATASET, SQUARE_2D_ROWS, SQUARE_2D_EPOCHS, smi,
                              "square-2d")
    print(f"[square-2d] {smi}: the 2-D runs and their checks took {time.perf_counter() - phase_t0:.2f} s")

    # The coupled spline at miniboone's published widths, into a run dir.
    tag = "nsf-c miniboone --baseline"
    streams = sys.stdout, sys.stderr
    try:
        gl.reset_launch_counts()
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        (setup,) = cli_main(square_cif_argv(NSF_C_MINIBOONE, NSF_C_ROWS, NSF_C_EPOCHS) + ["--logdir-root", root])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = gl.launch_counts(), cs.LAUNCHES
        _restore_streams(streams)
        print(f"[square-2d] {tag}: Gram/log-det launches (fwd, bwd) {launches[0]} and coupler launches "
              f"{launches[1]}")
        assert launches == ((0, 0), 0), f"{tag}: a kernel launched"
        square_cif_run_checks(smi, tag, NSF_C_MINIBOONE, NSF_C_EPOCHS, setup, seconds, phase="square-2d")
        assert any(type(m).__name__ == "CoupledRationalQuadraticSplineBijection" for m in setup["density"].modules())
        square_cif_resume_and_test(tag, setup["writer"].logdir, NSF_C_EPOCHS, len(setup["trainer"].train_loader),
                                   phase="square-2d")
    finally:
        _restore_streams(streams)
    probe = captured_step_numbers(tag, NSF_C_MINIBOONE, "miniboone", NSF_C_ROWS, NSF_C_EPOCHS, smi, "square-2d")
    gen = torch.Generator(device="cuda").manual_seed(7)
    ops, busy, wall = profile_steps(lambda *_: probe["density"].sample(NSF_C_SAMPLES, generator=gen), None, None,
                                    1, "square-2d", f"{tag}, sample({NSF_C_SAMPLES}): ", unit="call")
    print(f"[square-2d] {smi}: {tag}: sample({NSF_C_SAMPLES}) {wall:.4f} ms wall, {busy:.4f} ms busy, {ops} device "
          f"ops (one pass a coupling inverse), against {AR_NSF_SAMPLE_MS} ms for the AR NSF's (43 passes a "
          f"layer; PERF.md, PR 13)")

    # One sos layer at the published tabular widths, card against CPU.
    x = torch.tensor(get_tabular_datasets("miniboone", synthetic=True)[0][:SOS_TABULAR_BATCH], device="cuda")
    flags = get_objective(expand_grid(get_config("miniboone", "sos", use_baseline=True))[0]).for_epoch(1)
    schema = [{"type": "flatten"}, SOS_TABULAR]
    density = get_density(schema, x_shape=(43,), device="cuda", generator=torch.Generator().manual_seed(0))
    card_vs_cpu({"density": density, "schema": schema}, x, flags, "square-2d sos layer at tabular width",
                STEP_LOSS_TOL, STEP_GRAD_TOL)
    schema = [{"type": "flatten"}] + [layer for i in range(SOS_TABULAR_LAYERS)
                                      for layer in ([{"type": "flip"}] if i else []) + [SOS_TABULAR]]
    gpu = get_density(schema, x_shape=(43,), device="cuda", generator=torch.Generator().manual_seed(0))
    cpu = get_density(schema, x_shape=(43,), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    with torch.no_grad():
        elbo_g, elbo_c = gpu.elbo(x)["elbo"].cpu(), cpu.elbo(x.cpu())["elbo"]
    both = torch.isfinite(elbo_g) & torch.isfinite(elbo_c)
    print(f"[square-2d] {SOS_TABULAR_LAYERS} sos layers with flips at tabular width, no batch-norm between them, "
          f"at init: {int(torch.isfinite(elbo_g).sum())} of {len(x)} rows finite on the card, "
          f"{int(torch.isfinite(elbo_c).sum())} on the CPU, {int(both.sum())} on both; the elbo of those "
          f"{rel_err(elbo_g[both], elbo_c[both]):.3e} apart (max err over max(1, max |elbo|))")
    print(f"[square-2d] {smi}: the phase took {time.perf_counter() - phase_t0:.2f} s")


def hutch_head(density):
    from cmf_tpu_torch.densities import NonSquareHeadDensity

    return next(m for m in density.modules() if isinstance(m, NonSquareHeadDensity))


def phase_hutch_gram(smi, root, exact_step_ms):
    """The flagship's Hutchinson run through the exact-Gram solver: into a
    run dir across the warm-up's first likelihood epoch (one graph a flag
    key, the probes drawn inside the graph), resumed and tested; with the
    likelihood from step 1; the sphere's, whose validation and test take
    the Gram/log-det forward kernel; 10 captured against 10 eager steps;
    the step's ms and idle share beside the exact step's; a card step
    against the CPU on the same probes."""
    import torch
    from cmf_tpu_torch.densities import elbo
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.ops import coupler_stack as cs
    from cmf_tpu_torch.ops import gram_logdet as gl

    phase_t0 = time.perf_counter()
    streams = sys.stdout, sys.stderr
    try:
        # The main path: the counts are read right after it.
        gl.reset_launch_counts()
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        (setup,) = cli_main(HUTCH_ARGV + ["--logdir-root", root, "--config", f"max_epochs={HUTCH_EPOCHS}",
                                          "--config", f"max_dataset_size={HUTCH_ROWS}"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = gl.launch_counts(), cs.LAUNCHES
        _restore_streams(streams)
        trainer, head = setup["trainer"], hutch_head(setup["density"])
        history, run_dir = trainer.history, setup["writer"].logdir
        tests = _scalar_steps(run_dir, "test/fid")
        lik_epochs = sorted({h[0] for h in history if not h[3]})
        print(f"[hutch-gram] {smi}: miniboone, log_jacobian_method=hutch_with_cg: solver "
              f"{head._resolved_hutch_solver(head.latent_dimension)!r} (d={head.latent_dimension}); "
              f"{len(history)} steps over {trainer.epoch} epochs, the likelihood from epoch {lik_epochs[0]}; "
              f"losses {history[0][1]:.6g} -> {history[-1][1]:.6g}; {len(captured_steps(trainer))} graph(s); "
              f"test/fid at {sorted(tests)}: {', '.join(f'{v:.6g}' for _, v in sorted(tests.items()))}; "
              f"Gram/log-det launches (fwd, bwd) {launches[0]}, coupler {launches[1]}; the run {seconds:.4f} s")
        assert head._resolved_hutch_solver(head.latent_dimension) == "gram" and elbo.GRAPH_SAFE_GENERATORS
        assert all(math.isfinite(h[1]) for h in history), "non-finite loss in the Hutchinson run"
        assert lik_epochs == list(range(26, HUTCH_EPOCHS + 1)), "the likelihood did not start at epoch index 26"
        assert trainer.captured and len(captured_steps(trainer)) == 2, "not one graph a flag key"
        assert sorted(tests) == [1, 6, 11, 16, 21, 26] and all(math.isfinite(v) for v in tests.values())
        # miniboone is a FID dataset: a non-square run's validation is the
        # FID and its test loss zero, as in cmf_tpu, so no evaluation takes
        # a log-det here (the sphere's below does).
        assert launches == ((0, 0), 0), "a kernel launched on the miniboone Hutchinson run"
        square_cif_resume_and_test("miniboone hutch", run_dir, HUTCH_EPOCHS, len(trainer.train_loader),
                                   phase="hutch-gram", metrics=("loss", "fid"))
        _restore_streams(streams)

        with _Recorded() as rec:
            (setup_nw,) = cli_main(HUTCH_ARGV + ["--nosave", "--config", "likelihood_warmup=False",
                                                 "--config", "max_epochs=2", "--config", f"max_dataset_size={HUTCH_ROWS}"])
        _restore_streams(streams)
        valid = rec.steps("valid/loss")
        history_nw = setup_nw["trainer"].history
        print(f"[hutch-gram] likelihood_warmup=False: {len(history_nw)} steps, losses "
              f"{', '.join(f'{h[1]:.6g}' for h in history_nw)}; valid/loss (FID) at {sorted(valid)}: "
              f"{', '.join(f'{v:.6g}' for _, v in sorted(valid.items()))}")
        assert not any(h[3] for h in history_nw) and all(math.isfinite(h[1]) for h in history_nw)
        assert sorted(valid) == [1, 2] and all(math.isfinite(v) for v in valid.values())
        assert len(captured_steps(setup_nw["trainer"])) == 1

        with _Recorded() as rec:
            gl.reset_launch_counts()
            (sphere,) = cli_main(HUTCH_SPHERE_ARGV)
            torch.cuda.synchronize()
            fwd, bwd = gl.launch_counts()
        _restore_streams(streams)
        st = sphere["trainer"]
        valid, test = rec.steps("valid/loss"), rec.steps("test/loss")
        evals = len(valid) * len(st.valid_loader) + len(test) * len(st.test_loader)
        print(f"[hutch-gram] sphere, hutch_with_cg: solver {hutch_head(sphere['density'])._resolved_hutch_solver(2)!r}; "
              f"{len(st.history)} steps, {len(captured_steps(st))} graph(s); valid/loss (-elbo) "
              f"{', '.join(f'{v:.6g}' for _, v in sorted(valid.items()))}, test/loss {test}; Gram/log-det "
              f"launches (fwd, bwd) {fwd}, {bwd} for {evals} evaluation batches")
        assert all(math.isfinite(h[1]) for h in st.history) and st.captured and len(captured_steps(st)) == 1
        assert all(math.isfinite(v) for v in list(valid.values()) + list(test.values()))
        assert fwd == evals > 0 and bwd == 0, "forward launches != evaluation batches on the sphere's run"
    finally:
        _restore_streams(streams)

    captured, eager, flags, batches = captured_vs_eager(HUTCH_STEPS_ARGV, "hutch-gram")
    x = batches[0]
    replay_ms = cuda_ms(lambda: captured.step(x, flags), iters=50, warmup=3)
    print(f"[hutch-gram] {smi}: captured Hutchinson step {replay_ms:.4f} ms back to back (CUDA events), "
          f"{x.shape[0] / replay_ms * 1e3:.1f} samples/s, against the exact step's {exact_step_ms:.4f} ms "
          f"(train phase)")
    profile_steps(captured.step, x, flags, 5, "hutch-gram", "captured: ")
    step_time(eager.eager_step, x, flags, 5, "hutch-gram", "eager: ")
    gen = torch.Generator(device=x.device).manual_seed(7)
    eps = torch.randn(x.shape[0], hutch_head(setup_nw["density"]).latent_dimension, 1, generator=gen, device=x.device)
    card_vs_cpu(setup_nw, x, setup_nw["trainer"].objective.for_epoch(1), "hutch-gram", STEP_LOSS_TOL, STEP_GRAD_TOL,
                hutchinson_eps=eps)
    print(f"[hutch-gram] {smi}: the phase took {time.perf_counter() - phase_t0:.2f} s")


def bn_buffers(density):
    """The floating-point buffers of ``density`` (the batch-norm
    statistics), cloned."""
    return [b.detach().clone() for b in density.buffers() if b.is_floating_point()]


def phase_batchnorm(smi, root):
    """The published tabular batch-norm models on the card: each command
    into a run dir (a refresh over the stored rows before each validation
    and test), no Gram/log-det or coupler launch, each resumed and tested;
    then for each, captured steps against eager ones (the statistics
    moved inside the graph), ms a step and its idle share, a card step
    against the CPU, a test pass that leaves the training state as it was,
    and one refresh over the whole synthetic train split timed."""
    import torch
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.nets import batch_statistics
    from cmf_tpu_torch.ops import coupler_stack as cs
    from cmf_tpu_torch.ops import gram_logdet as gl

    phase_t0 = time.perf_counter()
    streams = sys.stdout, sys.stderr
    runs = []
    try:
        # The main path: the counts are read right after it.
        gl.reset_launch_counts()
        cs.reset_launch_counts()
        for tag, model_args in BATCHNORM_RUNS:
            t0 = time.perf_counter()
            (setup,) = cli_main(square_cif_argv(model_args, BATCHNORM_ROWS, BATCHNORM_EPOCHS) + ["--logdir-root", root])
            torch.cuda.synchronize()
            runs.append((tag, model_args, setup, time.perf_counter() - t0))
            _restore_streams(streams)
        launches = gl.launch_counts(), cs.LAUNCHES

        for tag, model_args, setup, seconds in runs:
            trainer, density, config = setup["trainer"], setup["density"], setup["config"]
            history, run_dir = trainer.history, setup["writer"].logdir
            valid = _scalar_steps(run_dir, "valid/loss")
            test = _scalar_steps(run_dir, "test/log-prob")
            fid = config["use_fid"]
            refreshes = trainer.timings["refresh"][0]
            print(f"[batchnorm] {smi}: {tag}: {type(density.density).__name__} under the passthrough wrapper, "
                  f"{density.passthrough_x.shape[0]} stored rows, {sum(p.numel() for p in density.parameters()):,} "
                  f"parameters; {len(history)} steps, losses {', '.join(f'{h[1]:.6g}' for h in history)}; route "
                  f"{'captured' if trainer.captured else 'eager'}, {len(captured_steps(trainer))} graph(s); "
                  f"valid/loss ({'FID' if fid else '-log-prob'}) {valid}, test/log-prob {test}; {refreshes} "
                  f"refreshes, {trainer.timings['refresh'][1] / refreshes * 1e3:.4f} ms each; the run {seconds:.4f} s")
            assert all(math.isfinite(h[1]) for h in history), f"{tag}: non-finite training loss"
            assert len(history) == 3 * BATCHNORM_EPOCHS and density.passthrough_x.shape[0] == BATCHNORM_ROWS
            assert trainer.captured and len(captured_steps(trainer)) == 1, f"{tag}: not one graph"
            assert sorted(valid) == sorted(test) == [1], f"{tag}: no validation and test at epoch 1"
            assert tag in EVAL_OVERFLOWS or all(math.isfinite(v) for v in list(valid.values()) + list(test.values())), \
                f"{tag}: non-finite validation or test"
            # A validation, then the test's metrics, its FID and the
            # (tabular: drawing nothing) visualiser, each after a refresh.
            assert refreshes == len(valid) + (3 if fid else 2), f"{tag}: refreshes != evaluations"
        print(f"[batchnorm] Gram/log-det launches (fwd, bwd) {launches[0]} and coupler launches {launches[1]} "
              f"over the {len(runs)} runs")
        assert launches == ((0, 0), 0), "a kernel launched on the batch-norm runs"

        for tag, model_args, setup, _ in runs:
            metrics = SQUARE_METRICS if setup["config"]["use_fid"] else SQUARE_METRICS[:-1]
            square_cif_resume_and_test(tag, setup["writer"].logdir, BATCHNORM_EPOCHS, 3, phase="batchnorm",
                                       metrics=metrics, finite=tag not in EVAL_OVERFLOWS)
            _restore_streams(streams)
    finally:
        _restore_streams(streams)

    for tag, model_args in BATCHNORM_RUNS:
        probe = nosave_setup(model_args, "miniboone", BATCHNORM_ROWS, BATCHNORM_EPOCHS)
        second = nosave_setup(model_args, "miniboone", BATCHNORM_ROWS, BATCHNORM_EPOCHS)
        captured, eager, flags, batches = trainers_captured_vs_eager(probe["trainer"], second["trainer"],
                                                                     f"batchnorm {tag}")
        state_rel = max_rel_diff(bn_buffers(captured.density), bn_buffers(eager.density))
        print(f"[batchnorm] {tag}: the batch-norm statistics after the captured steps against the eager "
              f"ones: max rel diff {state_rel:.3e}")
        assert state_rel <= CAPTURED_TOL, f"{tag}: the captured statistics drift"
        x = batches[0]
        replay_ms = cuda_ms(lambda: captured.step(x, flags), iters=20, warmup=2)
        print(f"[batchnorm] {smi}: {tag}, captured: {replay_ms:.4f} ms per step back to back (CUDA events), "
              f"{x.shape[0] / replay_ms * 1e3:.1f} samples/s")
        profile_steps(captured.step, x, flags, 3, "batchnorm", f"{tag}, captured: ")
        gen = torch.Generator(device=x.device).manual_seed(7)
        draws = u_draws(second["density"], x, gen, second["config"]["num_u_channels"])
        card_vs_cpu(second, x, flags, f"batchnorm {tag}", STEP_LOSS_TOL, STEP_GRAD_TOL, **draws)

        before = bn_buffers(eager.density)
        results = eager.test()
        same = all(torch.equal(a, b) for a, b in zip(before, bn_buffers(eager.density)))
        print(f"[batchnorm] {tag}: Trainer.test() {({k: v for k, v in results.items() if k != 'feature_extractor'})}; "
              f"the training statistics bit-equal after it: {same}")
        assert same, f"{tag}: the evaluation left other statistics"

        full = nosave_setup(model_args, "miniboone", None, BATCHNORM_EPOCHS)
        density = full["density"]
        refresh_ms = host_ms(lambda: density.refresh_state(gen), 3)
        print(f"[batchnorm] {smi}: {tag}: one refresh over {density.passthrough_x.shape[0]:,} stored rows "
              f"{refresh_ms:.4f} ms (host clock, synchronized)")
        if tag in EVAL_OVERFLOWS:
            # The published layers with their batch-norm, at init: the
            # training elbo of 1000 stored rows (the batch's statistics),
            # then, after a refresh, the evaluation elbo of 3000 validation
            # rows on the card and on the CPU from the same weights and
            # statistics.
            from cmf_tpu_torch.models import get_density

            rows = density.passthrough_x[:SOS_TABULAR_BATCH]
            valid_x = torch.cat(list(full["trainer"].valid_loader))[:BATCHNORM_ROWS]
            with torch.no_grad():
                with batch_statistics(density):
                    train_elbo = density.elbo(rows)["elbo"]
                density.refresh_state(gen)
                eval_card = density.elbo(valid_x)["elbo"].cpu()
                cpu = get_density(full["schema"], x_shape=(valid_x.shape[1],), device="cpu")
                cpu.load_state_dict({k: v.cpu() for k, v in density.state_dict().items()})
                eval_cpu = cpu.elbo(valid_x.cpu())["elbo"]
            same = torch.equal(torch.isfinite(eval_card), torch.isfinite(eval_cpu))
            print(f"[batchnorm] sos --baseline at init with its batch-norm: {int(torch.isfinite(train_elbo).sum())} "
                  f"of {rows.shape[0]} stored rows finite in training mode; after a refresh "
                  f"{int(torch.isfinite(eval_card).sum())} of {valid_x.shape[0]} validation rows finite on the "
                  f"card, {int(torch.isfinite(eval_cpu).sum())} on the CPU, the same rows: {same}")
            assert bool(torch.isfinite(train_elbo).all()), "sos: a training elbo row overflowed with batch-norm"
            assert same, "sos: the card's overflowing rows are not the CPU's"
    print(f"[batchnorm] {smi}: the phase took {time.perf_counter() - phase_t0:.2f} s")


# The paper's tabular table on power (config/defaults/tabular.py: D = 6,
# d = 2, 10 couplings of [128]x4, a prior of 5 x [32]x2, batch 5000), from a
# raw-format ``power/data.npy`` of 62,000 x 8 rows: 6,200 test, 5,580 valid
# and 50,220 train rows, 10 steps of 5000 an epoch. Two arms (RNF and CMF)
# of 2 seeds each, 3 epochs a run with the likelihood from step 1.
TABLE_RAW_ROWS, TABLE_EPOCHS, TABLE_SEEDS = 62_000, 3, 2
TABLE_ARMS = [
    ("RNF", ["--config", "metric_regularization_param=0", "--config", "g_ij_loss=False"]),
    ("CMF", ["--config", "metric_regularization_param=1", "--config", "g_ij_loss=True"]),
]
TABLE_ARGV = ["--model", "non-square", "--dataset", "power", "--config", "likelihood_warmup=False",
              "--config", f"max_epochs={TABLE_EPOCHS}", "--num-seeds", str(TABLE_SEEDS)]


class _NoFigures:
    """Stands in for matplotlib where the card's machine has none: every
    call and attribute gives another stand-in, and ``savefig`` leaves an
    empty file. The 4/6-D visualiser of a power run dir still computes and
    writes its numbers (MACS, the invariants' JSON); its figures are
    empty."""

    def __getattr__(self, name):
        return _no_figures_attr(name)

    def __call__(self, *args, **kwargs):
        return _NoFigures()

    def __getitem__(self, index):
        return _NoFigures()

    def savefig(self, path, *args, **kwargs):
        open(path, "wb").close()


def _no_figures_attr(name):
    # Dunder lookups (``__file__``, ``__path__``: ``inspect`` walks every
    # module) must fail as on a real module.
    if name.startswith("__"):
        raise AttributeError(name)
    return _NoFigures()


_FIGURE_MODULES = ("matplotlib", "matplotlib.pyplot", "torch.utils.tensorboard")


class _FiguresStub:
    """``sys.modules`` holds a matplotlib stand-in, and no TensorBoard, for
    the block when matplotlib does not import; else nothing changes."""

    def __enter__(self):
        import importlib.machinery
        import importlib.util
        import types

        self.installed = importlib.util.find_spec("matplotlib") is None
        if self.installed:
            pyplot = types.ModuleType("matplotlib.pyplot")
            pyplot.__spec__ = importlib.machinery.ModuleSpec("matplotlib.pyplot", None)
            pyplot.__getattr__ = _no_figures_attr

            def subplots(nrows=1, ncols=1, **kwargs):
                n = nrows * ncols
                return _NoFigures(), (_NoFigures() if n == 1 else [_NoFigures() for _ in range(n)])

            pyplot.subplots = subplots
            mpl = types.ModuleType("matplotlib")
            mpl.__spec__ = importlib.machinery.ModuleSpec("matplotlib", None)
            mpl.use = lambda *args, **kwargs: None
            mpl.pyplot = pyplot
            # TensorBoard's figure summary renders through matplotlib's
            # backends: without matplotlib the run dir's writer keeps no
            # TensorBoard log (as where tensorboard does not import).
            self.saved = {name: sys.modules.get(name) for name in _FIGURE_MODULES}
            sys.modules.update({"matplotlib": mpl, "matplotlib.pyplot": pyplot, "torch.utils.tensorboard": None})
        return self

    def __exit__(self, *exc):
        if self.installed:
            for name, module in self.saved.items():
                if module is None:
                    sys.modules.pop(name, None)
                else:
                    sys.modules[name] = module


def phase_tabular_table(smi, root, counts):
    """The paper's tabular table on the card: power's published non-square
    model from a raw-format file, an RNF and a CMF arm of 2 seeds each, each
    arm's seeds split over two CLI calls with ``--grid-shard``; each run
    dir tested (``--test --test-fid --resume``); then the table by
    ``cmf_tpu_torch.analysis``. The Gram/log-det launches must equal the
    training steps (a FID dataset's evaluations take no log-det) and are
    added to ``counts``."""
    import numpy as np
    import torch
    from cmf_tpu_torch.analysis import collect_fid, collect_test_loss
    from cmf_tpu_torch.analysis.__main__ import main as analysis_main
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.ops import coupler_stack as cs
    from cmf_tpu_torch.ops import gram_logdet as gl

    phase_t0 = time.perf_counter()
    data_root = os.path.join(root, "tabular_data")
    runs_root = os.path.join(root, "tabular_table")
    os.makedirs(os.path.join(data_root, "power"))
    rng = np.random.default_rng(0)
    # Eight columns, as the UCI file's: the loader drops columns 3 and 1.
    np.save(os.path.join(data_root, "power", "data.npy"),
            rng.normal(size=(TABLE_RAW_ROWS, 8)) @ rng.normal(size=(8, 8)))
    streams = sys.stdout, sys.stderr
    runs = []
    try:
        with _FiguresStub() as stub:
            # The main path: the counts are read right after it.
            gl.reset_launch_counts()
            cs.reset_launch_counts()
            t0 = time.perf_counter()
            for label, arm in TABLE_ARMS:
                for shard in range(TABLE_SEEDS):
                    results = cli_main(TABLE_ARGV + arm + ["--data-root", data_root, "--logdir-root", runs_root,
                                                           "--grid-shard", f"{shard}/{TABLE_SEEDS}"])
                    _restore_streams(streams)
                    assert len(results) == 1, f"{label}: shard {shard} ran {len(results)} jobs"
                    runs.append((label, shard, results[0]))
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            fwd, bwd = gl.launch_counts()
            coupler = cs.LAUNCHES
            steps = sum(len(setup["trainer"].history) for _, _, setup in runs)
            for label, shard, setup in runs:
                trainer, config = setup["trainer"], setup["config"]
                history = trainer.history
                valid = _scalar_steps(setup["writer"].logdir, "valid/loss", "power")
                print(f"[tabular-table] {smi}: {label} shard {shard}/{TABLE_SEEDS}: seed {config['seed']}, "
                      f"lambda {config['metric_regularization_param']}, g_ij {config['g_ij_loss']}; "
                      f"{trainer.train_loader.x.shape[0]:,} train rows of {trainer.train_loader.x.shape[1]}; "
                      f"{len(history)} steps, losses {history[0][1]:.6g} -> {history[-1][1]:.6g}; "
                      f"{len(captured_steps(trainer))} graph(s); valid/loss (FID) "
                      f"{', '.join(f'{v:.6g}' for _, v in sorted(valid.items()))}")
                assert config["dataset"] == "power" and not config.get("synthetic_data")
                assert trainer.train_loader.x.shape[1] == 6 and len(trainer.train_loader) == 10
                assert len(history) == 10 * TABLE_EPOCHS and not any(h[3] for h in history)
                assert all(math.isfinite(h[1]) for h in history), f"{label}: non-finite training loss"
                assert trainer.captured and len(captured_steps(trainer)) == 1, f"{label}: not one graph"
            seeds = [setup["config"]["seed"] for _, _, setup in runs]
            print(f"[tabular-table] {smi}: {len(runs)} runs ({steps} steps) in {train_s:.4f} s; Gram/log-det "
                  f"launches (fwd, bwd) {fwd}, {bwd}; coupler {coupler}; matplotlib stand-in: {stub.installed}")
            assert len(set(seeds)) == len(seeds), "two runs share a seed"
            assert fwd == bwd == steps and coupler == 0, "Gram/log-det launches != training steps"
            counts["GRAM_FWD"] += fwd
            counts["GRAM_BWD"] += bwd

            t0 = time.perf_counter()
            for label, shard, setup in runs:
                (tested,) = cli_main(["--test", "--test-fid", "--resume", setup["writer"].logdir])
                _restore_streams(streams)
                assert tested["config"]["num_fid_samples"] == 50_000 and tested["config"]["use_test_fid"]
                results = tested["results"]
                print(f"[tabular-table] {label} shard {shard}: --test --test-fid --resume "
                      f"({tested['config']['num_fid_samples']:,} samples against the test split): {results}")
                assert math.isfinite(results["fid"]), f"{label}: non-finite test FID"
            test_s = time.perf_counter() - t0
            print(f"[tabular-table] {smi}: the {len(runs)} tests took {test_s:.4f} s; Gram/log-det launches (fwd, "
                  f"bwd) after them {gl.launch_counts()}")
            assert gl.launch_counts() == (fwd, bwd), "a FID dataset's test took a log-det"
    finally:
        _restore_streams(streams)

    fid_rows, loss_rows = collect_fid(runs_root), collect_test_loss(runs_root)
    for name, rows in (("fid", fid_rows), ("loss", loss_rows)):
        for r in rows:
            print(f"[tabular-table] table ({name}): power, lambda {r['metric_regularization_param']}, d "
                  f"{r['latent_dimension']}: {r['mean']:.6g} +- {r['stderr']:.6g} (n = {r['n']})")
        assert [r["metric_regularization_param"] for r in rows] == [0, 1], f"{name}: not one row an arm"
        assert all(r["n"] == TABLE_SEEDS and math.isfinite(r["mean"]) for r in rows), f"{name}: a row lacks a run"
    csv_path = os.path.join(root, "tabular_table.csv")
    rows = analysis_main(["tabular", "--runs", runs_root, "--out", csv_path])
    with open(csv_path) as f:
        print(f"[tabular-table] python -m cmf_tpu_torch.analysis tabular: {f.read().strip()!r}")
    assert [(r["metric_regularization_param"], r["n"]) for r in rows] == [(0, 2), (1, 2)]

    trainer = runs[-1][2]["trainer"]
    x = next(iter(trainer.train_loader))
    flags = trainer.objective.for_epoch(trainer.epoch)
    replay_ms = cuda_ms(lambda: trainer.step(x, flags), iters=20, warmup=2)
    print(f"[tabular-table] {smi}: power CMF captured step {replay_ms:.4f} ms back to back (CUDA events), "
          f"{x.shape[0] / replay_ms * 1e3:.1f} samples/s (batch {x.shape[0]})")
    profile_steps(trainer.step, x, flags, 3, "tabular-table", "captured: ")
    print(f"[tabular-table] {smi}: the phase took {time.perf_counter() - phase_t0:.2f} s")


# The non-square flagship with batch-norm layers (``--config batch_norm=True``:
# snapshot mode under the passthrough wrapper) at published widths, the
# likelihood from step 1; every split capped at 1,200 rows, 3 steps of 400.
NONSQUARE_BN_MODEL = ["--model", "non-square", "--config", "batch_norm=True", "--config", "likelihood_warmup=False"]
NONSQUARE_BN_ROWS, NONSQUARE_BN_EPOCHS = 1200, 2
# mnist's non-square model with batch-norm ResNet couplers, 3 Hutchinson
# steps of 50 under --nosave; each coupler's ResNet cut from the published
# 8 blocks of 64 channels to 2 (width kept): with the batch statistics in
# the decode, CG runs all of its d = 20 iterations, where it stops after
# the first without batch-norm, and a full-depth step took 9.57 s on an
# NVIDIA H100 80GB HBM3 at 700 W (40 s at batch 8 on a CPU). Its card step
# at batch 8 against the CPU, as the image-square phase holds its
# batch-norm models.
NONSQUARE_BN_MNIST_ARGV = [
    "--model", "non-square", "--dataset", "mnist", "--synthetic-data", "--nosave",
    "--config", "resnet_batchnorm=True", "--config", "likelihood_warmup=False", "--config", "early_stopping=False",
    "--config", "use_fid=False", "--config", "max_epochs=1", "--config", "max_dataset_size=150", "--config", "seed=0",
    "--config", "g_hidden_channels=[64,64]",
]
NONSQUARE_BN_MNIST_BATCH = 8


def phase_nonsquare_bn(smi, root, counts):
    """Batch-norm in non-square models on the card: the flagship with
    ``batch_norm=True`` into a run dir (its decode through the dense
    program's ``bn`` steps and the Gram/log-det kernels; a refresh over the
    stored rows before each evaluation), resumed and tested; its captured
    steps against eager ones, the statistics too; a card step against the
    CPU; then mnist with batch-norm ResNet couplers on the Hutchinson route,
    card against CPU on the same probes. The Gram/log-det launches are
    added to ``counts``."""
    import torch
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.ops import coupler_stack as cs
    from cmf_tpu_torch.ops import gram_logdet as gl

    phase_t0 = time.perf_counter()
    streams = sys.stdout, sys.stderr
    argv = square_cif_argv(NONSQUARE_BN_MODEL, NONSQUARE_BN_ROWS, NONSQUARE_BN_EPOCHS)
    try:
        # The main path: the counts are read right after it.
        gl.reset_launch_counts()
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        (setup,) = cli_main(argv + ["--logdir-root", root])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        (fwd, bwd), coupler = gl.launch_counts(), cs.LAUNCHES
        _restore_streams(streams)
        trainer, density = setup["trainer"], setup["density"]
        head = hutch_head(density)
        program = head._dense_decode_program()
        history, run_dir = trainer.history, setup["writer"].logdir
        valid = _scalar_steps(run_dir, "valid/loss")
        refreshes = trainer.timings["refresh"][0]
        steps = len(history)
        print(f"[nonsquare-bn] {smi}: miniboone non-square, batch_norm=True: {type(density).__name__} root, "
              f"{density.passthrough_x.shape[0]} stored rows, {sum(p.numel() for p in density.parameters()):,} "
              f"parameters; dense decode program of {len(program.steps)} steps "
              f"({sum(s['kind'] == 'bn' for s in program.steps)} bn); {steps} steps, losses "
              f"{', '.join(f'{h[1]:.6g}' for h in history)}; {len(captured_steps(trainer))} graph(s); valid/loss "
              f"(FID) {valid}; {refreshes} refreshes; Gram/log-det launches (fwd, bwd) {fwd}, {bwd}, coupler "
              f"{coupler}; the run {seconds:.4f} s")
        assert all(math.isfinite(h[1]) for h in history) and not any(h[3] for h in history)
        assert steps == 3 * NONSQUARE_BN_EPOCHS and density.passthrough_x.shape[0] == NONSQUARE_BN_ROWS
        assert sum(s["kind"] == "bn" for s in program.steps) == 10, "the decode is not the dense bn program"
        assert trainer.captured and len(captured_steps(trainer)) == 1, "not one graph"
        assert sorted(valid) == list(range(1, NONSQUARE_BN_EPOCHS + 1)) and all(map(math.isfinite, valid.values()))
        # One backward launch a step; one forward a step and one a refresh
        # (the head's training elbo over the stored rows): a FID dataset's
        # evaluations take no log-det.
        assert bwd == steps and fwd == steps + refreshes and coupler == 0, "Gram/log-det launches != steps"
        counts["GRAM_FWD"] += fwd
        counts["GRAM_BWD"] += bwd
        square_cif_resume_and_test("miniboone batch_norm", run_dir, NONSQUARE_BN_EPOCHS, 3, phase="nonsquare-bn",
                                   metrics=("loss", "fid"))
        _restore_streams(streams)
    finally:
        _restore_streams(streams)

    probe = nosave_setup(NONSQUARE_BN_MODEL, "miniboone", NONSQUARE_BN_ROWS, 1)
    second = nosave_setup(NONSQUARE_BN_MODEL, "miniboone", NONSQUARE_BN_ROWS, 1)
    captured, eager, flags, batches = trainers_captured_vs_eager(probe["trainer"], second["trainer"], "nonsquare-bn")
    state_rel = max_rel_diff(bn_buffers(captured.density), bn_buffers(eager.density))
    print(f"[nonsquare-bn] the batch-norm statistics after the captured steps against the eager ones: max rel "
          f"diff {state_rel:.3e} (tol {CAPTURED_TOL:g})")
    assert state_rel <= CAPTURED_TOL, "the captured statistics drift"
    x = batches[0]
    replay_ms = cuda_ms(lambda: captured.step(x, flags), iters=20, warmup=2)
    print(f"[nonsquare-bn] {smi}: captured step {replay_ms:.4f} ms back to back (CUDA events), "
          f"{x.shape[0] / replay_ms * 1e3:.1f} samples/s (batch {x.shape[0]})")
    profile_steps(captured.step, x, flags, 3, "nonsquare-bn", "captured: ")
    card_vs_cpu(second, x, flags, "nonsquare-bn", STEP_LOSS_TOL, STEP_GRAD_TOL)

    try:
        cs.reset_launch_counts()
        gl.reset_launch_counts()
        t0 = time.perf_counter()
        (mnist,) = cli_main(NONSQUARE_BN_MNIST_ARGV)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        _restore_streams(streams)
    trainer = mnist["trainer"]
    head = mnist_head(mnist["density"])
    from cmf_tpu_torch.nets import BatchNorm2d

    num_bn = sum(isinstance(m, BatchNorm2d) for m in mnist["density"].modules())
    history = trainer.history
    print(f"[nonsquare-bn] {smi}: mnist non-square, resnet_batchnorm=True ({num_bn} BatchNorm2d, solver "
          f"{head._resolved_hutch_solver(head.latent_dimension)!r}): {len(history)} Hutchinson steps, losses "
          f"{', '.join(f'{h[1]:.6g}' for h in history)}; route {'captured' if trainer.captured else 'eager'} "
          f"(a dequantized image model's step is not capturable); coupler launches {cs.LAUNCHES}, Gram/log-det "
          f"{gl.launch_counts()}; the run {seconds:.4f} s")
    assert num_bn == 10 * 5 and len(history) == 3 and all(math.isfinite(h[1]) for h in history)
    assert not any(h[3] for h in history)
    assert cs.LAUNCHES == 0 and gl.launch_counts() == (0, 0), "a kernel launched on the batch-norm couplers"
    x = next(iter(trainer.train_loader))
    flags = trainer.objective.for_epoch(trainer.epoch)
    step_time(trainer.step, x, flags, 1, "nonsquare-bn", "mnist resnet_batchnorm, eager: ")
    gen = torch.Generator(device=x.device).manual_seed(1)
    xb = x[:NONSQUARE_BN_MNIST_BATCH]
    draws = {"dequantization_noise": torch.rand(xb.shape, generator=gen, device=x.device),
             "hutchinson_eps": torch.randn((xb.shape[0], head.latent_dimension, head.num_hutchinson_samples),
                                           generator=gen, device=x.device)}
    image_square_card_vs_cpu(mnist, xb, flags, "nonsquare-bn mnist resnet_batchnorm", draws)
    print(f"[nonsquare-bn] {smi}: the phase took {time.perf_counter() - phase_t0:.2f} s")


def phase_bf16_flagship(smi, counts, fp32_step_ms):
    """The flagship under compute_dtype=bfloat16 at its published width:
    the CLI's captured training with the likelihood on from step 1 (one
    launch of each Gram/log-det kernel a step, added to ``counts``);
    captured against eager steps; a card step against the CPU; ms a
    captured step beside the fp32 one of the train phase."""
    import torch
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.nets import get_compute_dtype, set_compute_dtype
    from cmf_tpu_torch.ops import gram_logdet as gl

    phase_t0 = time.perf_counter()
    try:
        # The main path: the counts are read right after it.
        gl.reset_launch_counts()
        (setup,) = cli_main(BF16_FLAGSHIP_ARGV)
        torch.cuda.synchronize()
        fwd, bwd = gl.launch_counts()
        counts["GRAM_FWD"] += fwd
        counts["GRAM_BWD"] += bwd
        trainer = setup["trainer"]
        history = trainer.history
        lik_steps = sum(1 for h in history if not h[3])
        print(f"[bf16-flagship] {smi}: miniboone non-square, compute_dtype {get_compute_dtype()}: "
              f"{len(history)} steps, losses {history[0][1]:.6g} -> {history[-1][1]:.6g}; "
              f"{len(captured_steps(trainer))} graph(s); Gram/log-det launches (fwd, bwd) {fwd}, {bwd}")
        assert get_compute_dtype() == torch.bfloat16, "setup did not set the bf16 policy"
        assert all(math.isfinite(h[1]) for h in history) and lik_steps == len(history) > 0
        assert trainer.captured and len(captured_steps(trainer)) == 1, "the bf16 step ran no graph"
        assert fwd == bwd == lik_steps, "Gram/log-det launches != likelihood steps"

        captured, eager, flags, batches = captured_vs_eager(BF16_FLAGSHIP_ARGV, "bf16-flagship")
        x = batches[0]
        replay_ms = cuda_ms(lambda: captured.step(x, flags), iters=50, warmup=3)
        print(f"[bf16-flagship] {smi}: captured bf16 step {replay_ms:.4f} ms back to back (CUDA events), "
              f"{x.shape[0] / replay_ms * 1e3:.1f} samples/s, against the fp32 step's {fp32_step_ms:.4f} ms "
              f"(train phase, same call)")
        profile_steps(captured.step, x, flags, 5, "bf16-flagship", "captured: ")
        card_vs_cpu(setup, x, flags, "bf16-flagship", BF16_LOSS_TOL, BF16_GRAD_TOL)
    finally:
        set_compute_dtype("float32")
    print(f"[bf16-flagship] {smi}: the phase took {time.perf_counter() - phase_t0:.2f} s")
    return replay_ms


def phase_bf16_mnist(smi, fp32_setup, counts):
    """mnist non-square (Hutchinson + CG) at full width under bf16: 3
    steps through the CLI; a card step against the CPU at batch 8 on the
    same draws; ``sample(250)`` through the coupler kernel's bf16 variant
    (one launch a coupling, none of the fp32 variant; the count goes to
    ``counts``) against the conv route under the same policy; ms a step
    beside the fp32 model's (train-mnist's trainer, same call)."""
    import torch
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.nets import compute_dtype, get_compute_dtype, set_compute_dtype
    from cmf_tpu_torch.ops import coupler_stack as cs

    phase_t0 = time.perf_counter()
    try:
        cs.reset_launch_counts()
        (setup,) = cli_main(BF16_MNIST_ARGV + BF16)
        torch.cuda.synchronize()
        trainer, density = setup["trainer"], setup["density"]
        history = trainer.history
        print(f"[bf16-mnist] {smi}: mnist non-square, compute_dtype {get_compute_dtype()}: {len(history)} steps, "
              f"losses {', '.join(f'{h[1]:.6g}' for h in history)}; route "
              f"{'captured' if trainer.captured else 'eager'}; coupler launches {cs.LAUNCHES}")
        assert get_compute_dtype() == torch.bfloat16 and len(history) == 3
        assert all(math.isfinite(h[1]) for h in history) and cs.LAUNCHES == 0

        flags = trainer.objective.for_epoch(trainer.epoch)
        x = next(iter(trainer.train_loader))
        bf16_ms = step_time(trainer.step, x, flags, 3, "bf16-mnist", "bf16: ")
        with compute_dtype("float32"):
            ft = fp32_setup["trainer"]
            fp32_ms = step_time(ft.step, x, ft.objective.for_epoch(ft.epoch), 3, "bf16-mnist", "fp32: ")
        print(f"[bf16-mnist] {smi}: {bf16_ms:.4f} ms a bf16 step against {fp32_ms:.4f} ms in fp32 (host clock)")
        head = mnist_head(density)
        gen = torch.Generator(device=x.device).manual_seed(1)
        xb = x[:8]
        noise = torch.rand(xb.shape, generator=gen, device=x.device)
        eps = torch.randn((xb.shape[0], head.latent_dimension, head.num_hutchinson_samples),
                          generator=gen, device=x.device)
        card_vs_cpu(setup, xb, flags, "bf16-mnist", BF16_LOSS_TOL, BF16_GRAD_TOL,
                    dequantization_noise=noise, hutchinson_eps=eps)

        # The bf16 sampling path: the counts are read right after it.
        gen = torch.Generator(device=x.device).manual_seed(2)
        cs.reset_launch_counts()
        samples = density.sample(MNIST_SAMPLE_BATCH, generator=gen)
        torch.cuda.synchronize()
        bf16_launches, fp32_launches = cs.BF16_LAUNCHES, cs.LAUNCHES - cs.BF16_LAUNCHES
        counts["COUPLER_BF16_LAUNCHES"] = bf16_launches
        noise = torch.randn((MNIST_SAMPLE_BATCH, head.latent_dimension), generator=gen, device=x.device)
        got = density.fixed_sample(noise)
        with torch.no_grad():
            ref = density._fixed_sample(noise)
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        n_calls = 5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_calls):
            density.sample(MNIST_SAMPLE_BATCH, generator=gen)
        torch.cuda.synchronize()
        sample_ms = (time.perf_counter() - t0) / n_calls * 1e3
        print(f"[bf16-mnist] sample({MNIST_SAMPLE_BATCH}) {tuple(samples.shape)} under bf16: coupler launches "
              f"bf16 {bf16_launches}, fp32 {fp32_launches}; {sample_ms:.4f} ms a call (host clock); the kernel "
              f"route against the conv route (cuDNN bf16, which also rounds each conv's output) on the same "
              f"noise: max err / max |ref| {err:.3e}")
        assert bf16_launches == MNIST_COUPLINGS and fp32_launches == 0, "sample() did not take the bf16 variant"
        assert bool(torch.isfinite(samples).all()) and bool(torch.isfinite(got).all())
    finally:
        set_compute_dtype("float32")
    print(f"[bf16-mnist] {smi}: the phase took {time.perf_counter() - phase_t0:.2f} s")


def rel_max_err(got, ref):
    return float((got - ref).abs().max()) / float(ref.abs().max())


def bf16_conv_reading(batch, hidden, hw):
    """One 3x3 conv of ``batch`` maps of ``hidden`` channels through the
    policy's ``_conv2d`` on the card in bf16, against the same conv of the
    bf16-rounded operands summed in fp64 and rounded to bf16 once: the
    share of outputs that land on another bf16 value, and the largest
    difference over max |output| (a bf16 ulp is 2^-8 = 3.9e-3 of a value)."""
    import torch
    import torch.nn.functional as F
    from cmf_tpu_torch.nets import compute_dtype
    from cmf_tpu_torch.nets.core import _conv2d
    from cmf_tpu_torch.ops.coupler_stack import bf16_round

    gen = torch.Generator().manual_seed(5)
    x = torch.randn((batch, hidden, hw, hw), generator=gen)
    w = torch.randn((hidden, hidden, 3, 3), generator=gen) / (3 * hidden**0.5)
    exact = F.conv2d(bf16_round(x).double(), bf16_round(w).double(), padding=1)
    once = exact.float().to(torch.bfloat16).float()
    with torch.no_grad(), compute_dtype("bfloat16"):
        got = _conv2d(x.cuda(), w.cuda()).cpu()
    return float((got != once).double().mean()), rel_max_err(got, once)


def conv_gram_fp32_checks(setup, x, z, program_out, jvp_out):
    """The fp32 checks of the conv program: against the vmap of JVPs in fp64
    on a copy of the model (CONV_GRAM_FP64_TOL) and in fp32 with cuDNN off
    (CONV_GRAM_TOL); its results under cuDNN, as the path runs, against the
    fp64 JVPs' (CONV_GRAM_CUDNN_TOL), the fp32 JVPs' distance beside them."""
    import torch
    from cmf_tpu_torch.models import get_density

    head = mnist_head(setup["density"])
    wide = get_density(setup["schema"], x_shape=tuple(x.shape[1:]), device=z.device)
    wide.load_state_dict(setup["density"].state_dict())
    wide_head = mnist_head(wide.double())
    with torch.no_grad():
        program_64 = wide_head._dense_decode_program()(z.double())
        jvp_64 = wide_head._generic_jacobian(z.double())
        with torch.backends.cudnn.flags(enabled=False, benchmark=False, deterministic=False, allow_tf32=False):
            program_native = head._dense_decode_program()(z)
            jvp_native = head._generic_jacobian(z)
    torch.cuda.synchronize()
    ok = True
    for i, what in enumerate(("reconstruction", "columns")):
        exact = rel_max_err(program_64[i], jvp_64[i])
        native = rel_max_err(program_native[i], jvp_native[i])
        cudnn = rel_max_err(program_out[i].double(), jvp_64[i])
        cudnn_jvp = rel_max_err(jvp_out[i].double(), jvp_64[i])
        print(f"[conv-gram] float32 {what}: the program against the vmap of JVPs in fp64 {exact:.3e} (tol "
              f"{CONV_GRAM_FP64_TOL:g}), in fp32 with cuDNN off {native:.3e} (tol {CONV_GRAM_TOL:g}); under "
              f"cuDNN from the fp64 JVPs' the program {cudnn:.3e} (tol {CONV_GRAM_CUDNN_TOL:g}) and the fp32 "
              f"JVPs {cudnn_jvp:.3e}")
        ok = ok and exact <= CONV_GRAM_FP64_TOL and native <= CONV_GRAM_TOL and cudnn <= CONV_GRAM_CUDNN_TOL
    assert ok, "the conv program's fp32 columns disagree with the JVPs"


def conv_gram_bf16_checks(setup, x, z, program_out, jvp_out):
    """The bf16 checks of the conv program (CONV_GRAM_BF16_TOL and what
    stands beside it): on the card against the vmap of JVPs and against the
    fp32 JVP; on a CPU copy of the model at CONV_GRAM_CPU_BATCH images
    against the vmap of JVPs there; the card's bf16 results against the
    CPU's; and one bf16 conv of the card against the once-rounded sum."""
    import torch
    from cmf_tpu_torch.models import get_density
    from cmf_tpu_torch.nets import compute_dtype

    head = mnist_head(setup["density"])
    with torch.no_grad(), compute_dtype("float32"):
        jvp_32 = head._generic_jacobian(z)
    cpu = get_density(setup["schema"], x_shape=tuple(x.shape[1:]), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in setup["density"].state_dict().items()})
    cpu_head = mnist_head(cpu)
    zc = z[:CONV_GRAM_CPU_BATCH].cpu()
    with torch.no_grad():
        cpu_program = cpu_head._dense_decode_program()(zc)
        cpu_jvp = cpu_head._generic_jacobian(zc)
        with compute_dtype("float32"):
            cpu_jvp_32 = cpu_head._generic_jacobian(zc)
    ok = True
    for i, (what, tol) in enumerate((("reconstruction", CONV_GRAM_BF16_REC_TOL), ("columns", CONV_GRAM_BF16_TOL))):
        err = rel_max_err(program_out[i], jvp_out[i])
        gap = rel_max_err(jvp_out[i], jvp_32[i])
        away = rel_max_err(program_out[i], jvp_32[i])
        cpu_err = rel_max_err(cpu_program[i], cpu_jvp[i])
        cpu_gap = rel_max_err(cpu_jvp[i], cpu_jvp_32[i])
        card = [t[i][:CONV_GRAM_CPU_BATCH] if i == 0 else t[i][:, :CONV_GRAM_CPU_BATCH] for t in (program_out, jvp_out)]
        vs_cpu = [rel_max_err(c, r.cuda()) for c, r in zip(card, (cpu_program[i], cpu_jvp[i]))]
        print(f"[conv-gram] bfloat16 {what}: the program against the vmap of JVPs {err:.3e} (tol {tol:g}); "
              f"from the fp32 JVP's, the program {away:.3e} and the bf16 JVP {gap:.3e}, a share of "
              f"{away / gap:.3f} (at least {CONV_GRAM_BF16_MIN_SHARE:g}); on the CPU at {CONV_GRAM_CPU_BATCH} "
              f"images the program against the JVPs {cpu_err:.3e} (tol {CONV_GRAM_CPU_TOL:g} and below the "
              f"CPU's bf16 gap {cpu_gap:.3e}); the card against the CPU, program {vs_cpu[0]:.3e}, JVPs "
              f"{vs_cpu[1]:.3e}")
        ok = ok and err <= tol and away >= CONV_GRAM_BF16_MIN_SHARE * gap
        ok = ok and cpu_err <= CONV_GRAM_CPU_TOL and cpu_err < cpu_gap
    for batch in (CONV_GRAM_CHECK_BATCH, CONV_GRAM_CHECK_BATCH * (z.shape[1] + 1)):
        share, diff = bf16_conv_reading(batch, MNIST_HIDDEN, 14)
        print(f"[conv-gram] one bf16 3x3 conv, {batch} maps of {MNIST_HIDDEN} channels at 14x14, on the card "
              f"against its exact sum rounded once: {share:.3e} of the outputs on another bf16 value, max "
              f"|difference| / max |output| {diff:.3e}")
    assert ok, "the conv program's bf16 columns disagree with the JVPs, or do not round as bf16"


def phase_conv_gram(smi):
    """mnist at full width with hutchinson_solver=gram, in fp32 and bf16:
    3 steps through the CLI, the d columns decoded by the dense program's
    conv stages; at one batch the program's columns against the vmap of
    JVPs on the card (conv_gram_fp32_checks, conv_gram_bf16_checks); ms a
    step; whether the step is captured, and whether
    the head's gram-route loss and backward capture in a CUDA graph with
    their draws passed in."""
    import torch
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.nets import compute_dtype, set_compute_dtype
    from cmf_tpu_torch.training import elbo_loss

    phase_t0 = time.perf_counter()
    try:
        for dtype in ("float32", "bfloat16"):
            (setup,) = cli_main(CONV_GRAM_ARGV + ["--config", f"compute_dtype={dtype}"])
            torch.cuda.synchronize()
            trainer, density = setup["trainer"], setup["density"]
            head = mnist_head(density)
            program = head._dense_decode_program()
            history = trainer.history
            print(f"[conv-gram] {smi}: mnist, hutchinson_solver=gram, {dtype}: solver "
                  f"{head._resolved_hutch_solver(head.latent_dimension)!r}, dense program of {len(program.steps)} "
                  f"steps (has_conv {program.has_conv}); {len(history)} steps, losses "
                  f"{', '.join(f'{h[1]:.6g}' for h in history)}; route {'captured' if trainer.captured else 'eager'} "
                  f"(density step_capturable {density.step_capturable}, head {head.step_capturable})")
            assert program.has_conv and head._resolved_hutch_solver(head.latent_dimension) == "gram"
            assert len(history) == 3 and all(math.isfinite(h[1]) for h in history)

            flags = trainer.objective.for_epoch(trainer.epoch)
            x = next(iter(trainer.train_loader))
            step_time(trainer.step, x, flags, 3, "conv-gram", f"{dtype}: ")
            with torch.no_grad():
                z = density.extract_latent(x[:CONV_GRAM_CHECK_BATCH])  # the head's d coordinates
                rec_p, cols_p = program(z)
                rec_g, cols_g = head._generic_jacobian(z)
            torch.cuda.synchronize()
            err, rec_err = rel_max_err(cols_p, cols_g), rel_max_err(rec_p, rec_g)
            print(f"[conv-gram] {dtype}: at {CONV_GRAM_CHECK_BATCH} images the program's {tuple(cols_p.shape)} "
                  f"columns against the vmap of JVPs: max err / max |ref| {err:.3e}, the reconstruction "
                  f"{rec_err:.3e}")
            if dtype == "float32":
                conv_gram_fp32_checks(setup, x, z, (rec_p, cols_p), (rec_g, cols_g))
            else:
                conv_gram_bf16_checks(setup, x, z, (rec_p, cols_p), (rec_g, cols_g))

            # Whether the gram route's step captures with the conv program,
            # its dequantization noise and probes passed in.
            gen = torch.Generator(device=x.device).manual_seed(4)
            noise = torch.rand(x.shape, generator=gen, device=x.device)
            eps = torch.randn((x.shape[0], head.latent_dimension, 1), generator=gen, device=x.device)

            def loss_and_backward():
                loss = elbo_loss(density, x, flags, dequantization_noise=noise, hutchinson_eps=eps)
                loss.backward()
                return loss.detach()

            with compute_dtype(dtype):
                try:
                    graph, out = capture(loss_and_backward)
                    graph.replay()
                    eager_loss = float(loss_and_backward())
                    torch.cuda.synchronize()
                    print(f"[conv-gram] {dtype}: the gram-route loss and backward captured in a CUDA graph; "
                          f"replay loss {float(out):.8g} against eager {eager_loss:.8g}")
                    assert abs(float(out) - eager_loss) <= CAPTURED_TOL * abs(eager_loss)
                except RuntimeError as e:
                    print(f"[conv-gram] {dtype}: the gram-route step does not capture: {str(e)[:300]}")
                    raise
            for p in density.parameters():
                p.grad = None
    finally:
        set_compute_dtype("float32")
    print(f"[conv-gram] {smi}: the phase took {time.perf_counter() - phase_t0:.2f} s")


# ------------------------------------------------------------------ mesh
# The flagship at one epoch of 10 steps, the likelihood on from step 1.
MESH_ARGV = TRAIN_ARGV + ["--config", "max_epochs=1"]
MESH_TIMEOUT_S = 240
# World 1 against the un-meshed run: the same kernels on the same inputs;
# the all-reduces of one rank add nothing.
MESH_LOSS_RTOL = 1e-6


def nccl_events(events):
    """{kind: (count, µs)} of a trace's NCCL kernels, by the collective their
    name holds (NCCL's one-rank kernel, ``oneRankReduce``, names none)."""
    out = {}
    for start, end, name in events:
        low = name.lower()
        if "onerank" in low:
            key = "oneRankReduce"  # one rank's AVG: the mean's scaling
        elif "nccl" in low:
            key = next((c for c in ("AllReduce", "AllGather", "ReduceScatter", "Broadcast") if c in name), name[:60])
        else:
            continue
        count, total = out.get(key, (0, 0.0))
        out[key] = (count + 1, total + end - start)
    return out


def mesh_rank_main(out_path):
    """One rank launched by ``torchrun --nproc_per_node 1``: the flagship
    through the CLI with ``--mesh data=1`` (NCCL), its history and one trace
    of its replays, into ``out_path`` as JSON. The process group is made
    before the CLI, which then leaves it up for the replays traced after
    it. The rank times nothing: other processes share the card while it
    runs, so ``phase_mesh`` times the meshed step once it is alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cmf_tpu_torch.device import pin_fp32
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.ops import gram_logdet as gl
    from cmf_tpu_torch.parallel import initialize_multihost

    pin_fp32()
    assert initialize_multihost(), "the rank found no launcher environment"
    try:
        assert torch.distributed.get_backend() == "nccl"
        gl.reset_launch_counts()
        (setup,) = cli_main(MESH_ARGV + ["--mesh", "data=1"])
        torch.cuda.synchronize()
        trainer = setup["trainer"]
        launches = gl.launch_counts()
        flags = trainer.objective.for_epoch(trainer.epoch)
        x = next(iter(trainer.train_loader))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                trainer.step(x, flags)
            torch.cuda.synchronize()
        events = device_events(prof)
        result = {
            "backend": torch.distributed.get_backend(),
            "mesh": repr(trainer.mesh),
            "history": [h[1] for h in trainer.history],
            "captured": bool(trainer.captured),
            "graphs": len(captured_steps(trainer)),
            "launches": launches,
            "ops_per_replay": len(events) / 5,
            "nccl_per_replay": {k: (c / 5, us / 5) for k, (c, us) in nccl_events(events).items()},
        }
    finally:
        torch.distributed.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(result, f)


GLOO_PROBES = ("all_reduce", "all_reduce_min", "broadcast", "all_gather_into_tensor", "reduce_scatter_tensor")


def gloo_rank_main(rank, init_file, out_path):
    """One of two ranks on the one card over gloo, named explicitly: each
    collective the step or kernel 4 needs, on CUDA tensors, with its value
    checked; where gloo refuses one, what it said. No tensor is staged
    through the host."""
    import torch
    import torch.distributed as dist

    world = 2
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    result = {}
    try:
        for probe in GLOO_PROBES:
            try:
                if probe == "all_reduce":
                    t = torch.full((4,), rank + 1.0, device=dev)
                    dist.all_reduce(t)
                    ok = bool((t == 3.0).all())
                elif probe == "all_reduce_min":
                    t = torch.tensor([rank, 1], dtype=torch.int32, device=dev)
                    dist.all_reduce(t, op=dist.ReduceOp.MIN)
                    ok = t.tolist() == [0, 1]
                elif probe == "broadcast":
                    t = torch.full((4,), float(rank), device=dev)
                    dist.broadcast(t, src=0)
                    ok = bool((t == 0.0).all())
                elif probe == "all_gather_into_tensor":
                    t = torch.full((2, 3), float(rank), device=dev)
                    out = torch.empty((4, 3), device=dev)
                    dist.all_gather_into_tensor(out, t)
                    ok = out[:2].eq(0).all().item() and out[2:].eq(1).all().item()
                else:
                    t = torch.arange(4, dtype=torch.float32, device=dev).reshape(4, 1).expand(4, 3).contiguous()
                    out = torch.empty((2, 3), device=dev)
                    dist.reduce_scatter_tensor(out, t)
                    ok = bool((out[:, 0] == 2 * torch.arange(2 * rank, 2 * rank + 2, device=dev)).all())
                torch.cuda.synchronize()
                result[probe] = "ok" if ok else "wrong values"
            except (RuntimeError, ValueError, NotImplementedError) as e:
                result[probe] = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:200]}"
        step_needs = ("all_reduce", "all_reduce_min", "broadcast")
        if all(result[p] == "ok" for p in step_needs):
            result["step"] = gloo_flagship_step(rank)
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(result, f)


def gloo_flagship_step(rank):
    """One eager flagship step at data=2 over gloo on the card against one
    un-meshed eager step in the same process, from the same weights."""
    from cmf_tpu_torch.parallel import get_mesh
    from cmf_tpu_torch.training import setup_experiment

    single = fresh_setup(MESH_ARGV)
    config = single["config"]
    trainer = single["trainer"]
    flags = trainer.objective.for_epoch(1)
    x = next(iter(trainer.train_loader))
    want = float(trainer.eager_step(x, flags)[0])
    meshed = setup_experiment({**config, "max_epochs": 0}, write_to_disk=False,
                              mesh=get_mesh(data=2, device="cuda"))["trainer"]
    got = float(meshed.eager_step(x, flags)[0])
    return {"loss": got, "single_loss": want, "rel": abs(got - want) / abs(want)}


def sharded_kernel_checks(smi, spec):
    """Kernel 4 on the (1 × 1) NCCL mesh at the main shape against
    ``fused_gram_logdet`` on the same columns (values and dJ) and against
    the plain composition (the same collectives around
    ``gram_logdet_plain``), its ms with the plain composition's, its device
    ms and the collectives'. Returns the kernels line's entry."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from cmf_tpu_torch.ops import gram_logdet as gl

    d, b, big_d = MAIN_SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    j = torch.randn((d, b, big_d), device=dev, generator=gen)
    w_ld = torch.randn((b,), device=dev, generator=gen)

    def loss(g, ld):
        return (ld * w_ld).sum() + 0.3 * g.abs().sum()

    def fwd_bwd(fn):
        jr = j.clone().requires_grad_(True)
        g, ld = fn(jr)
        (dj,) = torch.autograd.grad(loss(g, ld), jr)
        return g, ld, dj

    def plain(jr):
        group = spec.mesh.group("model")
        full = torch.empty_like(jr)
        dist.all_gather_into_tensor(full, jr.detach().contiguous(), group=group)
        full.requires_grad_(True)
        g, ld, _ = gl.gram_logdet_plain(full)
        (dfull,) = torch.autograd.grad(loss(g, ld), full)
        dj = torch.empty_like(jr)
        dist.reduce_scatter_tensor(dj, dfull.contiguous(), group=group)
        return g, ld, dj

    g4, ld4, dj4 = (t.detach() for t in fwd_bwd(lambda jr: gl.fused_gram_logdet_sharded(jr, spec)))
    g1, ld1, dj1 = (t.detach() for t in fwd_bwd(gl.fused_gram_logdet))
    gp, ldp, djp = (t.detach() for t in plain(j))
    torch.cuda.synchronize()
    errs = []
    # On a (1 x 1) mesh the collectives are copies, so against rows 1-2 the
    # wrapper alone is checked; against the plain composition, the kernels
    # too.
    for what, (g, ld, dj) in (("fused_gram_logdet", (g1, ld1, dj1)), ("the plain composition", (gp, ldp, djp))):
        pairs = ((g4, g), (ld4, ld), (dj4, dj))
        e = [float((a - c).abs().max()) for a, c in pairs]
        rels = [rel_err(a, c) for a, c in pairs]
        print(f"[mesh] {smi}: kernel 4 on the (1 x 1) NCCL mesh against {what} at d,B,D={MAIN_SHAPE}: "
              f"max abs err gram {e[0]:.3e}, logdet {e[1]:.3e}, dJ {e[2]:.3e} (rel {max(rels[:2]):.3e} values, "
              f"{rels[2]:.3e} dJ; tol {FWD_TOL:g} values, {BWD_TOL:g} dJ)")
        assert max(rels[:2]) <= FWD_TOL and rels[2] <= BWD_TOL, f"kernel 4 disagrees with {what}"
        errs += e

    jr = j.clone().requires_grad_(True)

    def sharded():
        g, ld = gl.fused_gram_logdet_sharded(jr, spec)
        return torch.autograd.grad(loss(g, ld), jr)

    def rows12():
        g, ld = gl.fused_gram_logdet(jr)
        return torch.autograd.grad(loss(g, ld), jr)

    ms = cuda_ms(sharded, iters=100)
    ms_rows12 = cuda_ms(rows12, iters=100)
    plain_ms = cuda_ms(lambda: plain(j), iters=20, warmup=2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            sharded()
        torch.cuda.synchronize()
    events = device_events(prof)
    gram_us = sum(e - s for s, e, n in events if "gram_logdet" in n) / 20
    coll = {k: (c / 20, us / 20) for k, (c, us) in nccl_events(events).items()}
    # NCCL moves one rank's all-gather and reduce-scatter as device-to-device
    # copies, not kernels.
    copies = [(s, e) for s, e, n in events if "dtod" in n.lower()]
    copy_us = sum(e - s for s, e in copies) / 20
    device_ms = (sum(e - s for s, e, _ in events) / 20 / 1e3) if events else None
    # Rows 1-2's bounds plus the gathered and the scattered columns, each
    # read once and written once.
    f32 = 4
    fwd_bytes = f32 * (d * b * big_d + 2 * b * d * d + b)
    bwd_bytes = f32 * (2 * d * b * big_d + 2 * b * d * d + b)
    coll_bytes = 2 * 2 * f32 * d * b * big_d
    fwd_flops = b * (d * (d + 1) * big_d + d ** 3 / 3 + 2 * d)
    bwd_flops = b * (2 * d ** 3 / 3 + 2 * d * d * big_d + 3 * d * d)
    b_ms, b_by = bound_ms(fwd_bytes + bwd_bytes + coll_bytes, fwd_flops + bwd_flops)
    dev_txt = "not measured" if device_ms is None else f"{device_ms:.6f} ms"
    coll_txt = ", ".join(f"{k} x{c:g} {us / 1e3:.6f} ms" for k, (c, us) in coll.items()) or "no NCCL kernel"
    print(f"[mesh] {smi}: kernel 4 forward + backward (with the loss's backward) {ms:.6f} ms per call back to "
          f"back (CUDA events; rows 1-2 alone, fused_gram_logdet, {ms_rows12:.6f} ms), device {dev_txt} a call: "
          f"rows 1-2's kernels {gram_us / 1e3:.6f} ms; the collectives: {coll_txt}; device-to-device copies "
          f"x{len(copies) / 20:g} {copy_us / 1e3:.6f} ms (NCCL's one-rank all-gather and reduce-scatter); the "
          f"plain composition {plain_ms:.6f} ms; bound {b_ms:.6f} ms ({b_by}: rows 1-2's {fwd_bytes + bwd_bytes} B "
          f"+ {coll_bytes} B gathered and scattered, {fwd_flops + bwd_flops:.4g} FLOP)")
    return {"name": "fused_gram_logdet_sharded", "route": "cuda", "source": "cmf_tpu_torch/ops/gram_logdet.py",
            "replaces": "cmf_tpu/ops/pallas/gram_logdet.py:212", "launches": None, "_launches_key": "GRAM_SHARDED",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def phase_mesh(smi, counts):
    """The parallel slice on the card: the flagship through ``torchrun
    --nproc_per_node 1 -m cmf_tpu_torch --mesh data=1`` (NCCL, captured)
    against the un-meshed run of the same seed; the flagship's head under a
    (1 × 1) column partition through kernel 4 (its launches counted, added
    to ``counts``); kernel 4 alone against rows 1-2; two ranks on the one
    card over gloo. Returns kernel 4's kernels-line entry."""
    import torch
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.ops import gram_logdet as gl
    from cmf_tpu_torch.parallel import ColumnSpec, get_mesh, initialize_multihost, jacobian_column_partition

    phase_t0 = time.perf_counter()
    here = os.path.abspath(__file__)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        # The torchrun rank and the two gloo ranks start together; the
        # un-meshed run goes on here meanwhile. Nothing is timed until they
        # have exited.
        rank_out = os.path.join(tmp, "rank.json")
        gloo_outs = [os.path.join(tmp, f"gloo{r}.json") for r in range(2)]
        cmds = [[sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                 here, "--mesh-rank", rank_out]]
        cmds += [[sys.executable, here, "--gloo-rank", str(r), os.path.join(tmp, "gloo_init"), gloo_outs[r]]
                 for r in range(2)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        try:
            (single,) = cli_main(MESH_ARGV)
            torch.cuda.synchronize()
            s_trainer = single["trainer"]
            s_history = [h[1] for h in s_trainer.history]
            flags = s_trainer.objective.for_epoch(s_trainer.epoch)
            x = next(iter(s_trainer.train_loader))
            deadline = time.monotonic() + MESH_TIMEOUT_S
            outs = []
            for p in procs:
                out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
                outs.append((p.returncode, out))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(10)
        for (rc, out), what in zip(outs, ("torchrun rank", "gloo rank 0", "gloo rank 1")):
            if rc != 0:
                print(f"[mesh] the {what} failed (rc {rc}); the end of its output:\n{out[-4000:]}")
        assert all(rc == 0 for rc, _ in outs), "[mesh] a rank failed"
        with open(rank_out) as f:
            meshed = json.load(f)
        rel = max(abs(a - b) / abs(b) for a, b in zip(meshed["history"], s_history))
        print(f"[mesh] {smi}: torchrun --nproc_per_node 1 -m cmf_tpu_torch --mesh data=1: {meshed['backend']} "
              f"{meshed['mesh']}, {len(meshed['history'])} steps, losses {meshed['history'][0]:.6g} -> "
              f"{meshed['history'][-1]:.6g}; the un-meshed run's {s_history[0]:.6g} -> {s_history[-1]:.6g}; "
              f"max rel diff {rel:.3e} (tol {MESH_LOSS_RTOL:g})")
        print(f"[mesh] {smi}: captured {meshed['captured']}, {meshed['graphs']} graph(s); Gram/log-det launches "
              f"(fwd, bwd) {tuple(meshed['launches'])}")
        nccl = meshed["nccl_per_replay"]
        print(f"[mesh] {smi}: one trace of 5 replays: {meshed['ops_per_replay']:.1f} device ops a replay; NCCL "
              "kernels a replay: " + (", ".join(f"{k} x{c:g} {us / 1e3:.6f} ms" for k, (c, us) in nccl.items())
                                       or "none"))
        assert len(meshed["history"]) == len(s_history) and rel <= MESH_LOSS_RTOL, \
            "--mesh data=1 trained other losses than the un-meshed run"
        assert meshed["captured"] and meshed["graphs"] == 1, "the --mesh data=1 step was not captured"
        assert tuple(meshed["launches"]) == (len(s_history), len(s_history)), "rows 1-2 launches != steps"
        assert nccl, "no NCCL kernel ran inside the replays"

        for r, path in enumerate(gloo_outs):
            with open(path) as f:
                gloo = json.load(f)
            print(f"[mesh] {smi}: two ranks on the one card over gloo, rank {r}: " +
                  ", ".join(f"{p} {gloo[p]}" for p in GLOO_PROBES))
            assert all(gloo[p] == "ok" or gloo[p].startswith("refused") for p in GLOO_PROBES), \
                "a gloo collective gave wrong values"
            if "step" in gloo:
                s = gloo["step"]
                print(f"[mesh] {smi}: gloo rank {r}: a data=2 eager flagship step, loss {s['loss']:.8g} against "
                      f"one rank's {s['single_loss']:.8g} (rel {s['rel']:.3e}, tol {MESH_LOSS_RTOL:g})")
                assert s["rel"] <= MESH_LOSS_RTOL, "the gloo data=2 step disagrees with one rank's"
            else:
                print(f"[mesh] {smi}: gloo rank {r}: no data=2 step: gloo refused a collective the step needs")

        # The flagship's head under a (1 x 1) column partition: every step
        # through kernel 4, counted from 0 around the run.
        assert initialize_multihost(f"file://{os.path.join(tmp, 'nccl_init')}", 1, 0)
        try:
            # The captured step under --mesh data=1 against the un-meshed
            # one, timed here with every other process gone, in the order
            # un-meshed, meshed, meshed, un-meshed.
            (m_setup,) = cli_main(MESH_ARGV + ["--mesh", "data=1"])
            m_trainer = m_setup["trainer"]
            m_rel = max(abs(a - b) / abs(b) for a, b in zip([h[1] for h in m_trainer.history], s_history))
            assert m_trainer.captured and m_rel <= MESH_LOSS_RTOL, "the in-process --mesh data=1 run differs"
            step_ms = {"un-meshed": [], "meshed": []}
            for which, t in (("un-meshed", s_trainer), ("meshed", m_trainer), ("meshed", m_trainer),
                             ("un-meshed", s_trainer)):
                step_ms[which].append(cuda_ms(lambda: t.step(x, flags), iters=50, warmup=3))
            means = {k: sum(v) / len(v) for k, v in step_ms.items()}
            print(f"[mesh] {smi}: captured step, alone on the card (CUDA events, 50 back-to-back replays each, "
                  f"un-meshed, meshed, meshed, un-meshed): --mesh data=1 {means['meshed']:.4f} ms "
                  f"{[round(v, 4) for v in step_ms['meshed']]} against un-meshed {means['un-meshed']:.4f} ms "
                  f"{[round(v, 4) for v in step_ms['un-meshed']]}; difference "
                  f"{means['meshed'] - means['un-meshed']:+.4f} ms")
            del m_trainer, m_setup
            spec = ColumnSpec(get_mesh(data=1, model=1))
            gl.reset_launch_counts()
            with jacobian_column_partition(spec):
                (part,) = cli_main(MESH_ARGV + ["--mesh", "data=1"])
            torch.cuda.synchronize()
            sharded = gl.sharded_launch_counts()
            rows12 = gl.launch_counts()
            p_trainer = part["trainer"]
            p_history = [h[1] for h in p_trainer.history]
            p_rel = max(abs(a - b) / abs(b) for a, b in zip(p_history, s_history))
            print(f"[mesh] {smi}: the flagship's head under a (1 x 1) column partition: {len(p_history)} steps, "
                  f"captured {p_trainer.captured} ({len(captured_steps(p_trainer))} graph(s)); kernel 4 launches "
                  f"(fwd, bwd) {sharded}, rows 1-2 {rows12}; losses against the un-meshed run: max rel diff "
                  f"{p_rel:.3e} (tol {MESH_LOSS_RTOL:g})")
            assert p_trainer.captured and len(captured_steps(p_trainer)) == 1
            assert sharded == (len(p_history), len(p_history)) == rows12, "kernel 4 launches != steps"
            assert p_rel <= MESH_LOSS_RTOL, "the partitioned head trained other losses"
            counts["GRAM_SHARDED"] = sharded[0]
            counts["GRAM_FWD"] += rows12[0]
            counts["GRAM_BWD"] += rows12[1]
            entry = sharded_kernel_checks(smi, spec)
            del p_trainer, part
        finally:
            torch.cuda.synchronize()
            torch.distributed.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[mesh] {smi}: the phase took {time.perf_counter() - phase_t0:.2f} s")
    return entry


def _load_pt(run_dir, tag):
    import torch

    return torch.load(os.path.join(run_dir, "checkpoints", f"{tag}.pt"), weights_only=True)


def _checkpoints_equal(a, b):
    """Two checkpoints equal key for key, tensor for tensor."""
    import torch

    if a.keys() != b.keys():
        return False
    for k, v in a.items():
        if isinstance(v, dict):
            if not _checkpoints_equal(v, b[k]):
                return False
        elif isinstance(v, torch.Tensor):
            if not (v.dtype == b[k].dtype and torch.equal(v, b[k])):
                return False
        elif v != b[k]:
            return False
    return True


def phase_async_ckpt(smi, root, counts):
    """The flagship's published defaults into a run dir under each
    checkpoint backend from one seed (``orbax``: the save on a worker
    thread), then each resumed: ``latest`` and ``best_valid`` equal tensor
    for tensor after each; the blocking and the worker's ms per save; the
    Gram/log-det launches (added to the kernels line)."""
    import torch
    from cmf_tpu_torch.main import main as cli_main
    from cmf_tpu_torch.ops import gram_logdet as gl
    from cmf_tpu_torch.training.writer import wait_for_checkpoints

    phase_t0 = time.perf_counter()
    streams = sys.stdout, sys.stderr
    runs = {}
    try:
        # The main path: the counts are read right after it.
        gl.reset_launch_counts()
        for backend in ("orbax", "pickle"):
            argv = ASYNC_ARGV + ["--logdir-root", os.path.join(root, f"async-{backend}"),
                                 "--config", f"max_epochs={ASYNC_EPOCHS}", "--config", f"checkpoint_backend={backend}"]
            t0 = time.perf_counter()
            (setup,) = cli_main(argv)
            torch.cuda.synchronize()
            returned_s = time.perf_counter() - t0
            wait_for_checkpoints()
            _restore_streams(streams)
            runs[backend] = (setup, returned_s)
        fwd, bwd = gl.launch_counts()
        lik_steps = sum(1 for setup, _ in runs.values() for h in setup["trainer"].history if not h[3])
        print(f"[async-ckpt] two runs of {ASYNC_EPOCHS} epochs: Gram/log-det launches (fwd, bwd) {fwd}, {bwd}; "
              f"likelihood steps {lik_steps}")
        assert bwd == lik_steps > 0 and fwd >= bwd, "the async-ckpt runs did not go through the Gram/log-det kernels"
        counts["GRAM_FWD"] += fwd
        counts["GRAM_BWD"] += bwd

        for backend, (setup, returned_s) in runs.items():
            trainer, writer = setup["trainer"], setup["writer"]
            blocking_n, blocking_s = trainer.timings["checkpoint"]
            write_n, write_s = writer.timings["write"]
            print(f"[async-ckpt] {smi}: {backend}: {blocking_n} saves, {blocking_s / blocking_n * 1e3:.4f} ms a save "
                  f"blocking training (the copy to the host and the writer's call), {write_s / write_n * 1e3:.4f} ms "
                  f"a save writing the file ({'on the worker thread' if backend == 'orbax' else 'inside that call'}); "
                  f"the run {returned_s:.4f} s (host clock)")
            assert blocking_n == write_n > 0, f"{backend}: saves and writes differ"
            assert trainer.captured and all(math.isfinite(h[1]) for h in trainer.history)
        dirs = {b: setup["writer"].logdir for b, (setup, _) in runs.items()}
        for tag in ("latest", "best_valid"):
            same = _checkpoints_equal(_load_pt(dirs["orbax"], tag), _load_pt(dirs["pickle"], tag))
            print(f"[async-ckpt] `{tag}' of the orbax run equal to the pickle run's, tensor for tensor: {same}")
            assert same, f"`{tag}' differs between the checkpoint backends"

        # Each run dir resumed: the epochs' saves land while training goes on.
        for backend, run_dir in dirs.items():
            with open(os.path.join(run_dir, "config.json")) as f:
                config = json.load(f)
            config["max_epochs"] = ASYNC_RESUME_EPOCHS
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump(config, f)
            (resumed,) = cli_main(["--resume", run_dir])
            torch.cuda.synchronize()
            wait_for_checkpoints()
            _restore_streams(streams)
            trainer = resumed["trainer"]
            assert trainer.restored_from == "latest" and trainer.epoch == ASYNC_RESUME_EPOCHS, \
                f"{backend}: the resume did not train from `latest' to epoch {ASYNC_RESUME_EPOCHS}"
        for tag in ("latest", "best_valid"):
            latest = [_load_pt(dirs[b], tag) for b in ("orbax", "pickle")]
            same = _checkpoints_equal(*latest)
            print(f"[async-ckpt] resumed to epoch {ASYNC_RESUME_EPOCHS}: `{tag}' (epoch {latest[0]['epoch']}) of "
                  f"the orbax run equal to the pickle run's: {same}")
            assert same, f"`{tag}' differs between the checkpoint backends after the resume"
    finally:
        _restore_streams(streams)
    print(f"[async-ckpt] {smi}: the phase took {time.perf_counter() - phase_t0:.2f} s")


def phase_cif_u(smi, counts):
    """An image CIF whose checkerboard couplings carry a u-channel, with a
    ``sigmoid`` layer, at mnist's shape and widths: CIF_U_STEPS steps on the
    card, each against the same step on the CPU from the same weights and
    draws; then ``sample(250)`` through the
    coupler kernel, each call's input the passthrough and u channels, every
    call held against the kernel's plain version; the samples against the
    conv route; the kernel's ms at the widened input. Adds its coupler
    launches to the kernels line."""
    import torch
    from cmf_tpu_torch.densities import DiagonalGaussianDensity
    from cmf_tpu_torch.models import get_density
    from cmf_tpu_torch.nets import core as nets_core
    from cmf_tpu_torch.ops import coupler_stack as cs
    from cmf_tpu_torch.training import make_optimizer
    from cmf_tpu_torch.training.objectives import SquareObjective

    phase_t0 = time.perf_counter()
    schema = cif_u_schema()
    shape = (1, 28, 28)
    card = get_density(schema, x_shape=shape, device="cuda", generator=torch.Generator().manual_seed(0))
    flags = SquareObjective().for_epoch(1)
    opt = make_optimizer({"lr": CIF_U_LR}, card.parameters())
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randint(0, 256, (CIF_U_BATCH, *shape), generator=torch.Generator().manual_seed(4)).float().cuda()
    for step in range(1, CIF_U_STEPS + 1):
        # Each step from the card's weights on both sides, then the card's
        # Adam step on the gradients card_vs_cpu leaves on its model.
        draws = image_square_draws(card, x, gen, CIF_U_CHANNELS)
        card_vs_cpu({"density": card, "schema": schema}, x, flags, f"cif-u step {step}", STEP_LOSS_TOL,
                    STEP_GRAD_TOL, **draws)
        opt.step()

    # The main path: sample(250), each kernel call's input recorded.
    calls, fused = [], nets_core.fused_resnet_coupler

    def recorded(xx, params, bf16=False):
        calls.append((xx.clone(), params))
        return fused(xx, params, bf16)

    nets_core.fused_resnet_coupler = recorded
    try:
        cs.reset_launch_counts()
        samples = card.sample(MNIST_SAMPLE_BATCH, generator=gen)
        torch.cuda.synchronize()
        launches = cs.LAUNCHES
    finally:
        nets_core.fused_resnet_coupler = fused
    c_in = [c[0].shape[1] for c in calls]
    print(f"[cif-u] sample({MNIST_SAMPLE_BATCH}) {tuple(samples.shape)}: coupler kernel launches {launches}, "
          f"the calls' C_in {c_in}")
    assert launches == len(calls) == 2 * CIF_U_LAYERS, "sample(): coupler launches != 2 a CIF layer"
    assert c_in[1::2] == list(reversed(CIF_U_C_IN)), "the couplings' kernel input is not passthrough + u"
    assert tuple(samples.shape) == (MNIST_SAMPLE_BATCH, *shape) and bool(torch.isfinite(samples).all())
    counts["COUPLER_LAUNCHES"] += launches
    with torch.no_grad():
        for xx, params in calls:
            got = cs.coupler_stack_cuda(xx, params)
            ref = cs.coupler_stack_plain(xx, params)
            err = float((got - ref).abs().max()) / float(ref.abs().max())
            print(f"[cif-u] coupler_stack B={xx.shape[0]} {xx.shape[1]}->{got.shape[1]} "
                  f"{xx.shape[2]}x{xx.shape[3]} hidden {params['conv_in']['w'].shape[0]} blocks "
                  f"{len(params['blocks'])}: max err / max |ref| {err:.3e} (tol {COUPLER_TOL:g})")
            assert err <= COUPLER_TOL and bool(torch.isfinite(got).all()), \
                "the coupler kernel disagrees with its plain version on the CIF's input"

    z_shape = next(m for m in card.modules() if type(m) is DiagonalGaussianDensity).shape
    noise = torch.randn((MNIST_SAMPLE_BATCH, *z_shape), generator=gen, device="cuda")
    got = card.fixed_sample(noise)
    with torch.no_grad():
        ref = card._fixed_sample(noise)
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    print(f"[cif-u] fixed_sample through the kernel vs the conv route, same noise: max err / max |ref| "
          f"{err:.3e} (tol {SAMPLE_TOL:g})")
    assert err <= SAMPLE_TOL, "cif-u samples through the coupler kernel disagree with the conv route"

    # The kernel at the first coupling's widened input.
    xx, params = next((c for c in calls if c[0].shape[1] == CIF_U_C_IN[0] and len(c[1]["blocks"]) == 8))
    with torch.no_grad():
        ms = cuda_ms(lambda: cs.coupler_stack_cuda(xx, params), iters=20, warmup=3)
        device_ms = profiled_device_ms(lambda: cs.coupler_stack_cuda(xx, params), "coupler_stack_kernel", iters=10)
        plain_ms = cuda_ms(lambda: cs.coupler_stack_plain(xx, params), iters=5, warmup=1)
    b, ci, h, w = xx.shape
    hidden, c_out = params["conv_in"]["w"].shape[0], params["conv_out"]["w"].shape[0]
    n_weights = sum(t.numel() for t in cs._param_tensors(params))
    n_bytes = 4 * (xx.numel() + n_weights + b * c_out * h * w)
    n_flops = cs.flops(b, ci, hidden, c_out, 8, h, w)
    n_tc = cs.tensor_core_flops(b, hidden, 8, h, w)
    b_ms, b_by = bound_ms(n_bytes, n_flops - n_tc, 3 * n_tc)
    dev_txt = "not measured" if device_ms is None else f"{device_ms:.6f} ms"
    print(f"[cif-u] {smi}: coupler_stack B={b} {ci}->{c_out} {h}x{w} (C_in = passthrough + u): {ms:.6f} ms a "
          f"call back to back, kernel device time {dev_txt}, plain {plain_ms:.6f} ms; bound {b_ms:.6f} ms "
          f"({b_by}, 3xTF32)")
    print(f"[cif-u] {smi}: the phase took {time.perf_counter() - phase_t0:.2f} s")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[timing] {name}: {time.perf_counter() - t0:.2f} s (the smoke so far "
              f"{time.perf_counter() - t_start:.2f} s)", flush=True)
        return out

    name, smi = timed("device", phase_device)
    timed("build", phase_build)
    kernels = timed("kernels", phase_kernels) + [timed("coupler", phase_coupler_kernel),
                                                 timed("coupler-bf16", phase_coupler_kernel_bf16)]
    timed("kernels-small", phase_kernels_small)
    counts, step_ms = timed("train", phase_train)
    timed("captured", phase_captured, step_ms)
    timed("warmup", phase_warmup)
    runs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs")
    os.makedirs(runs, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_", dir=runs)
    try:
        default_run_dir = timed("default", phase_default, smi, root)
        timed("default-sphere", phase_default_sphere, smi)
        timed("cmf-battery", phase_cmf_battery, smi)
        setup = timed("train-mnist", phase_train_mnist)
        timed("sample", phase_sample, setup)
        timed("inception", phase_inception, smi)
        mnist_setup, coupler_launches = timed("default-mnist", phase_default_mnist, smi)
        counts["COUPLER_LAUNCHES"] = coupler_launches
        timed("ood", phase_ood, mnist_setup, smi)
        timed("metric-mnist", phase_metric_mnist, setup, default_run_dir, root, smi)
        timed("mflow", phase_mflow, smi, root)
        timed("square-cif", phase_square_cif, smi, root)
        timed("image-square", phase_image_square, smi, root)
        timed("square-2d", phase_square_2d, smi, root)
        timed("hutch-gram", phase_hutch_gram, smi, root, step_ms)
        timed("batchnorm", phase_batchnorm, smi, root)
        timed("tabular-table", phase_tabular_table, smi, root, counts)
        timed("nonsquare-bn", phase_nonsquare_bn, smi, root, counts)
        timed("bf16-flagship", phase_bf16_flagship, smi, counts, step_ms)
        timed("bf16-mnist", phase_bf16_mnist, smi, setup, counts)
        timed("conv-gram", phase_conv_gram, smi)
        kernels.append(timed("mesh", phase_mesh, smi, counts))
        timed("async-ckpt", phase_async_ckpt, smi, root, counts)
        timed("cif-u", phase_cif_u, smi, counts)
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
    # The [mesh] phase's own ranks: one under torchrun, two over gloo.
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank_main(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--gloo-rank"]:
        gloo_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    sys.exit(main())
