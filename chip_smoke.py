#!/usr/bin/env python3
"""Serve and train the flagship Ref-NeRF model through the PyTorch port on one GPU.

Run from the root of the repository, with no arguments, on a machine with an
NVIDIA H100 (sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels of refnerf_tpu_torch/csrc with nvcc; print each
     kernel's registers and spills, and check that every kernel of the
     bf16 width-256 forward and backward (csrc/trunk_fwd_tma.cu,
     csrc/trunk_bwd_tma.cu) holds wgmma (HGMMA) and TMA loads (UTMALDG) and
     no mma.sync (HMMA) in its SASS, and that every kernel of the f32
     width-256 forward and backward (csrc/trunk_fwd_f32.cu,
     csrc/trunk_bwd_f32.cu) holds FFMA and UTMALDG and no tensor-core
     product (HMMA, HGMMA: no TF32); of the width-1024 library
     (csrc/trunk_w1024.cu), each product, bf16 and f32 (three TF32
     passes), HGMMA and UTMALDG and no HMMA, and no FMA product left; of
     the depth-1 directional library (csrc/trunk_dir1.cu), its four
     kernels (bf16 and f32, forward and backward) HGMMA and UTMALDG and no
     HMMA;
  3. hold each trunk kernel (K1 spatial, K2 directional) against its plain
     PyTorch version at the serving shape N = 4096 rays x 128 samples, in
     float32 and bfloat16, and time both (the wgmma/TMA forward in bf16, the
     FMA/TMA forward in f32: each case asserts its route); and the bf16
     directional trunk at 288 input columns, past that kernel's shapes, on
     trunk_fwd.cu's instance;
  4. build the model of configs/blender_refnerf.gin at full width (bf16
     trunks, weights from a seeded torch.Generator) and answer three
     requests: 4096 rays, 5000 rays (two chunks) and a 64x64 pinhole image;
     check every output and that each kernel ran levels x chunks times;
     answer the first request again with fused_trunk='off' and compare;
  5. hold each training kernel against its plain PyTorch version at the same
     N, in float32 and bfloat16, and time both: K3 (the forward with the
     density gradient) on every output and u, K4 (the spatial backward) on
     every weight and bias gradient given random cotangents of sigma, the
     heads, the bottleneck and u, K5 (the directional backward) on every
     parameter gradient and both segment cotangents (f32 K3 on
     csrc/trunk_fwd_f32.cu, f32 K4 and K5 on csrc/trunk_bwd_f32.cu); K3, K4
     and K5 in bf16, and K4 and K5 in f32, run twice more and must give
     bit-identical outputs;
  6. train the flagship at batch 4096 with bf16 trunks as bench.py drives the
     JAX step (3 warm-up steps, then 10 timed ones); check every loss term is
     finite, the parameters moved, and K2-K5 each ran levels x steps times;
     take one more step's gradients with fused_trunk='off' from the same
     state and compare the loss and the global gradient norm;
  7. hold the fused directional stages against their plain versions at the
     same N, in float32 and bfloat16, forward and backward, and time both:
     K8 (the IDE in the directional trunk), K8+K9 (with the direction
     geometry), K10 (the colour epilogue) and all three (each forward's
     route asserted);
  8. the flagship with NerfMLP.fuse_dir_enc, fuse_dir_geo and fuse_dir_rgb:
     three served requests and 10 train steps through the kernels (K8-K10
     each counted levels times per request, twice that per step), each
     against fused_trunk='off'; a 4096-ray request and a train step timed in
     turns against the same model unfused (phases 4 and 6), and one of each
     under torch.profiler (device busy share, device time by kernel);
  9. hold the fused spatial stages against their plain versions at the
     same N, in float32 and bfloat16, and time both: K7 (the IPE made in
     the kernel) on K1 and on K3, K6 (the compositing weights) on K3, and
     K6+K7 on K1 (the served launch), on K3 and on K4 (the backward, with
     d bsig), and on mip-NeRF's spatial trunk (hf = 0: served, and trained
     in first-order K4); the weights within an absolute bound that two
     faults of the scan (inclusive, no density bias) would exceed (each
     forward's route asserted); the forwards of K8+K9+K10 (phase 7) and
     K6+K7+K3 (phase 9), in both dtypes, run twice more and must give
     bit-identical outputs;
 10. the flagship with all six fuse flags (phase 8's and
     NerfMLP.fuse_ipe_trig, fuse_compositing, fuse_lift): three served
     requests and 10 train steps through the kernels (K6 and K7 each
     counted levels x chunks per request, twice that per step), each
     against fused_trunk='off'; a 4096-ray request and a train step timed
     in turns against phase 8's model, and one of each profiled (phase 8
     profiles phase 8's model);
 11. hold mip-NeRF's kernels against their plain versions at the same N, in
     float32 and bfloat16, and time both: K11 (the spatial trunk with its
     features y out) forward and backward (the cotangent of y in), K2 and
     K5 at width 128 on segments (128, 33), K1 with the bottleneck head
     alone (hf = 0) and the first-order K4 (no cotangent of u); K11's y
     within a relative L2 bound that two faults of its store (the last
     bias dropped, y before the last ReLU) would exceed; each route
     asserted (K2 and K5 at width 128 on the two-tile instances of
     csrc/trunk_fwd_tma.cu and csrc/trunk_fwd_f32.cu, csrc/trunk_bwd_tma.cu
     and csrc/trunk_bwd_f32.cu; K11's forward on csrc/trunk_fwd_tma.cu in
     bf16, csrc/trunk_fwd.cu in f32), and K2 and K5 at width 128 in both
     dtypes and K11's bf16 forward run twice more, bit-identical;
 12. configs/blender_mipnerf.gin at full width (bf16 trunks), as shipped and
     with Model.use_viewdirs = False: each answers three requests and takes
     10 train steps through the kernels (K1, K2 and K4, K5 at width 128; or
     K1 with K11 and K4 with K11), each against fused_trunk='off', and one
     request and one step of each profiled (as shipped, K5 at width 128 on
     trunk_bwd_tma.cu; the forwards on trunk_fwd_tma.cu and no bf16
     instance of trunk_fwd.cu: read from the profiles);
 13. the flagship gin in its own float32 (no compute_dtype binding) with all
     six fuse flags, trained at batch 4096 as phase 10 (3 warm-up steps, 10
     timed ones; K2-K10 counted, the forwards on csrc/trunk_fwd_f32.cu and
     the backwards on csrc/trunk_bwd_f32.cu, read from the profile), one
     more step against fused_trunk='off', and one step profiled;
 14. the same model serving: three requests (4096 rays, 5000 rays, a 64x64
     image) through the kernels (K1, K2, K6-K10 counted, the forwards on
     csrc/trunk_fwd_f32.cu), the first against fused_trunk='off'; the
     latency of 30 4096-ray requests (median, p90) and one request
     profiled (device busy share, device time by kernel);
 15. configs/blender_mipnerf.gin as shipped, in its own float32 (no
     compute_dtype binding), trained at batch 4096 as phase 12 (3 warm-up
     steps, 10 timed ones; K1 hf=0, K2 and K5 at width 128 and the
     first-order K4 counted; K5 at width 128 on csrc/trunk_bwd_f32.cu and
     the forwards on csrc/trunk_fwd_f32.cu, no f32 instance of
     csrc/trunk_fwd.cu, read from the profile), one more step against
     fused_trunk='off', and one step profiled; then serving as phase 14:
     three requests (K1, K2 counted), the first against fused_trunk='off',
     the latency of 30 4096-ray requests (median, p90) and one request
     profiled;
 16. the flagship trained and evaluated from a scene on disk: print which of
     Pillow, scipy and matplotlib import; write a Blender-format scene of
     tools/make_sphere_scene.py's sphere (20 train and 4 test views at
     800 x 800, the nerf_synthetic resolution) with the port's own PNG
     writer into a temporary directory; time reading a view (through
     Pillow where it imports) and the port's PNG codec on it (filter 0, and
     every row Average or Paeth); load the scene through
     datasets.load_dataset (configs/blender_refnerf.gin with bench.py's
     bindings and all six fuse flags; the gin's batching 'single_image',
     rays cast in the train step); one batch of Pixels cast on the card
     against the CPU cast; 3 warm-up and 10 timed bf16 steps from
     prefetched batches (training_batches as shipped: sampled on the step's
     thread, copied by device_prefetch; K2-K10 counted), then steps from
     disk in turns against the same with a sampler thread, one batch of
     Pixels kept on the card and one batch of random rays (phase 10's), the
     sampler's host ms a batch, 5 steps profiled, one step against
     fused_trunk='off', and prefetched batches against the same batches
     copied synchronously (every tensor and the loss bit for bit); a test
     view rendered in bf16 with the extras (against fused_trunk='off'),
     PSNR, SSIM and cc-PSNR on the card against the CPU; the same in the
     gin's own float32 (3 + 5 steps, one view);
 17. the port's CLIs on configs/blender_refnerf.gin as shipped (its own
     float32, batch 1024, no fuse flags, fused_trunk='auto'): print which of
     tensorboardX, torch.utils.tensorboard, ffmpeg and cv2 are here; write
     the sphere scene at 50 train and 2 test views of 400 x 400; the train
     CLI (refnerf_tpu_torch.cli.train main, in this process) for 10 steps,
     validating and checkpointing every 5 (K1-K5 counted: K3, K4, K5 and
     K2 in every step, K1 and K2 in the validation views; every forward on
     csrc/trunk_fwd_f32.cu and every backward on csrc/trunk_bwd_f32.cu;
     the saves timed); a run killed at step 5 (early exit) and resumed to
     10, every parameter and Adam moment equal to the first run's; the
     eval CLI as a subprocess (metric files, finite PSNR), its view 0
     against the same view rendered here with fused_trunk='off'; the
     render CLI twice (2 frames and the videos, then frame 0 skipped).
 18. the LLFF geometry gins from a forward-facing scene on disk: write the
     specular sphere seen by 20 cameras (nerf_llff_data's fern has 20
     views) with images_4/ at 1008 x 756 (a 4032 x 3024 capture at the
     gin's factor 4); (b) configs/llff_refnerf_geometry_losses.gin as
     shipped (float32, batch 1024, NDC, all_images, no fuse flags,
     fused_trunk='auto', NerfMLP.srgb_mapping = False) from a state at
     step 150,000 (past the consistency warmup): 3 warm-up and 10 timed
     steps from prefetched batches, rays cast in the step, each with the
     noisy second forward on 128 rays x 4 angles (K2-K5 each counted 4
     times a step: 2 levels x 2 forwards; every forward on
     csrc/trunk_fwd_f32.cu and every backward on csrc/trunk_bwd_f32.cu);
     all nine loss terms finite and the four consistency terms nonzero;
     one step against fused_trunk='off' (loss, gradient norm, each term;
     the consistency terms within testing/consistency.py's bound of the
     render gap), three planted faults above those bounds (the rotated
     copies grouped angle-major, the specular negation dropped, a ratio of
     1 at step 0) and the consistency terms exactly 0 at step 0; one step
     profiled; the step's share of time in the noisy forward (steps with
     and without it, in turns); (c) the same gin in bf16 with all six fuse
     flags and fused_trunk='on' (K3+K6+K7, K4, K2+K8+K9 and K5 counted,
     K10 at 0: inactive without the sRGB mapping; on the wgmma/TMA
     libraries), one step against 'off' as in (b); (d) the few-shot gin
     (n_input_views = 3) loads 3 train views and takes 3 steps.
 19. configs/blender_refnerf.gin over mip-NeRF 360's proposal cascade
     (CASCADE: 3 levels x 64, 64, 32 samples, weight dilation, annealing,
     single-jitter stratified sampling, Config.randomized, the interlevel
     and distortion losses; a separate PropMLP of 4 x 256, density only,
     on 504 IPE columns): (a) its trunk at the same N against its plain
     versions, forward and backward, each run twice more bit-identical: in
     f32 on the head-0 instances of csrc/trunk_wide_tf32.cu and
     csrc/trunk_wide_bwd_tf32.cu (three TF32 passes of wgmma; bounds of
     three TF32 products, the FMA pipes' beside them; also at
     REDESIGNED_ROWS, and timed in turns with the FMA instances of
     csrc/trunk_fwd_f32.cu and csrc/trunk_bwd_f32.cu that ran them before,
     the routes forced; three planted faults of the design above the
     bounds), in bf16 on the wide-input instances of csrc/trunk_fwd_tma.cu
     and csrc/trunk_bwd_tma.cu (depth 4 and 8, each route asserted; at
     depth 4 the PyTorch chain timed as the yardstick); in bf16
     planted faults of the input fill read above the bounds, and at depth
     4 the design the bf16 pair replaced (csrc/trunk_fwd.cu and
     csrc/trunk_bwd.cu, the routes forced) is held against the same plain
     versions and timed ('was'); (b) from a Blender sphere
     scene (20 + 2 views of 400 x 400), in f32 under fused_trunk='on' at
     the gin's batch of 1024: 3 warm-up and 10 timed steps (the PropMLP's
     pair 2 a step, counted under 'K1 wide' / 'K4 wide', K2-K5 the NeRF
     level's; the PropMLP's forward on trunk_wide_tf32.cu and backward on
     trunk_wide_bwd_tf32.cu, the NeRF level's on trunk_fwd_f32.cu and
     trunk_bwd_f32.cu), one step against 'off' with the same draws (loss,
     gradient norm, each term), one step profiled, a 4096-ray request
     against 'off'; (c) the same in bf16 with all six fuse flags at batch
     4096 (K6/K7 on 32-sample rays; the PropMLP on the wide-input
     instances of trunk_fwd_tma.cu / trunk_bwd_tma.cu, and no kernel of
     trunk_fwd.cu / trunk_bwd.cu in its profiles); (d) the draws on the
     card repeat for one (seed, step) and differ for the next; NeRFSystem
     killed at step 2 and resumed to 4 equals the uninterrupted run under
     torch.equal (randomized, with density and bottleneck noise and random
     backgrounds); 3 steps of (c)
     with NerfMLP.density_noise = 1.0, bottleneck_noise = 0.1 and
     Model.bg_intensity_range = (0, 1): finite, K6 logged inactive.
 20. the mesh tools and interop on the flagship at full width, in float32
     and bfloat16 under fused_trunk='on' (refnerf_tpu_torch/geometry.py,
     interop.py): the density grid at 96^3 (14 launches of K1 at up to
     65,536 points, without the bottleneck head) and the vertex colours of its
     mesh (K1 with the heads of a request), timed, every launch's route
     asserted and counted; marching tetrahedra on the host at the grid's
     midpoint (random weights: JAX's isovalue for an untrained field),
     timed; against fused_trunk='off', each by its L2 error over the plain
     field's spread about its mean (`spread_l2`; random weights leave the
     density within 0.96..0.99, so a flat field reads 1) within
     KERNEL_BOUND: the grid, the diffuse head at the plain mesh's first
     65,536 vertices and the colours of the plain mesh; two planted faults
     (the plain output's mean everywhere; the lifted means' x column
     zeroed) read above the bound in both shapes; the meshes' vertex
     counts (equal, faces too, where no lattice value crosses the isovalue
     between the grids; any that does lies within the bound times the
     spread of it); the PLY written and read back; the model exported to a
     refnerf-pl .ckpt, imported into a model of another seed, and a
     4096-ray request from both equal bit for bit;
 21. serving from a weight-embedded artifact (refnerf_tpu_torch/serving.py):
     the flagship in bf16 with all six fuse flags exported under
     fused_trunk='on' at chunk 4096 (seconds and bytes), its graph holding
     the trunk operator twice for each trunk (K1, K2: 2 levels) on
     trunk_fwd_tma.cu; loaded in a fresh process that imports torch and
     the port alone (load seconds, the libraries already built) and
     serving 4096 rays that launch K1, K2 and K6-K10 twice each; its rgb,
     acc and distance against the in-process fused_trunk='off' render
     within SERVE_BOUND of the plain render's spread (spread_l2), and, an
     extra check, bit for bit the in-process kernel render; planted faults
     read above both bounds (the spatial trunk's skip columns dropped
     from the artifact's frozen pack, the rays' fields out of order, the
     bottleneck head zeroed); the median and p90
     of REQUESTS 4096-ray requests of the loaded artifact, the in-process
     kernel path and the fused_trunk='off' artifact, in turns; the same
     for configs/blender_mipnerf.gin as shipped (float32: K1 with the
     bottleneck head alone and K2 at width 128 on trunk_fwd_f32.cu); one
     /render POST of 4096 rays to tools/serve_http.py on 127.0.0.1 equal
     to the direct call (round trips timed); tools/bench_render.py and
     tools/profile_step.py for a few frames and steps, their lines printed.
 22. data parallelism (refnerf_tpu_torch/parallel/): the flagship of
     phase 10 (bf16, six flags, global batch 4096) trained 3 steps in one
     process and on 2 ranks sharing the card over gloo (2,048 rays a rank;
     torchrun running refnerf_tpu_torch/testing/data_parallel.py): per
     step the losses, the reduced gradients before the clip (relative L2)
     and the parameters against one process within DP_*_BOUND; every
     rank's parameters bit-identical after every step; each rank launching
     K2-K10 as phase 10 counts them; three planted faults above the bounds
     (one rank skips the reduction; both ranks take the same half; the
     masked means of the LLFF geometry gin of phase 18, at step 150,000
     and its acc thresholds where the ranks' masks hold different counts
     (testing/data_parallel.threshold_bindings), reduced as a mean of
     per-rank ratios); NeRFSystem trained on 2 ranks, and a test view split
     across the ranks equal to one rank's render; the train CLI under
     torchrun on 2 ranks from a Blender scene on disk (phase 19's 20 + 2
     views at 400 x 400; no validation views), killed at step 2 and resumed
     to 4, its checkpoint equal to NeRFSystem's two-rank run; the CLI with NCCL at
     one rank (at two only where there are two cards; else printed why
     not); ms a step of the shared-card run beside one process's (no
     scaling figure);
 23. Model.remat: the flagship of phase 10 and phase 19's bf16 cascade at
     batch 4096, 3 steps with and without remat: bit for bit the same,
     every forward launch run once more a step (the launches of one train
     forward alone, added), the peak memory allocated and ms a step of
     each (the median of the steps after a warm first one);
 24. mip-NeRF 360's published model (MIPNERF360,
     refnerf_tpu_torch/testing/mipnerf360.py) at full width: its NeRF
     trunk's width-1024 pair (trunk_w1024.cu) against the plain versions at
     131,072 and 524,288 rows in bf16 and f32 (routes asserted, reruns
     bit-identical, two planted faults above the bounds; its SASS checked in
     phase 2; the f32 pair's bound that of three TF32 products), with the
     PyTorch chain of the same function timed in turns as its yardstick
     (`w1024_chain`: the kernels line's library_ms), its 283-column
     directional pair (csrc/trunk_dir1.cu) against the plain versions at
     the same rows in both dtypes (routes asserted, reruns bit-identical,
     two planted faults above the bounds: the 27-column segment dropped,
     one tile's rows missing from dW1; its chain timed likewise); then 3
     steps at batch
     16,384 in each dtype under 'on' (launches a step asserted, median ms,
     peak memory; the f32 PropMLP on the TF32 libraries), one step against
     'off', a step profiled, 'on' and
     'off' in turns, and a 4096-ray request against 'off' (spread_l2 within
     M360_SERVE_BOUND, a planted fault of the served model above it; one
     profiled).
 25. The JAX package's default Model (DEFAULTS,
     refnerf_tpu_torch/testing/mlp_defaults.py: 3 levels on two MLPs of 8 x
     256 on 504 IPE columns with the 256-wide bottleneck and density
     normals) at full width: its spatial trunk on the wide-input instances
     against the plain versions at 524,288 rows in bf16 and f32, K1, K3 (the
     density gradient), K4 first-order and with u's cotangent, and the
     128-wide head's K1 and first-order K4 (routes asserted, reruns
     bit-identical; the bf16 128-wide head also on trunk_fwd.cu /
     trunk_bwd.cu, which ran it before; the PyTorch chain where no density
     gradient; three planted faults of the chunked contract above the
     bounds); then 2 steps at batch 16,384 in each dtype under 'on'
     (launches a step asserted, median ms, peak memory), one step against
     'off' at the largest batch its double backward holds, a step profiled,
     a 4096-ray request against 'off' (SERVE_BOUND, the skip input dropped
     from the served packs above it; one profiled), DEFAULTS_NORMALS
     trained likewise, and a step and a request of two variants (no density
     normals; a 128-wide bottleneck) counted.
The line before the last is a JSON list of the kernels, each with its
launches on the main path (phases 4, 6, 8, 10, 12, 13, 14, 15, 16, 17,
18, 19, 20, 21, 22, 23, 24 and 25),
its time and its plain version's at N, and its bound: the larger of the
bytes it must move (each input read once, each output written once) at 3.35
TB/s and its operations at the card's peak for their type (989 TFLOP/s bf16 tensor, 67 TFLOP/s f32;
the fused stages' f32 work overlaps bf16 tensor work; the f32 width-1024
pair's as three TF32 products at 495 TFLOP/s, the FMA bound beside it);
its library_ms is null but for phase 19's, 24's and 25's rows (their
PyTorch chains; none with the density gradient). The
line before it gives each phase's seconds.
The last line is {"ok": true, "device": {...}}. Any failure raises: the exit
code is not 0 and no result line is printed.
"""

import concurrent.futures
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

N_SAMPLES = 4096 * 128  # one chunk of rays x samples per level
SEED = 0
# Kernel vs plain version, values of the trunk (sigma, the heads, the
# bottleneck, rgb): max |kernel - plain| <= bound * max(1, max|plain|).
# f32: the same f32 arithmetic summed in another order. bf16: both round
# every layer's f32 sum to bf16, and a sum on a rounding boundary flips one
# bf16 ulp (2^-8 relative) that later layers carry along.
KERNEL_BOUND = {'float32': 1e-4, 'bfloat16': 5e-2}
# Derivatives (u, every parameter gradient, dx): relative L2 error
# |kernel - plain|_2 / |plain|_2 <= bound, with the max error relative to
# max|plain| printed beside it. A derivative of a ReLU trunk jumps where a
# pre-activation crosses 0: relu' is 1 on one side and 0 on the other. At
# N = 524,288 samples (2,048 units each) some pre-activations lie within
# the summation-order noise of 0, in f32 too, so the two sides disagree on a
# few masks. Each flip moves that one sample's u or dx by ~1/sqrt(active
# units), about 10%, so the max error says only that a flip happened; the
# L2 error weighs the flips by how rare they are. bf16: both sides also
# round the cotangents (g, zeta, q, p) to bf16 at the same places.
GRAD_BOUND = {'float32': 5e-3, 'bfloat16': 5e-2}
# K6's compositing weights (f32 in either dtype, each below 1 and a ray's
# summing to at most 1): max |kernel - plain|, absolute. They move with the
# raw density, so by 1e-7 in f32 and, where a bf16 flip moves it, by a few
# 1e-4 in bf16. Phase 9 also reads two faults on the plain weights (an
# inclusive scan, a dropped density bias) and fails unless both lie above
# this bound.
WEIGHT_BOUND = {'float32': 1e-5, 'bfloat16': 5e-3}
# K11's trunk features y [N, 256] in the compute dtype: relative L2 error,
# as the derivatives. A rounding flip moves one of 134M values by a bf16
# ulp; a fault of the store moves all of them. Phase 11 also reads two
# faults on the plain y (the last bias dropped, y before the last ReLU) and
# fails unless both lie above this bound.
Y_BOUND = {'float32': 1e-5, 'bfloat16': 1e-2}
SCALES = 2.0**np.arange(0, 16)  # the flagship's IPE degrees (max_deg_point 16)
# The train step (phase 6), as bench.py times it.
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 4096, 3, 10
# One step's loss and global gradient norm through the kernels vs
# fused_trunk='off' from the same state, relative, bf16 trunks on both
# sides: they differ by the summation order of the products and the rare
# bf16 ulp (2^-8) it flips, which the served rgb showed at ~1e-5.
TRAIN_LOSS_BOUND, TRAIN_GNORM_BOUND = 1e-3, 1e-2
# Served rgb of the kernel path vs fused_trunk='off' (both bf16 trunks).
PATH_BOUND = 2e-2
# The flags of the fused directional stage (K8-K10), phase 8, and of the
# fused spatial stage (K6, K7 and the closed-form lift), phase 10.
FUSE = ['NerfMLP.fuse_dir_enc = True', 'NerfMLP.fuse_dir_geo = True',
        'NerfMLP.fuse_dir_rgb = True']
SPATIAL = ['NerfMLP.fuse_ipe_trig = True', 'NerfMLP.fuse_compositing = True',
           'NerfMLP.fuse_lift = True']
SAMPLES = 128  # a ray's samples at every level of the flagship
# Peak rates of one H100 SXM (dense) and its memory rate, for the bounds;
# 'tf32' the tensor cores' TF32 rate, which the f32 width-1024 products run
# three passes at.
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12, 'tf32': 495e12}
MEM_RATE = 3.35e12
CARD = ''  # nvidia-smi's name and power limit, set in main()
START = time.perf_counter()  # the script's start, for its phases' seconds


def log(msg):
  print(msg, flush=True)


def cuda_ms(fn, iters=5):
  """Mean device time of fn() over iters launches, after one warm-up."""
  fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


# The trunks of the kernel cases, 8 layers with the skip at layer 5:
# (segment widths, width, f32 head outputs, compute-dtype head outputs,
# density head). 'K1' and 'K2' are the flagship's spatial and directional
# trunks; 'mip K1' is mip-NeRF's spatial trunk with its bottleneck and no
# f32 head (hf = 0), 'mip K11' the same without the bottleneck (y out), and
# 'mip K2' its directional trunk on [bottleneck 128 | positional encoding
# 33]. 'K2 kin 288' is the directional trunk on 288 input columns, past
# the wgmma/TMA forward's input tile (trunk_fwd.cu's bf16 instance runs it).
TRUNKS = {'K1': ((48, 48), 256, 10, 128, True),
          'K2': ((128, 73), 256, 3, 0, False),
          'K2 kin 288': ((128, 160), 256, 3, 0, False),
          'mip K1': ((48, 48), 256, 0, 128, True),
          'mip K11': ((48, 48), 256, 0, 0, True),
          'mip K2': ((128, 33), 128, 3, 0, False)}


def trunk_case(which, gen, dev, ipe=False):
  """TRUNKS[which]'s weights (He-scaled so activations stay O(1)) and
  segments of N_SAMPLES rows in [-1, 1]. With `ipe` the (48, 48) segments
  are the IPE encoding of random lifted means and variances; a 33-wide
  segment is the positional encoding (deg_view 5) of random unit
  directions."""
  seg_dims, width, hf, hc, density = TRUNKS[which]
  fin = sum(seg_dims)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  ws, bs = [], []
  for l in range(8):
    k_in = fin if l == 0 else width + (fin if l == 5 else 0)
    ws.append(rand(width, k_in) * math.sqrt(2 / k_in))
    bs.append(rand(width) * 0.05)
  head = lambda k: (rand(k, width) / math.sqrt(width), rand(k) * 0.1)
  kw = dict(skip_period=4,
            wd=rand(1, width) / math.sqrt(width) if density else None,
            head_f32=head(hf) if hf else None,
            head_cdt=head(hc) if hc else None)
  uniform = lambda d: torch.rand(N_SAMPLES, d, generator=gen).to(dev) * 2 - 1
  if ipe:
    from refnerf_tpu_torch.ops import fused_mlp
    lm = torch.rand(N_SAMPLES, 3, generator=gen).to(dev) * 3 - 1.5
    lv = 10.0**(torch.rand(N_SAMPLES, 3, generator=gen).to(dev) * 4 - 6)
    segs = list(fused_mlp.encode_ipe(lm, lv, SCALES))
  elif seg_dims[-1] == 33:
    from refnerf_tpu_torch.ops import coord
    d = rand(N_SAMPLES, 3)
    segs = [uniform(seg_dims[0]),
            coord.pos_enc(d / d.norm(dim=-1, keepdim=True), 0, 5)]
  else:
    segs = [uniform(d) for d in seg_dims]
  return segs, ws, bs, kw


def flatten(outs):
  """The tensors of a nested list/tuple of outputs, Nones dropped."""
  flat = []
  for o in outs:
    if isinstance(o, (list, tuple)):
      flat += flatten(o)
    elif o is not None:
      flat.append(o)
  return flat


def errors(got, want, cdt, n_values, weights=None, y=None):
  """Per output: (max abs err, that relative to max(1, max|plain|), relative
  L2 err, share of its bound). The first n_values outputs are values, held
  by KERNEL_BOUND on the max error; the output at index `weights` is K6's
  weights, held by WEIGHT_BOUND on the max abs error; the one at index `y`
  is K11's y, held by Y_BOUND on the L2 error; the rest are derivatives,
  held by GRAD_BOUND on the L2 error."""
  if len(got) != len(want) or not all(
      a.dtype == b.dtype and a.shape == b.shape for a, b in zip(got, want)):
    raise AssertionError('outputs differ in number, dtype or shape')
  rows = []
  for i, (a, b) in enumerate(zip(got, want)):
    d, b = a.float() - b.float(), b.float()
    e = d.abs().max().item()
    rel = e / max(1.0, b.abs().max().item())
    l2 = d.norm().item() / max(b.norm().item(), 1e-30)
    share = (e / WEIGHT_BOUND[cdt] if i == weights
             else l2 / Y_BOUND[cdt] if i == y
             else rel / KERNEL_BOUND[cdt] if i < n_values
             else l2 / GRAD_BOUND[cdt])
    rows.append((e, rel, l2, share))
  return rows


def nbytes(tensors):
  """Bytes of the tensors (Nones and duplicates skipped), each counted once."""
  seen, total = set(), 0
  for t in flatten(tensors):
    if t.data_ptr() not in seen:
      seen.add(t.data_ptr())
      total += t.numel() * t.element_size()
  return total


def trunk_flops(ws, n, heads, density_grad=False, backward=False,
                needs_dx=False):
  """Operations (2 a multiply-add) of the trunk function over n rows, as it
  needs them: counted product by product, not as the 1, 2, 4 or 6 forward
  passes of `_make_op`'s estimate (fused_mlp.py:925, :1052). T: the
  trunk's weights; X: those that read the input segments (layer 0 and the
  skip layer's input columns); H: width x the heads' outputs.
  - forward: the trunk and heads, T + H; with the density gradient u also
    the reverse from the density head through every layer, T + width.
  - backward: the trunk's recompute, T (a head is linear: its output is
    not needed); the reverse zeta_l W_l from the heads through every layer,
    T + H, less X without dx (those columns give only dx); the weight
    gradients zeta_l^T [h | x], T + H. With u's cotangent (second order)
    also the reverse g of the forward's u, T - X (u itself is not needed),
    the tangent pushed forward from the input, T, and the second
    weight-gradient product delta_l^T t, T."""
  width = ws[0].shape[0]
  t = sum(w.numel() for w in ws)
  x = sum(w.shape[0] * (w.shape[1] - (width if l else 0))
          for l, w in enumerate(ws))
  h = width * heads
  if not backward:
    per = t + h + (t + width if density_grad else 0)
  else:
    per = 3 * t + 2 * h - (0 if needs_dx else x)
    if density_grad:
      per += 3 * t - x
  return 2 * n * per


def bound(cdt, flops, nbytes_moved, f32_flops=0, tf32_passes=0):
  """(ms, 'bytes' or 'operations'): the least time the card could take.
  `flops` run in the compute dtype (bf16 on the tensor cores, f32 on the FMA
  pipes, or with `tf32_passes` as that many TF32 products on the tensor
  cores), `f32_flops` on the FMA pipes: in f32 on the FMA pipes the two
  share the pipes and add up; on the tensor cores they run on separate
  units that can overlap, so the longer of the two counts."""
  if tf32_passes:
    t_ops = max(tf32_passes * flops / PEAK_FLOPS['tf32'],
                f32_flops / PEAK_FLOPS['float32'])
  elif cdt == 'float32':
    t_ops = (flops + f32_flops) / PEAK_FLOPS['float32']
  else:
    t_ops = max(flops / PEAK_FLOPS[cdt], f32_flops / PEAK_FLOPS['float32'])
  t_bytes = nbytes_moved / MEM_RATE
  return max(t_ops, t_bytes) * 1e3, 'operations' if t_ops >= t_bytes else 'bytes'


def compare(which, cdt, kernel, plain, n_values, iters=5, phase=3, inputs=(),
            flops=0, f32_flops=0, weights=None, y=None, n=N_SAMPLES,
            library=None, tf32_passes=0):
  """Run kernel() and plain() once and compare every output (see errors());
  then time both in turns, and `library` (a PyTorch chain of the same
  function, the yardstick: never called by the port) between them where
  given. Returns a dict: max_abs_err, ms, plain_ms, library_ms (None
  without `library`), and the bound from `flops` (in the compute dtype; as
  `tf32_passes` TF32 products where given, with the FMA pipes' bound
  beside it as fma_bound_ms), `f32_flops` and the bytes of `inputs` and of
  the kernel's outputs."""
  with torch.no_grad():
    got, want = flatten(kernel()), flatten(plain())
    torch.cuda.synchronize()
    rows = errors(got, want, cdt, n_values, weights, y)
    moved = nbytes(list(inputs) + got)
    del got, want
    p1, k1 = cuda_ms(plain, iters), cuda_ms(kernel, iters)
  lib_ms = None
  if library is not None:  # its backward is autograd's: outside no_grad
    lib_ms = (cuda_ms(library, iters) + cuda_ms(library, iters)) / 2
  with torch.no_grad():
    k2, p2 = cuda_ms(kernel, iters), cuda_ms(plain, iters)
  ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
  err, worst = max(r[0] for r in rows), max(r[3] for r in rows)
  bound_ms, bound_by = bound(cdt, flops, moved, f32_flops, tf32_passes)
  fma = bound(cdt, flops, moved, f32_flops)[0] if tf32_passes else None
  detail = '; '.join(f'{i}: {r[1]:.2e} max, {r[2]:.2e} l2'
                     for i, r in enumerate(rows))
  kinds = f'derivatives from output {n_values}' + (
      f' but for the weights {weights}, absolute' if weights is not None
      else '') + (f', y {y} by L2' if y is not None else '')
  log(f'phase {phase}: {which} {cdt} N={n}: max_abs_err {err:.3e} '
      f'({worst:.3f} of its bound), kernel {ms:.3f} ms, plain '
      f'{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; '
      f'{moved / 1e6:.1f} MB' +
      (f'; {tf32_passes} TF32 passes, on the FMA pipes {fma:.3f} ms'
       if tf32_passes else '') + ')' +
      (f', library {lib_ms:.3f} ms' if lib_ms is not None else '') +
      f'; per output (relative to max|plain|, relative '
      f'L2, {kinds}): {detail}')
  if not worst <= 1.0:
    raise AssertionError(f'{which} {cdt}: an output is {worst:.3f} times '
                         'its bound')
  out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
             bound_by=bound_by, library_ms=lib_ms)
  if tf32_passes:
    out['fma_bound_ms'] = fma
  return out


def pack_tensors(pack):
  return [pack.w, pack.b, pack.wd, pack.wh, pack.bh, pack.wc, pack.bc]


def n_heads(kw):
  """Outputs of the heads on y: density, the f32 block, the cdt block."""
  return (sum(h[0].shape[0] for h in (kw.get('head_f32'), kw.get('head_cdt'))
              if h is not None) + int(kw.get('wd') is not None))


# The forward's library of a width-256 trunk within the wgmma/TMA and FMA/TMA
# kernels' shapes, by compute dtype; and the backward's (width 256 or 128).
FWD_ROUTE = {'bfloat16': 'trunk_fwd_tma', 'float32': 'trunk_fwd_f32'}
BWD_ROUTE = {'bfloat16': 'trunk_bwd_tma', 'float32': 'trunk_bwd_f32'}


def check_route(fused_mlp, which, cdt, pack, want=None, **modes):
  """Phases 3, 5, 7, 9: the forward of `pack` (with `modes`, as
  fused_mlp.forward_library takes them) goes to `want`, by default
  FWD_ROUTE[cdt], or this fails."""
  got = fused_mlp.forward_library(pack, **modes)
  if got != (want or FWD_ROUTE[cdt]):
    raise AssertionError(f'{which} {cdt}: the forward routed to {got}')


def sass_of(libs):
  """{library: its SASS (cuobjdump -sass)}, one cuobjdump a library, all
  started together, each writing to a file of its own (a full pipe would
  stall it)."""
  import tempfile
  tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
  runs = {}
  for lib in libs:
    f = tempfile.TemporaryFile(mode='w+')
    runs[lib] = (f, subprocess.Popen([tool, '-sass', str(lib)], stdout=f,
                                     stderr=subprocess.STDOUT, text=True))
  out = {}
  for lib, (f, proc) in runs.items():
    with f:
      proc.wait(timeout=300)
      f.seek(0)
      out[lib] = f.read()
    if proc.returncode != 0:
      raise RuntimeError(f'cuobjdump -sass {lib}: {out[lib][-2000:]}')
  return out


def check_sass(sass, need=('HGMMA', 'UTMALDG'), refuse=('HMMA',)):
  """Phase 2: each kernel of a TMA library holds every instruction of
  `need` and none of `refuse` in its SASS (`sass_of`), or this fails: the
  bf16 width-256 forward and backward wgmma (HGMMA) and TMA loads
  (UTMALDG) and no mma.sync (HMMA); the f32 forward and backward FFMA and
  TMA loads and no tensor-core product (HMMA, HGMMA)."""
  for block in re.split(r'\n\s*Function : ', sass)[1:]:
    name = block.split('\n', 1)[0]
    counts = {op: len(re.findall(rf'\b{op}\b', block))
              for op in dict.fromkeys(need + ('UTMASTG',) + refuse)}
    log(f'phase 2: SASS {name}: ' + ', '.join(
        f'{op} {k}' for op, k in counts.items()))
    if not all(counts[op] for op in need) or any(counts[op] for op in refuse):
      raise AssertionError(f'{name}: needs {need}, refuses {refuse}: '
                           f'{counts}')


def check_w1024_sass(sass):
  """Phase 2: the width-1024 library's products hold the instructions of
  their route in its SASS (`sass_of`), or this fails: each product, bf16
  (nt_wgmma, tn_wgmma) and f32 (nt_tf32, tn_tf32: three TF32 passes),
  wgmma's HGMMA and TMA loads (UTMALDG) and no mma.sync (HMMA); no FMA
  product (nt_f32, tn_f32) is left. Their other kernels (sigma, column
  sums, the weights' split) are logged."""
  products = set()
  for block in re.split(r'\n\s*Function : ', sass)[1:]:
    name = block.split('\n', 1)[0]
    counts = {op: len(re.findall(rf'\b{op}\b', block))
              for op in ('HMMA', 'HGMMA', 'UTMALDG', 'UTMASTG', 'FFMA')}
    log(f'phase 2: SASS {name}: ' + ', '.join(
        f'{op} {k}' for op, k in counts.items()))
    kind = re.search(r'(nt|tn)_(wgmma|tf32|f32)_kernel', name)
    if kind is None:
      continue
    ok = counts['HGMMA'] and counts['UTMALDG'] and not counts['HMMA']
    products.add(kind.group(0))
    if not ok:
      raise AssertionError(f'{name}: its SASS holds {counts}')
  want = {f'{d}_{r}_kernel' for d in ('nt', 'tn') for r in ('wgmma', 'tf32')}
  if products != want:
    raise AssertionError(f'trunk_w1024: product kernels {sorted(products)} '
                         f'in its SASS, expected {sorted(want)}')


def check_wgmma_sass(sass, kernels, count, what):
  """Phase 2: the `count` kernels of a library whose names match `kernels`
  hold wgmma's HGMMA and TMA loads (UTMALDG) and no mma.sync (HMMA) in its
  SASS (`sass_of`), or this fails; the library's other kernels (its
  weights' TF32 split) are logged: the depth-1 directional library's four
  (bf16 and f32, forward and backward: dir1_bf16_kernel, dir1_f32_kernel),
  the f32 forward's three (trunk_fwd_tf32_kernel: K3, K1, and K1 at the
  density head alone), the bf16 density gradient's one
  (trunk_fwd_bf16_kernel), the f32 backward's three (trunk_bwd_tf32_kernel:
  first order, with u's cotangent, and first order at the density head
  alone)."""
  found = []
  for block in re.split(r'\n\s*Function : ', sass)[1:]:
    name = block.split('\n', 1)[0]
    counts = {op: len(re.findall(rf'\b{op}\b', block))
              for op in ('HMMA', 'HGMMA', 'UTMALDG', 'UTMASTG', 'UBLKCP')}
    log(f'phase 2: SASS {name}: ' + ', '.join(
        f'{op} {k}' for op, k in counts.items()))
    if re.search(kernels, name) is None:
      continue
    found.append(name)
    if not (counts['HGMMA'] and counts['UTMALDG'] and not counts['HMMA']):
      raise AssertionError(f'{name}: its SASS holds {counts}')
  if len(found) != count:
    raise AssertionError(f'{what}: {len(found)} kernels in its SASS, '
                         f'expected {count}')


def check_kernels(fused_mlp, dev):
  """Phase 3: each kernel against its plain version, f32 (trunk_fwd_f32.cu)
  and bf16 (trunk_fwd_tma.cu); the bf16 trunk past the wgmma/TMA forward's
  shapes on trunk_fwd.cu."""
  gen = torch.Generator().manual_seed(SEED)
  results = {}
  for which in ('K1', 'K2', 'K2 kin 288'):
    segs, ws, bs, kw = trunk_case(which, gen, dev)
    for cdt in ('float32', 'bfloat16'):
      if which == 'K2 kin 288' and cdt == 'float32':
        continue
      pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in segs],
                                  compute_dtype=cdt, **kw)
      check_route(fused_mlp, which, cdt, pack,
                  'trunk_fwd' if which == 'K2 kin 288' else None)
      kernel = lambda: fused_mlp.trunk_kernel(segs, pack)
      plain = lambda: fused_mlp.trunk_reference(segs, ws, bs,
                                                compute_dtype=cdt, **kw)
      results[which, cdt] = compare(
          which, cdt, kernel, plain, n_values=3,
          inputs=segs + pack_tensors(pack),
          flops=trunk_flops(ws, N_SAMPLES, n_heads(kw)))
  return results


def deterministic(which, kernel, phase=5, cdt='bfloat16'):
  """Phases 5, 7, 9 (H4): two runs of a kernel on the same inputs give
  bit-identical outputs (fixed-order sums, no float atomics), or this
  fails."""
  with torch.no_grad():
    a, b = flatten(kernel()), flatten(kernel())
  same = all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)
  log(f'phase {phase}: {which} {cdt}: two runs bit-identical: {same} '
      f'({len(a)} outputs)')
  if not same:
    raise AssertionError(f'{which}: the outputs differ between two runs')


def random_rays(rays_lib, n, config, seed, dev):
  """Rays as bench.py makes them: numpy, seeded, origins near the center."""
  rng = np.random.RandomState(seed)
  d = rng.randn(n, 3).astype(np.float32)
  o = rng.randn(n, 3).astype(np.float32) * 0.1
  return rays_from(rays_lib, o, d, np.full((n, 1), 0.001, np.float32),
                   config, dev)


def pinhole_rays(rays_lib, height, width, config, dev):
  """A pinhole camera at (0, 0, 4) looking down -z, 40 degree field of view."""
  focal = width / (2 * math.tan(math.radians(20)))
  j, i = np.meshgrid(np.arange(width, dtype=np.float32),
                     np.arange(height, dtype=np.float32))
  d = np.stack([(j + 0.5 - width / 2) / focal,
                -(i + 0.5 - height / 2) / focal,
                -np.ones_like(i)], axis=-1).reshape(-1, 3)
  o = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (d.shape[0], 1))
  radii = np.full((d.shape[0], 1), 2 / math.sqrt(12) / focal, np.float32)
  rays = rays_from(rays_lib, o, d.astype(np.float32), radii, config, dev)
  return rays.reshape(height, width)


def rays_from(rays_lib, origins, directions, radii, config, dev):
  n = origins.shape[0]
  t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
  rays = rays_lib.dummy_rays(n, dev)
  rays.origins, rays.directions, rays.radii = t(origins), t(directions), t(radii)
  rays.viewdirs = rays.directions / rays.directions.norm(dim=-1, keepdim=True)
  rays.near = torch.full((n, 1), float(config.near), device=dev)
  rays.far = torch.full((n, 1), float(config.far), device=dev)
  return rays


def check_rendering(out, shape, config, pad):
  """Finite, of the expected shapes, within the ranges compositing allows."""
  expect = {'rgb': shape + (3,), 'diffuse': shape + (3,),
            'specular': shape + (3,), 'distance': shape + (1,), 'acc': shape}
  for k, s in expect.items():
    if tuple(out[k].shape) != s:
      raise AssertionError(f'{k}: shape {tuple(out[k].shape)} != {s}')
    if not torch.isfinite(out[k]).all():
      raise AssertionError(f'{k}: non-finite values')
  rgb, acc, dist = out['rgb'], out['acc'], out['distance']
  if not (rgb.min() >= -pad - 1e-6 and rgb.max() <= 1 + pad + 1e-6):
    raise AssertionError(f'rgb outside [-{pad}, 1+{pad}]')
  if not (acc.min() >= -1e-6 and acc.max() <= 1 + 1e-6):
    raise AssertionError('acc outside [0, 1]')
  if not (dist.min() >= 0 and dist.max() <= config.far + 1e-4):
    raise AssertionError('distance outside [0, far]')
  return (f'rgb [{rgb.min().item():.4f}, {rgb.max().item():.4f}], '
          f'acc [{acc.min().item():.4f}, {acc.max().item():.4f}]')


FLAGSHIP, MIPNERF = 'blender_refnerf.gin', 'blender_mipnerf.gin'


def flagship(dev, bindings=(), gin_name=FLAGSHIP, dtype='bfloat16'):
  """The model of configs/<gin_name> (the flagship by default) with
  trunks in `dtype` (None: the gin's own, float32) and weights from
  Config.seed, and its Config."""
  from refnerf_tpu_torch import configs
  from refnerf_tpu_torch.models import construct
  gin_file = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'configs', gin_name)
  config, gin = configs.parse(
      [gin_file], [f'Config.seed = {SEED}'] + (
          [f"NerfMLP.compute_dtype = '{dtype}'"] if dtype else []) +
      list(bindings))
  return construct.construct_model(config, gin, dev), config


def set_mode(model, **fields):
  """Set MLPConfig fields (fused_trunk, fuse_dir_*) on every MLP."""
  for mlp in (model.nerf_mlp, model.prop_mlp):
    if mlp is not None:
      for k, v in fields.items():
        setattr(mlp.cfg, k, v)


def serve(fused_mlp, dev, bindings=(), phase=4, kernels=('K1', 'K2'),
          gin_name=FLAGSHIP, timings=None, dtype='bfloat16'):
  """Phase 4 (8 with the fused directional stage, 12 with mip-NeRF, 14 in
  the gin's own float32): the model of `gin_name` (trunks in `dtype`, as
  `flagship`) answers three requests through the kernels; each kernel in
  `kernels` must run levels x chunks times a request, and no training
  kernel. Then the first request again with fused_trunk='off'. Returns
  (the launches, the model and its Config); `timings`, a dict, gets each
  request's ms."""
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.models import renderer

  model, config = flagship(dev, bindings, gin_name, dtype)
  levels, chunk = model.cfg.num_levels, config.render_chunk_size
  pad = model.nerf_mlp.cfg.rgb_padding
  n_params = sum(p.numel() for p in model.parameters())
  log(f'phase {phase}: model {gin_name} {" ".join(bindings)} '
      f'{model.nerf_mlp.cfg.compute_dtype} trunks, {n_params} parameters, '
      f'{levels} levels x '
      f'{model.cfg.num_nerf_samples} samples, chunk {chunk}')

  requests = [
      ('4096 rays', lambda: random_rays(rays_lib, 4096, config, 1, dev)),
      ('5000 rays', lambda: random_rays(rays_lib, 5000, config, 2, dev)),
      ('64x64 image', lambda: pinhole_rays(rays_lib, 64, 64, config, dev)),
  ]
  # Warm-up (packs the weights once per model): not a request.
  renderer.render_rays(model, random_rays(rays_lib, 4096, config, 3, dev),
                       chunk)
  torch.cuda.synchronize()

  counts = fused_mlp.launches
  for k in counts:
    counts[k] = 0
  first = None
  for name, make in requests:
    rays = make()
    n = math.prod(rays.shape)
    before = [counts[k] for k in kernels]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if len(rays.shape) == 2:
      out = renderer.render_image(model, rays, chunk)
    else:
      out = renderer.render_rays(model, rays, chunk)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ranges = check_rendering(out, tuple(rays.shape), config, pad)
    want = levels * -(-n // chunk)
    got = [counts[k] - b for k, b in zip(kernels, before)]
    if got != [want] * len(kernels):
      raise AssertionError(f'{name}: launches {got} of {kernels}, expected '
                           f'{want} each')
    log(f'phase {phase}: request {name}: {dt * 1e3:.1f} ms, {n / dt:.0f} '
        f'rays/s, {ranges}, launches {dict(zip(kernels, got))} (= {levels} '
        f'levels x {want // levels} chunks each)')
    if timings is not None:
      timings[name] = dt * 1e3
    if first is None:
      first = (rays, out)
  launches = dict(counts)
  if any(launches[k] for k in ('K3', 'K4', 'K5')):
    raise AssertionError(f'serving launched a training kernel: {launches}')

  # The same request through the plain versions on the card.
  set_mode(model, fused_trunk='off')
  plain = renderer.render_rays(model, first[0], chunk)
  torch.cuda.synchronize()
  if counts != launches:
    raise AssertionError("fused_trunk='off' launched a kernel")
  diff = (plain['rgb'] - first[1]['rgb']).abs().max().item()
  acc_diff = (plain['acc'] - first[1]['acc']).abs().max().item()
  log(f"phase {phase}: request 4096 rays, kernels vs fused_trunk='off': max "
      f'|rgb| diff {diff:.3e}, max |acc| diff {acc_diff:.3e} (bound '
      f'{PATH_BOUND})')
  if not (diff <= PATH_BOUND and acc_diff <= PATH_BOUND):
    raise AssertionError('kernel path disagrees with the plain path')
  set_mode(model, fused_trunk='auto')
  return launches, (model, config)


def check_train_kernels(fused_mlp, dev):
  """Phase 5: K3, K4 and K5 against their plain versions, f32 and bf16."""
  gen = torch.Generator().manual_seed(SEED + 1)
  fold = torch.as_tensor(fused_mlp.ipe_scale_fold(SCALES, 3), device=dev)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  results = {}
  for which in ('K3', 'K4', 'K5'):
    spatial = which != 'K5'
    segs, ws, bs, kw = trunk_case('K1' if spatial else 'K2', gen, dev,
                                  ipe=spatial)
    # Cotangents of (sigma, the f32 heads, the bottleneck, u).
    cots = ((rand(N_SAMPLES), rand(N_SAMPLES, 10), rand(N_SAMPLES, 128),
             rand(N_SAMPLES, 3)) if spatial
            else (None, rand(N_SAMPLES, 3), None, None))
    for cdt in ('float32', 'bfloat16'):
      cs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
      pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in cs],
                                  compute_dtype=cdt, **kw)
      if which == 'K3':
        check_route(fused_mlp, which, cdt, pack, fold=fold)
        kernel = lambda: fused_mlp.trunk_kernel(cs, pack, fold)

        def plain():
          out = fused_mlp.trunk_reference(cs, ws, bs, compute_dtype=cdt,
                                          density_grad=True, **kw)
          return out[:-2] + [fused_mlp.fold_density_grad(out[-2:], *cs,
                                                         fold)]
        # sigma, the two heads, then u.
        results[which, cdt] = compare(
            which, cdt, kernel, plain, n_values=3, phase=5,
            inputs=cs + pack_tensors(pack) + [fold],
            flops=trunk_flops(ws, N_SAMPLES, n_heads(kw),
                              density_grad=True))
        if cdt == 'bfloat16':
          deterministic(which, kernel)
      else:
        f = fold if spatial else None
        route = 'trunk_bwd_tma' if cdt == 'bfloat16' else 'trunk_bwd_f32'
        if fused_mlp.backward_library(pack) != route:
          raise AssertionError(f'{which} {cdt}: routed to the wrong backward')
        kernel = lambda: fused_mlp.trunk_backward_kernel(
            cs, pack, cots, f, needs_dx=not spatial)
        plain = lambda: fused_mlp.trunk_backward_reference(
            cs, ws, bs, cots, compute_dtype=cdt, fold=f,
            needs_dx=not spatial, **kw)
        results[which, cdt] = compare(
            which, cdt, kernel, plain, n_values=0, iters=3, phase=5,
            inputs=cs + pack_tensors(pack) + list(cots) + [f],
            flops=trunk_flops(ws, N_SAMPLES, n_heads(kw),
                              density_grad=spatial, backward=True,
                              needs_dx=not spatial))
        deterministic(which, kernel, cdt=cdt)
      del pack
    del segs, ws, bs, kw, cots
    torch.cuda.empty_cache()
  return results


def train_setup(dev, bindings=(), gin_name=FLAGSHIP, dtype='bfloat16'):
  """The model of `gin_name` (trunks in `dtype`, as `flagship`) at batch
  TRAIN_BATCH as bench.py trains it: model, its Config, train state, step
  and a batch of rays and pixels made as bench.py makes them."""
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.train import step as step_lib
  model, config = flagship(dev, [
      f'Config.batch_size = {TRAIN_BATCH}', 'Config.randomized = False',
      'Config.sample_noise_size = 0', *bindings], gin_name, dtype)
  rng = np.random.RandomState(0)
  d = rng.randn(TRAIN_BATCH, 3).astype(np.float32)
  rays = rays_from(rays_lib, rng.randn(TRAIN_BATCH, 3).astype(np.float32) * 0.1,
                   d, np.full((TRAIN_BATCH, 1), 0.001, np.float32), config, dev)
  rays.lossmult = torch.ones(TRAIN_BATCH, 1, device=dev)
  rgb = torch.from_numpy(
      rng.uniform(0, 1, (TRAIN_BATCH, 3)).astype(np.float32)).to(dev)
  batch = rays_lib.Batch(rays=rays, rgb=rgb)
  state = step_lib.create_train_state(config, model)
  return model, config, state, step_lib.make_train_step(model, config), batch


def train(fused_mlp, dev, bindings=(), phase=6, per_step=None,
          gin_name=FLAGSHIP, dtype='bfloat16'):
  """Phase 6 (8 with the fused directional stage, 12 with mip-NeRF, 13 in
  the gin's own float32): train steps of the model of `gin_name` (trunks
  in `dtype`, as `flagship`) through the kernels; `per_step` are the
  launches each kernel must make a level and step. Then one step's
  gradients against fused_trunk='off'. Returns (launches, seconds per step,
  train_setup's five)."""
  from refnerf_tpu_torch.train import step as step_lib
  model, config, state, train_step, batch = train_setup(dev, bindings,
                                                        gin_name, dtype)
  levels = model.cfg.num_levels
  start = {k: p.detach().clone() for k, p in model.named_parameters()}
  log(f'phase {phase}: model {gin_name} {" ".join(bindings)} '
      f'{model.nerf_mlp.cfg.compute_dtype} trunks, batch {TRAIN_BATCH}, '
      f'{levels} levels x '
      f'{model.cfg.num_nerf_samples} samples')

  def check(stats, step):
    for k, v in [('loss', stats['loss']), *stats['losses'].items()]:
      if not torch.isfinite(v).all():
        raise AssertionError(f'step {step}: loss term {k} is not finite')

  for i in range(TRAIN_WARMUP):
    state, stats = train_step(state, batch)
    check(stats, i)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  for k in fused_mlp.launches:
    fused_mlp.launches[k] = 0
  t0 = time.perf_counter()
  all_stats = []
  for _ in range(TRAIN_STEPS):
    state, stats = train_step(state, batch)
    all_stats.append(stats)
  torch.cuda.synchronize()
  dt = (time.perf_counter() - t0) / TRAIN_STEPS
  launches = dict(fused_mlp.launches)
  for i, stats in enumerate(all_stats):
    check(stats, TRAIN_WARMUP + i)
  per_step = per_step or {'K2': 1, 'K3': 1, 'K4': 1, 'K5': 1}
  want = {k: levels * TRAIN_STEPS * per_step.get(k, 0) for k in launches}
  if launches != want:
    raise AssertionError(f'train launches {launches}, expected {want}')
  moved = max((p.detach() - start[k]).abs().max().item()
              for k, p in model.named_parameters())
  if not moved > 0:
    raise AssertionError('the parameters did not change')
  last = all_stats[-1]
  terms = ', '.join(f'{k} {v.item():.6g}' for k, v in last['losses'].items())
  log(f'phase {phase}: {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up: '
      f'{dt * 1e3:.2f} ms/step, {TRAIN_BATCH / dt:.0f} train rays/s, peak '
      f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; step '
      f'{state.step}: loss {last["loss"].item():.6g} ({terms}), psnr '
      f'{last["psnr"].item():.3f}; launches {launches}; max param move '
      f'{moved:.3e}')

  # One step's gradients from the same state, kernels vs plain versions.
  loss_k, _, grads_k = train_step.loss_and_grads(state, batch)
  norm_k = step_lib.global_norm(grads_k.values()).item()
  del grads_k
  set_mode(model, fused_trunk='off')
  before = dict(fused_mlp.launches)
  loss_p, _, grads_p = train_step.loss_and_grads(state, batch)
  norm_p = step_lib.global_norm(grads_p.values()).item()
  del grads_p
  set_mode(model, fused_trunk='auto')
  if fused_mlp.launches != before:
    raise AssertionError("fused_trunk='off' launched a kernel")
  dl = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
  dn = abs(norm_k - norm_p) / norm_p
  log(f"phase {phase}: step {state.step} kernels vs fused_trunk='off': loss "
      f'{loss_k.item():.6g} vs {loss_p.item():.6g} (rel {dl:.2e}, bound '
      f'{TRAIN_LOSS_BOUND}), grad norm {norm_k:.6g} vs {norm_p:.6g} (rel '
      f'{dn:.2e}, bound {TRAIN_GNORM_BOUND})')
  if not (dl <= TRAIN_LOSS_BOUND and dn <= TRAIN_GNORM_BOUND):
    raise AssertionError('the kernel train step disagrees with the plain one')
  return launches, dt, (model, config, state, train_step, batch)


# Phase 7: (name, (IDE, geometry, colour epilogue)) of each fused mode; K9
# runs with K8, as it does in the model.
DIR_CASES = (('K8', (True, False, False)), ('K9', (True, True, False)),
             ('K10', (False, False, True)), ('K8+K9+K10', (True, True, True)))


def dir_flops(mat, ide, geo, rgb, backward):
  """f32 operations of the fused directional stages over N_SAMPLES, as the
  function needs them (not as the kernel happens to compute them; a
  transcendental counts as one). A sample's IDE forward: the powers z^k and
  (x + iy)^m up to l_max (1 and 6 a step), a multiply-add for each non-zero
  of `mat` (the z-polynomials; taking power m_i through `gather` is a pick,
  no arithmetic), and kappa_inv sigma, its exp and three products a
  harmonic. Its backward: the forward again (the trunk's recompute needs
  the encoding), a multiply-add for each non-zero of mat's rows k >= 1 (the
  derivative polynomials) and 19 a harmonic for the closed form. The
  geometry: 27 forward, 27 + 46 backward. The colour epilogue: 74 forward,
  150 backward."""
  lmax, p = mat.shape[0] - 1, mat.shape[1]
  n = 0
  if ide:
    n += 7 * (lmax - 1) + 2 * np.count_nonzero(mat) + 5 * p
    if backward:
      n += 2 * np.count_nonzero(mat[1:]) + 19 * p
  if geo:
    n += 27 + (46 if backward else 0)
  if rgb:
    n += 150 if backward else 74
  return int(n) * N_SAMPLES


def dir_case(fused_mlp, gen, dev, ide, geo, rgb):
  """The flagship directional trunk (trunk_case 'K2') on the raw inputs of a
  mode, N_SAMPLES rows: bottleneck 128 | refdirs, kappa_inv, n.v (K8), or
  grad_pred, viewdirs, kappa_inv (K8+K9), or the 73-wide encoding (K10
  alone); kappa_inv in [0.05, 0.5], as the model's roughness (below 0.05
  the f32 IDE at deg_view 5 depends on the summation order, ROADMAP H9)."""
  segs, ws, bs, kw = trunk_case('K2', gen, dev)
  n = N_SAMPLES
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  unit = lambda v: v / v.norm(dim=-1, keepdim=True)
  ki = 0.05 + 0.45 * torch.rand(n, 1, generator=gen).to(dev)
  if ide and geo:
    segs = [segs[0], rand(n, 3), unit(rand(n, 3)), ki]
  elif ide:
    segs = [segs[0], unit(rand(n, 3)), ki, segs[1][:, :1].contiguous()]
  dm = fused_mlp.DirModes(5 if ide else 0, 1, geo,
                          (1.0, 0.0, 0.001) if rgb else None)
  rgbx = (rand(n, 3), rand(n, 3)) if rgb else None
  return segs, ws, bs, kw['head_f32'], dm, rgbx


def check_dir_kernels(fused_mlp, dev):
  """Phase 7: K8, K8+K9, K10 and all three against their plain versions,
  forward and backward, f32 and bf16."""
  gen = torch.Generator().manual_seed(SEED + 2)
  results = {}
  for which, (ide, geo, rgb) in DIR_CASES:
    segs, ws, bs, head, dm, rgbx = dir_case(fused_mlp, gen, dev, ide, geo,
                                            rgb)
    raw = range(1, 1 + dm.n_raw())
    rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
    cots = (None, rand(N_SAMPLES, 3), None, None)
    rgb_bar = rand(N_SAMPLES, 3) if rgb else None
    mat = fused_mlp.ref_utils.ide_tables(5)[0]
    kw = dict(dir_modes=dm, rgbx=rgbx)
    for cdt in ('float32', 'bfloat16'):
      cs = [s if j in raw else s.to(fused_mlp.DTYPES[cdt])
            for j, s in enumerate(segs)]
      pack = fused_mlp.pack_trunk(ws, bs, fused_mlp.visible_dims(cs, dm),
                                  head_f32=head, compute_dtype=cdt)
      inputs = cs + pack_tensors(pack) + list(rgbx or [])
      check_route(fused_mlp, which, cdt, pack)
      results[which, cdt] = compare(
          which, cdt, lambda: fused_mlp.trunk_kernel(cs, pack, **kw),
          lambda: fused_mlp.trunk_reference(cs, ws, bs, head_f32=head,
                                            compute_dtype=cdt, **kw),
          n_values=2 if rgb else 1, phase=7, inputs=inputs,
          flops=trunk_flops(ws, N_SAMPLES, 3),
          f32_flops=dir_flops(mat, ide, geo, rgb, backward=False))
      if which == 'K8+K9+K10':
        deterministic(which, lambda: fused_mlp.trunk_kernel(cs, pack, **kw),
                      phase=7, cdt=cdt)
      results[which + ' backward', cdt] = compare(
          which + ' backward', cdt,
          lambda: fused_mlp.trunk_backward_kernel(
              cs, pack, cots, needs_dx=True, rgb_bar=rgb_bar, **kw),
          lambda: fused_mlp.trunk_backward_reference(
              cs, ws, bs, cots, head_f32=head, compute_dtype=cdt,
              needs_dx=True, rgb_bar=rgb_bar, **kw),
          n_values=0, iters=3, phase=7,
          inputs=inputs + [cots[1], rgb_bar],
          flops=trunk_flops(ws, N_SAMPLES, 3, backward=True,
                            needs_dx=True),
          f32_flops=dir_flops(mat, ide, geo, rgb, backward=True))
      del pack
    del segs, ws, bs, cots, rgbx
    torch.cuda.empty_cache()
  return results


FUSE_FLAGS = ('fuse_dir_enc', 'fuse_dir_geo', 'fuse_dir_rgb')


def in_turns(run, arms, blocks=2, reps=5):
  """Seconds of run() per call under each arm (a dict of MLPConfig fields),
  timed in turns a, b, b, a, ... over `blocks` pairs of `reps` calls each.
  Returns {arm: [seconds, ...]}."""
  names = list(arms)
  order = []
  for i in range(blocks):
    order += names if i % 2 == 0 else names[::-1]
  times = {a: [] for a in names}
  for a in order:
    set_mode(arms[a][0], **arms[a][1])
    run()  # the first call after a switch packs the weights: not timed
    for _ in range(reps):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      run()
      torch.cuda.synchronize()
      times[a].append(time.perf_counter() - t0)
  return times


def profile(run, what, calls, phase=8):
  """One torch.profiler window over `calls` calls of run(): wall, device
  busy and idle share, kernels launched, device time by kernel name.
  Returns {wall_ms, busy_ms, kernels: {name: device ms}} a call, or None
  when the profiler saw no device time."""
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as torch_profile
  run()
  torch.cuda.synchronize()
  with torch_profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(calls):
      run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  kernels = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  dev_us = lambda e: getattr(e, 'self_device_time_total',
                             getattr(e, 'self_cuda_time_total', 0))
  busy = sum(dev_us(e) for e in kernels) / 1e6
  if busy <= 0:
    log(f'phase {phase}: profile {what}: the profiler saw no device time')
    return None
  top = sorted(kernels, key=dev_us, reverse=True)[:8]
  # The trunk kernels' names with their template arguments (the instance).
  name = lambda e: e.key.replace('void ', '').replace(
      '(anonymous namespace)::', '')[:64]
  log(f'phase {phase}: profile {what} ({calls} calls): wall {wall * 1e3:.2f} ms, '
      f'device busy {busy * 1e3:.2f} ms, idle {100 * (1 - busy / wall):.1f}%, '
      f'{sum(e.count for e in kernels) / calls:.0f} kernel launches a call; '
      'device ms a call by kernel: ' + '; '.join(
          f'{name(e)} {dev_us(e) / 1e3 / calls:.3f}' for e in top))
  return dict(wall_ms=wall * 1e3 / calls, busy_ms=busy * 1e3 / calls,
              kernels={e.key: dev_us(e) / 1e3 / calls for e in kernels})


def fused_stage(fused_mlp, dev):
  """Phase 8: the flagship with the fused directional stage, served and
  trained through the kernels, against fused_trunk='off' and timed in
  turns against the same model unfused."""
  from refnerf_tpu_torch.models import renderer
  from refnerf_tpu_torch.cameras import rays as rays_lib
  serve_launches, _ = serve(fused_mlp, dev, FUSE, phase=8,
                            kernels=('K1', 'K2', 'K8', 'K9', 'K10'))
  per_step = {'K2': 1, 'K3': 1, 'K4': 1, 'K5': 1, 'K8': 2, 'K9': 2,
              'K10': 2}
  train_launches, step_s, (model, config, state, train_step, batch) = train(
      fused_mlp, dev, FUSE, phase=8, per_step=per_step)

  fused = {f: True for f in FUSE_FLAGS}
  unfused = {f: False for f in FUSE_FLAGS}
  box = {'state': state}

  def step():
    box['state'], _ = train_step(box['state'], batch)

  times = in_turns(step, {'fused': (model, fused),
                          'unfused': (model, unfused)})
  # A 4096-ray request (one chunk) on the same weights.
  rays = random_rays(rays_lib, 4096, config, 1, dev)
  request = lambda: renderer.render_rays(model, rays,
                                         config.render_chunk_size)
  with torch.no_grad():
    rtimes = in_turns(request, {
        'fused': (model, {**fused, 'fused_trunk': 'auto'}),
        'unfused': (model, {**unfused, 'fused_trunk': 'auto'}),
        'off': (model, {**fused, 'fused_trunk': 'off'})})
  med = lambda v: float(np.median(v)) * 1e3
  log('phase 8: train step in turns (fused, unfused, unfused, fused; 5 steps '
      'a block): ' + ', '.join(
          f'{a} {med(v):.2f} ms median [{min(v) * 1e3:.2f}, '
          f'{max(v) * 1e3:.2f}]' for a, v in times.items()))
  log('phase 8: 4096-ray request in turns (5 requests a block): ' + ', '.join(
      f'{a} {med(v):.2f} ms median [{min(v) * 1e3:.2f}, {max(v) * 1e3:.2f}]'
      for a, v in rtimes.items()))
  set_mode(model, fused_trunk='auto', **fused)
  with torch.no_grad():
    profile(request, 'fused 4096-ray request', 3)
  profile(step, 'fused train step', 2)
  return serve_launches, train_launches, step_s, {
      'step_fused_ms': med(times['fused']),
      'step_unfused_ms': med(times['unfused']),
      'request_fused_ms': med(rtimes['fused']),
      'request_unfused_ms': med(rtimes['unfused']),
      'request_off_ms': med(rtimes['off'])}


# Phase 9: (name, (IPE in the kernel, compositing, density gradient,
# backward, trunk)) of each fused spatial mode. 'K6+K7' on K1 is the served
# request's launch; the 'mip' cases are mip-NeRF's spatial trunk (hf = 0)
# with the spatial fuse flags: served, and trained in first-order K4.
SPA_CASES = (('K7', (True, False, False, False, 'K1')),
             ('K7+K3', (True, False, True, False, 'K1')),
             ('K6+K7', (True, True, False, False, 'K1')),
             ('K6+K3', (False, True, True, False, 'K1')),
             ('K6+K7+K3', (True, True, True, False, 'K1')),
             ('K6+K7+K4', (True, True, True, True, 'K1')),
             ('mip K6+K7', (True, True, False, False, 'mip K1')),
             ('mip K6+K7+K4 first-order', (True, True, False, True, 'mip K1')))


def spa_flops(enc, comp, dg, backward):
  """f32 operations of the fused spatial stages over N_SAMPLES, as the
  function needs them (a transcendental counts as one). A column of the
  IPE (48 a sample): m = lm s, v = lv s^2, -v/2, exp, sin, cos, e sin m,
  e cos m (8); with the density gradient the chain rule e (cos u - sin u)
  (4) and the factors again (8); its backward: the IPE for the recompute
  and the tangent (tp e) cos m, (tp e) sin m (3) with the factors again.
  The compositing weights: 10 a sample (softplus as exp, log1p and an add,
  the bias, times delta, the scan's add, two exps, 1 - and the product);
  backward 20 (the forward, the sigmoid, ct and the suffix)."""
  n = 0
  if enc:
    n += 48 * 8
    if dg and not backward:
      n += 48 * (4 + 8)
    if backward:
      n += 48 * (3 + 8)
  if comp:
    n += 20 if backward else 10
  return n * N_SAMPLES


def spa_case(fused_mlp, gen, dev, enc, comp, trunk='K1'):
  """The spatial trunk `trunk` (trunk_case 'K1', the flagship's, or 'mip
  K1', mip-NeRF's) on N_SAMPLES rows of
  random lifted means and variances (lm in [-1.5, 1.5], lv in [1e-6,
  1e-2]), the segments (lm, lv) with K7, else their IPE; with K6 rays of
  SAMPLES rows, delta in [0.01, 0.09] (the flagship's t-intervals, 4 / 128,
  times |direction|) and bsig 0.5 (its density bias)."""
  _, ws, bs, kw = trunk_case(trunk, gen, dev)
  rand = lambda *s: torch.rand(*s, generator=gen).to(dev)
  lm, lv = rand(N_SAMPLES, 3) * 3 - 1.5, 10.0**(rand(N_SAMPLES, 3) * 4 - 6)
  segs = [lm, lv] if enc else list(fused_mlp.encode_ipe(lm, lv, SCALES))
  cp = (rand(N_SAMPLES) * 0.08 + 0.01, torch.full((1,), 0.5, device=dev))
  sp = fused_mlp.SpaModes(tuple(float(s) for s in SCALES) if enc else (),
                          SAMPLES if comp else 0)
  return segs, ws, bs, kw, sp, cp if comp else None


def weight_faults(fused_mlp, which, cdt, raw, delta, bsig):
  """What two faults of K6 would read on the plain raw density: an
  inclusive scan (w e^-dd in place of w) and a dropped density bias (bsig
  0). Fails unless both read above WEIGHT_BOUND, so that the weights'
  check would see either."""
  w = fused_mlp.composite_weights(raw, delta, bsig, SAMPLES)
  dd = torch.nn.functional.softplus(raw.float() + bsig) * delta
  incl = (w * torch.exp(-dd) - w).abs().max().item()
  nobias = (fused_mlp.composite_weights(raw, delta, bsig * 0, SAMPLES)
            - w).abs().max().item()
  log(f'phase 9: {which} {cdt}: a fault in the weights would read '
      f'{incl:.3e} (inclusive scan), {nobias:.3e} (no density bias); '
      f'max weight {w.max().item():.3e}, bound {WEIGHT_BOUND[cdt]:.0e}')
  if not min(incl, nobias) > WEIGHT_BOUND[cdt]:
    raise AssertionError(f'{which} {cdt}: the weights\' bound does not see '
                         'a fault of K6')


def check_spa_kernels(fused_mlp, dev):
  """Phase 9: K7 on K1 and K3, K6 on K3, K6+K7 on K1, K3 and K4 against
  their plain versions, f32 and bf16."""
  gen = torch.Generator().manual_seed(SEED + 3)
  fold = torch.as_tensor(fused_mlp.ipe_scale_fold(SCALES, 3), device=dev)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  results = {}
  for which, (enc, comp, dg, backward, trunk) in SPA_CASES:
    segs, ws, bs, kw, sp, cp = spa_case(fused_mlp, gen, dev, enc, comp, trunk)
    hf = kw['head_f32'][0].shape[0] if kw['head_f32'] else 0
    f = fold if dg else None
    for cdt in ('float32', 'bfloat16'):
      cs = segs if enc else [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
      pack = fused_mlp.pack_trunk(ws, bs, (48, 48), compute_dtype=cdt, **kw)
      inputs = cs + pack_tensors(pack) + [f] + list(cp or [])
      f32_flops = spa_flops(enc, comp, dg, backward)
      kws = dict(spa_modes=sp, comp=cp)
      if not backward:
        # sigma and the heads are values, u a derivative, the weights
        # (after u) held by WEIGHT_BOUND.
        check_route(fused_mlp, which, cdt, pack, fold=f, sp=sp)
        nv = 2 + int(hf > 0)
        plain = lambda: fused_mlp.trunk_reference(
            cs, ws, bs, compute_dtype=cdt, density_grad=dg, fold=f, **kws,
            **kw)
        results[which, cdt] = compare(
            which, cdt, lambda: fused_mlp.trunk_kernel(cs, pack, f, **kws),
            plain, n_values=nv, phase=9, inputs=inputs,
            flops=trunk_flops(ws, N_SAMPLES, n_heads(kw), density_grad=dg),
            f32_flops=f32_flops, weights=nv + int(dg) if comp else None)
        if comp:
          with torch.no_grad():
            weight_faults(fused_mlp, which, cdt, plain()[0], *cp)
        if which == 'K6+K7+K3':
          deterministic(which, lambda: fused_mlp.trunk_kernel(
              cs, pack, f, **kws), phase=9, cdt=cdt)
        continue
      # Cotangents of (sigma, the f32 heads, the bottleneck, u, weights);
      # the forward's sigma from each side's own forward.
      cots = (rand(N_SAMPLES), rand(N_SAMPLES, hf) if hf else None,
              rand(N_SAMPLES, 128), rand(N_SAMPLES, 3) if dg else None,
              rand(N_SAMPLES))
      with torch.no_grad():
        sk = fused_mlp.trunk_kernel(cs, pack, f, **kws)[0]
        sr = fused_mlp.trunk_reference(cs, ws, bs, compute_dtype=cdt, **kws,
                                       **kw)[0]
      results[which, cdt] = compare(
          which, cdt,
          lambda: fused_mlp.trunk_backward_kernel(
              cs, pack, cots, f, spa_modes=sp, comp=cp + (sk,)),
          lambda: fused_mlp.trunk_backward_reference(
              cs, ws, bs, cots, compute_dtype=cdt, fold=f, spa_modes=sp,
              comp=cp + (sr,), **kw),
          n_values=0, iters=3, phase=9, inputs=inputs + list(cots) + [sk],
          flops=trunk_flops(ws, N_SAMPLES, n_heads(kw), density_grad=dg,
                            backward=True),
          f32_flops=f32_flops)
      del pack, sk, sr
    del segs, ws, bs, kw, cp
    torch.cuda.empty_cache()
  return results


SPATIAL_FLAGS = ('fuse_ipe_trig', 'fuse_compositing', 'fuse_lift')


def spatial_stage(fused_mlp, dev):
  """Phase 10: the flagship with all six fuse flags, served and trained
  through the kernels, against fused_trunk='off' and timed in turns
  against phase 8's model (the fused directional stage alone)."""
  from refnerf_tpu_torch.models import renderer
  from refnerf_tpu_torch.cameras import rays as rays_lib
  flags = FUSE + SPATIAL
  serve_launches, _ = serve(fused_mlp, dev, flags, phase=10,
                            kernels=SIX_SERVED)
  train_launches, step_s, (model, config, state, train_step, batch) = train(
      fused_mlp, dev, flags, phase=10, per_step=SIX_PER_STEP)

  six = {f: True for f in SPATIAL_FLAGS}
  dir_only = {f: False for f in SPATIAL_FLAGS}
  box = {'state': state}

  def step():
    box['state'], _ = train_step(box['state'], batch)

  times = in_turns(step, {'all six': (model, six),
                          'phase 8': (model, dir_only)})
  rays = random_rays(rays_lib, 4096, config, 1, dev)
  request = lambda: renderer.render_rays(model, rays,
                                         config.render_chunk_size)
  with torch.no_grad():
    rtimes = in_turns(request, {
        'all six': (model, {**six, 'fused_trunk': 'auto'}),
        'phase 8': (model, {**dir_only, 'fused_trunk': 'auto'}),
        'off': (model, {**six, 'fused_trunk': 'off'})})
  med = lambda v: float(np.median(v)) * 1e3
  log('phase 10: train step in turns (all six, phase 8, phase 8, all six; '
      '5 steps a block): ' + ', '.join(
          f'{a} {med(v):.2f} ms median [{min(v) * 1e3:.2f}, '
          f'{max(v) * 1e3:.2f}]' for a, v in times.items()))
  log('phase 10: 4096-ray request in turns (5 requests a block): ' +
      ', '.join(f'{a} {med(v):.2f} ms median [{min(v) * 1e3:.2f}, '
                f'{max(v) * 1e3:.2f}]' for a, v in rtimes.items()))
  set_mode(model, fused_trunk='auto', **six)
  with torch.no_grad():
    profile(request, 'all-six 4096-ray request', 3, phase=10)
  profile(step, 'all-six train step', 2, phase=10)
  return serve_launches, train_launches, step_s, {
      'step_six_ms': med(times['all six']),
      'step_phase8_ms': med(times['phase 8']),
      'request_six_ms': med(rtimes['all six']),
      'request_phase8_ms': med(rtimes['phase 8']),
      'request_off_ms': med(rtimes['off'])}


# Phase 11: (name, (trunk in TRUNKS, backward)) of each mip-NeRF case.
# 'K11' is the spatial trunk with y out; 'K1 hf=0' and 'K4 first-order'
# the shipped gin's spatial trunk with its bottleneck.
MIP_CASES = (('K11', ('mip K11', False)),
             ('K11 backward', ('mip K11', True)),
             ('K2 W128', ('mip K2', False)),
             ('K5 W128', ('mip K2', True)),
             ('K1 hf=0', ('mip K1', False)),
             ('K4 first-order', ('mip K1', True)))
# Phase 11's forwards off FWD_ROUTE, and the forwards it runs twice more
# (bit-identical): the two-tile width-128 ones and K11's TMA store of y.
MIP_FWD_ROUTE = {('K11', 'float32'): 'trunk_fwd'}
MIP_RERUN = (('K2 W128', 'float32'), ('K2 W128', 'bfloat16'),
             ('K11', 'bfloat16'))


def y_faults(fused_mlp, cdt, cs, ws, bs, kw, y):
  """What two faults of K11's y would read on the plain y, by relative L2:
  the last layer's bias dropped, and y stored before the last ReLU. Fails
  unless both read above Y_BOUND, so that y's check would see either."""
  ref = lambda w, b: fused_mlp.trunk_reference(cs, w, b, compute_dtype=cdt,
                                               out_y=True, **kw)[0]
  l2 = lambda f: ((f.float() - y.float()).norm() / y.float().norm()).item()
  nobias = l2(ref(ws, bs[:-1] + [bs[-1] * 0]))
  pre = l2(ref(ws[:-1], bs[:-1]).float() @ ws[-1].t() + bs[-1])
  log(f'phase 11: K11 {cdt}: a fault in y would read {nobias:.3e} (no last '
      f'bias), {pre:.3e} (before the last ReLU), relative L2; rms y '
      f'{y.float().square().mean().sqrt().item():.3e}, max |y| '
      f'{y.float().abs().max().item():.3e}, bound {Y_BOUND[cdt]:.0e}')
  if not min(nobias, pre) > Y_BOUND[cdt]:
    raise AssertionError(f'K11 {cdt}: y\'s bound does not see a fault of '
                         'its store')


def check_mip_kernels(fused_mlp, dev):
  """Phase 11: K11 forward and backward, K2 and K5 at width 128, K1 with
  hf = 0 and the first-order K4 against their plain versions, f32 and
  bf16, each route asserted. Forward values by KERNEL_BOUND, K11's y by
  Y_BOUND, derivatives by GRAD_BOUND."""
  gen = torch.Generator().manual_seed(SEED + 4)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  results = {}
  for which, (trunk, backward) in MIP_CASES:
    spatial = trunk != 'mip K2'
    segs, ws, bs, kw = trunk_case(trunk, gen, dev, ipe=spatial)
    out_y = trunk == 'mip K11'
    heads = n_heads(kw)
    # Cotangents of (sigma, the f32 head, the bottleneck, u) and of y.
    if spatial:
      cots = (rand(N_SAMPLES), None,
              rand(N_SAMPLES, 128) if kw['head_cdt'] else None, None)
    else:
      cots = (None, rand(N_SAMPLES, 3), None, None)
    ybar = rand(N_SAMPLES, 256) if out_y and backward else None
    for cdt in ('float32', 'bfloat16'):
      cs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
      pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in cs],
                                  compute_dtype=cdt, **kw)
      inputs = cs + pack_tensors(pack)
      if not backward:
        # K11 in f32 stays on trunk_fwd.cu (MIP_FWD_ROUTE).
        check_route(fused_mlp, which, cdt, pack,
                    MIP_FWD_ROUTE.get((which, cdt)), out_y=out_y)
        kernel = lambda: fused_mlp.trunk_kernel(cs, pack, out_y=out_y)
        plain = lambda: fused_mlp.trunk_reference(
            cs, ws, bs, compute_dtype=cdt, out_y=out_y, **kw)
        results[which, cdt] = compare(
            which, cdt, kernel, plain, n_values=3, phase=11, inputs=inputs,
            flops=trunk_flops(ws, N_SAMPLES, heads),
            y=0 if out_y else None)
        if out_y:
          with torch.no_grad():
            y_faults(fused_mlp, cdt, cs, ws, bs, kw, plain()[0])
        if (which, cdt) in MIP_RERUN:
          deterministic(which, kernel, phase=11, cdt=cdt)
        continue
      yb = None if ybar is None else ybar.to(fused_mlp.DTYPES[cdt])
      route = fused_mlp.backward_library(pack)
      if route != BWD_ROUTE[cdt]:
        raise AssertionError(f'{which} {cdt}: the backward routed to {route}')
      kernel = lambda: fused_mlp.trunk_backward_kernel(
          cs, pack, cots, needs_dx=not spatial, ybar=yb)
      results[which, cdt] = compare(
          which, cdt, kernel,
          lambda: fused_mlp.trunk_backward_reference(
              cs, ws, bs, cots, compute_dtype=cdt, needs_dx=not spatial,
              ybar=yb, **kw),
          n_values=0, iters=3, phase=11,
          inputs=inputs + list(cots) + [yb],
          flops=trunk_flops(ws, N_SAMPLES, heads, backward=True,
                            needs_dx=not spatial))
      if which == 'K5 W128':
        deterministic(which, kernel, phase=11, cdt=cdt)
      del pack
    del segs, ws, bs, kw, cots, ybar
    torch.cuda.empty_cache()
  return results


NO_VIEWDIRS = ['Model.use_viewdirs = False']
# The kernels a request of phase 10's and phase 14's model runs (all six
# fuse flags), each levels x chunks times.
SIX_SERVED = ('K1', 'K2', 'K6', 'K7', 'K8', 'K9', 'K10')
# Launches a level and train step of phase 10's and phase 13's model (all six
# fuse flags).
SIX_PER_STEP = {'K2': 1, 'K3': 1, 'K4': 1, 'K5': 1, 'K6': 2, 'K7': 2,
                'K8': 2, 'K9': 2, 'K10': 2}


# Launches a level and train step of mip-NeRF as shipped (phases 12, 15).
MIP_PER_STEP = {'K1': 1, 'K2': 1, 'K4': 1, 'K5': 1}


def w128_backward(prof, phase, kernel):
  """Phases 12 and 15: the step's profile shows K5 at width 128 on the
  width-128 instance of `kernel` and no width-128 instance of trunk_bwd.cu
  (the design the two-tile kernels replaced), or this fails."""
  names = list((prof or {}).get('kernels', {}))
  # 128 may be followed by template arguments at their defaults (false).
  new = [n for n in names
         if re.search(rf'\b{kernel}<[^>]*\b128(, false)*>', n)]
  old = [n for n in names if re.search(r'\btrunk_bwd_kernel<[^,]*, 128\b', n)]
  if prof is None or not new or old:
    raise AssertionError(f'phase {phase}: K5 at width 128 ran {names}: '
                         f'{kernel} width 128 {new}, trunk_bwd.cu {old}')


def mip_stage(fused_mlp, dev):
  """Phase 12: configs/blender_mipnerf.gin as shipped and with
  Model.use_viewdirs = False, each served (three requests) and trained
  (10 steps) through the kernels against fused_trunk='off', and one
  4096-ray request and one step of each profiled. Returns, per run,
  (request launches, step launches, seconds a step, request ms)."""
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.models import renderer
  runs = {'shipped': ((), ('K1', 'K2'), MIP_PER_STEP),
          'no viewdirs': (NO_VIEWDIRS, ('K1', 'K11'),
                          {'K1': 1, 'K4': 1, 'K11': 2})}
  out = {}
  for run, (bindings, kernels, per_step) in runs.items():
    timings = {}
    serve_launches, _ = serve(fused_mlp, dev, bindings, phase=12,
                              kernels=kernels, gin_name=MIPNERF,
                              timings=timings)
    train_launches, step_s, (model, config, state, train_step, batch) = train(
        fused_mlp, dev, bindings, phase=12, per_step=per_step,
        gin_name=MIPNERF)
    box = {'state': state}

    def step():
      box['state'], _ = train_step(box['state'], batch)

    rays = random_rays(rays_lib, 4096, config, 1, dev)
    request = lambda: renderer.render_rays(model, rays,
                                           config.render_chunk_size)
    with torch.no_grad():
      rprof = profile(request, f'mip-NeRF {run} 4096-ray request', 3,
                      phase=12)
    prof = profile(step, f'mip-NeRF {run} train step', 2, phase=12)
    if run == 'shipped':
      w128_backward(prof, 12, 'trunk_bwd_tma_kernel')
    for pr in (rprof, prof):
      new_kernels(pr, 12, ('trunk_fwd_tma_kernel',), '__nv_bfloat16')
    out[run] = (serve_launches, train_launches, step_s, timings)
    del model, state, train_step, batch, box
    torch.cuda.empty_cache()
  return out


def f32_stage(fused_mlp, dev):
  """Phase 13: configs/blender_refnerf.gin in its own float32 (no
  compute_dtype binding) with all six fuse flags, trained at batch
  TRAIN_BATCH through the kernels (the backwards on trunk_bwd_f32.cu)
  against fused_trunk='off', and one step profiled. Returns (launches,
  seconds a step)."""
  launches, step_s, (model, _, state, train_step, batch) = train(
      fused_mlp, dev, FUSE + SPATIAL, phase=13, per_step=SIX_PER_STEP,
      dtype=None)
  if model.nerf_mlp.cfg.compute_dtype != 'float32':
    raise AssertionError('phase 13: the shipped gin did not train in float32')
  box = {'state': state}

  def step():
    box['state'], _ = train_step(box['state'], batch)

  prof = profile(step, 'float32 all-six train step', 2, phase=13)
  new_kernels(prof, 13, ('trunk_fwd_f32_kernel', 'trunk_bwd_f32_kernel'))
  del model, state, train_step, batch, box
  torch.cuda.empty_cache()
  return launches, step_s


def mip_f32_stage(fused_mlp, dev):
  """Phase 15: configs/blender_mipnerf.gin as shipped in its own float32
  (no compute_dtype binding), trained at batch TRAIN_BATCH through the
  kernels (K5 at width 128 on trunk_bwd_f32.cu, the forwards on
  trunk_fwd_f32.cu) against fused_trunk='off', and one step profiled; then
  serving as phase 14. Returns (step launches, seconds a step, the step's
  profile, request launches, the requests' latency)."""
  launches, step_s, (model, _, state, train_step, batch) = train(
      fused_mlp, dev, (), phase=15, per_step=MIP_PER_STEP, gin_name=MIPNERF,
      dtype=None)
  if model.nerf_mlp.cfg.compute_dtype != 'float32':
    raise AssertionError('phase 15: the shipped gin did not train in float32')
  box = {'state': state}

  def step():
    box['state'], _ = train_step(box['state'], batch)

  prof = profile(step, 'mip-NeRF float32 train step', 2, phase=15)
  w128_backward(prof, 15, 'trunk_bwd_f32_kernel')
  new_kernels(prof, 15, ('trunk_fwd_f32_kernel', 'trunk_bwd_f32_kernel'))
  del model, state, train_step, batch, box
  torch.cuda.empty_cache()
  serve_launches, request = f32_serve_stage(
      fused_mlp, dev, phase=15, gin_name=MIPNERF, bindings=(),
      kernels=('K1', 'K2'))
  return launches, step_s, prof, serve_launches, request


def new_kernels(prof, phase, need, dtype='float'):
  """Phases 12-15: the profile shows each kernel named in `need` and no
  `dtype` instance of trunk_fwd.cu (the forward that the FMA/TMA and
  wgmma/TMA kernels replaced: in f32 everywhere, in bf16 on mip-NeRF's K2
  at width 128 and K11), or this fails."""
  names = list((prof or {}).get('kernels', {}))
  missing = [k for k in need if not any(k in n for n in names)]
  old = [n for n in names if f'trunk_fwd_kernel<{dtype}' in n]
  if prof is None or missing or old:
    raise AssertionError(f'phase {phase}: the path ran {names}: missing '
                         f'{missing}, trunk_fwd.cu {dtype} {old}')


def f32_serve_stage(fused_mlp, dev, requests=30, phase=14, gin_name=FLAGSHIP,
                    bindings=FUSE + SPATIAL, kernels=SIX_SERVED):
  """Phase 14: configs/blender_refnerf.gin in its own float32 with all six
  fuse flags (phase 15: configs/blender_mipnerf.gin as shipped) serves
  three requests through the kernels (the forwards on trunk_fwd_f32.cu)
  against fused_trunk='off'; then the latency of `requests` 4096-ray
  requests and one request profiled. Returns (the launches, {median_ms,
  p90_ms, busy_ms})."""
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.models import renderer
  launches, (model, config) = serve(fused_mlp, dev, bindings, phase=phase,
                                    kernels=kernels, gin_name=gin_name,
                                    dtype=None)
  if model.nerf_mlp.cfg.compute_dtype != 'float32':
    raise AssertionError(f'phase {phase}: the shipped gin did not serve in '
                         'float32')
  rays = random_rays(rays_lib, 4096, config, 1, dev)
  request = lambda: renderer.render_rays(model, rays,
                                         config.render_chunk_size)
  times = []
  with torch.no_grad():
    request()
    for _ in range(requests):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      request()
      torch.cuda.synchronize()
      times.append((time.perf_counter() - t0) * 1e3)
    prof = profile(request, f'float32 {gin_name} 4096-ray request', 3,
                   phase=phase)
  new_kernels(prof, phase, ('trunk_fwd_f32_kernel',))
  out = dict(median_ms=float(np.median(times)),
             p90_ms=float(np.percentile(times, 90)), busy_ms=prof['busy_ms'])
  log(f'phase {phase}: {requests} 4096-ray requests: median '
      f'{out["median_ms"]:.2f} '
      f'ms, p90 {out["p90_ms"]:.2f} ms [{min(times):.2f}, {max(times):.2f}], '
      f'device busy {out["busy_ms"]:.2f} ms a request')
  del model
  torch.cuda.empty_cache()
  return launches, out


# Phase 16: the flagship trained and evaluated from a scene on disk. The
# scene: nerf_synthetic's resolution (800 x 800; 20 train and 4 test views,
# against its 100 train views, to fit the time limit) of
# tools/make_sphere_scene.py's analytic sphere.
SCENE_RES, SCENE_TRAIN, SCENE_TEST = 800, 20, 4
DATA_WARMUP, DATA_STEPS, DATA_F32_STEPS = 3, 10, 5
# The cast on the card vs the CPU: both f32, the 3x3 products as products
# and a sum, in another order.
CAST_BOUND = 1e-5
# PSNR (dB) and SSIM of the same images on the card vs the CPU (f32 sums
# in another order; color_correct in float64).
PSNR_BOUND, SSIM_BOUND = 1e-4, 1e-5


def packages():
  """Which of Pillow, scipy and matplotlib import here."""
  import importlib
  out = {}
  for name in ('PIL', 'scipy', 'matplotlib'):
    try:
      out[name] = getattr(importlib.import_module(name), '__version__', '?')
    except ImportError:
      out[name] = None
  return out


def _png_rows(img, kind):
  """An 8-bit RGBA PNG of img with every row under filter `kind` (3,
  Average, or 4, Paeth; the encoder's side, vectorised)."""
  import struct
  import zlib
  h, w, bpp = img.shape
  x = img.reshape(h, -1).astype(np.int32)
  a, b, c = (np.zeros_like(x) for _ in range(3))
  a[:, bpp:], b[1:], c[1:, bpp:] = x[:, :-bpp], x[:-1], x[:-1, :-bpp]
  if kind == 3:
    pred = (a + b) // 2
  else:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
  raw = np.concatenate([np.full((h, 1), kind), (x - pred) % 256], axis=1)

  def chunk(tag, body):
    return (struct.pack('>I', len(body)) + tag + body +
            struct.pack('>I', zlib.crc32(tag + body) & 0xFFFFFFFF))
  return (b'\x89PNG\r\n\x1a\n' +
          chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 6, 0, 0, 0)) +
          chunk(b'IDAT', zlib.compress(raw.astype(np.uint8).tobytes())) +
          chunk(b'IEND', b''))


def png_read_ms(root):
  """One 800 x 800 RGBA train view read by `utils.io.read_image` (through
  Pillow where it imports, as the loaders read it) and by the port's codec
  (its path without Pillow): as the scene writes it (filter 0), and with
  every row under Average and under Paeth, the two filters the codec
  undoes byte by byte. Returns the milliseconds of each read."""
  import io as bytes_io
  from refnerf_tpu_torch.utils import io as io_lib

  def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3

  pth = os.path.join(root, 'r_train_0.png')
  with open(pth, 'rb') as f:
    plain = f.read()
  io_lib.read_image(pth)  # imports Pillow, if any, untimed
  img, read_ms = timed(lambda: io_lib.read_image(pth))
  out = dict(png_read_ms=read_ms)
  for name, kind in (('filter 0', 0), ('average', 3), ('paeth', 4)):
    buf = plain if kind == 0 else _png_rows(img, kind)
    decoded, out[f'png_codec_{name.replace(" ", "")}_ms'] = timed(
        lambda: io_lib.decode_png(buf))
    if not np.array_equal(decoded, img):
      raise AssertionError(f'phase 16: the PNG codec misreads {name} rows')
    if kind:
      try:
        from PIL import Image
      except ImportError:
        continue
      if not np.array_equal(np.array(Image.open(bytes_io.BytesIO(buf))), img):
        raise AssertionError(f'phase 16: Pillow reads the {name} rows '
                             'otherwise')
  log(f'phase 16: PNG {img.shape}: read_image {read_ms:.1f} ms; the codec '
      f"{out['png_codec_filter0_ms']:.1f} ms as written (filter 0), "
      f"{out['png_codec_average_ms']:.1f} ms with every row Average, "
      f"{out['png_codec_paeth_ms']:.1f} ms with every row Paeth")
  return out


def data_setup(dev, root, dtype):
  """The flagship with all six fuse flags (trunks in `dtype`, as
  `flagship`) at batch TRAIN_BATCH with bench.py's bindings, reading the
  scene at `root` as the gin says (`batching = 'single_image'`,
  `cast_rays_in_train_step`). Returns a dict: model, config, the train
  dataset `ds` (and `load_s`, the seconds to load it), its cameras on the
  card and the cast."""
  from refnerf_tpu_torch.cameras import camera_utils
  from refnerf_tpu_torch.data import datasets
  model, config = flagship(dev, [
      f'Config.batch_size = {TRAIN_BATCH}', 'Config.randomized = False',
      'Config.sample_noise_size = 0', f"Config.data_dir = '{root}'",
      *FUSE, *SPATIAL], FLAGSHIP, dtype)
  if not (config.batching == 'single_image' and
          config.cast_rays_in_train_step):
    raise AssertionError('phase 16: the gin no longer casts single-image '
                         'batches in the step')
  t0 = time.perf_counter()
  ds = datasets.load_dataset('train', root, config)
  load_s = time.perf_counter() - t0
  return dict(model=model, config=config, ds=ds, load_s=load_s,
              cameras=ds.device_cameras(dev),
              cast=lambda cams, pix: camera_utils.cast_ray_batch(
                  cams, pix, ds.camtype))


def check_cast(ds, cameras, cast, dev):
  """One batch of Pixels cast on the card against the CPU cast."""
  batch = next(ds)
  gpu = cast(cameras, batch.rays.map(lambda x: x.to(dev)))
  cpu = cast(ds.device_cameras('cpu'), batch.rays)
  errs = {k: (getattr(gpu, k).cpu() - getattr(cpu, k)).abs().max().item()
          for k in ('origins', 'directions', 'viewdirs')}
  errs['radii (relative)'] = ((gpu.radii.cpu() - cpu.radii).abs() /
                              cpu.radii.abs()).max().item()
  log(f'phase 16: {batch.rays.shape[0]} pixels cast on the card vs the CPU: '
      + ', '.join(f'{k} {v:.3e}' for k, v in errs.items()) +
      f' (bound {CAST_BOUND})')
  if not all(v <= CAST_BOUND for v in errs.values()):
    raise AssertionError('phase 16: the cast on the card disagrees')


def step_against_plain(fused_mlp, model, train_step, state, batch, cameras,
                       what):
  """One step's loss and gradient norm through the kernels against
  fused_trunk='off' on the same batch and state."""
  from refnerf_tpu_torch.train import step as step_lib
  loss_k, _, grads_k = train_step.loss_and_grads(state, batch, cameras)
  norm_k = step_lib.global_norm(grads_k.values()).item()
  del grads_k
  set_mode(model, fused_trunk='off')
  before = dict(fused_mlp.launches)
  loss_p, _, grads_p = train_step.loss_and_grads(state, batch, cameras)
  norm_p = step_lib.global_norm(grads_p.values()).item()
  del grads_p
  set_mode(model, fused_trunk='auto')
  if fused_mlp.launches != before:
    raise AssertionError("fused_trunk='off' launched a kernel")
  dl = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
  dn = abs(norm_k - norm_p) / norm_p
  log(f"phase 16: {what} step {state.step} from disk, kernels vs "
      f"fused_trunk='off': loss {loss_k.item():.6g} vs {loss_p.item():.6g} "
      f'(rel {dl:.2e}, bound {TRAIN_LOSS_BOUND}), grad norm {norm_k:.6g} vs '
      f'{norm_p:.6g} (rel {dn:.2e}, bound {TRAIN_GNORM_BOUND})')
  if not (dl <= TRAIN_LOSS_BOUND and dn <= TRAIN_GNORM_BOUND):
    raise AssertionError('phase 16: the kernel step disagrees with the plain '
                         'one')


def train_from_disk(fused_mlp, dev, root, dtype, steps):
  """Train steps from prefetched batches (`training_batches` as shipped:
  sampled on this thread, copied by device_prefetch), rays cast in the step: warm-up, then `steps` timed;
  each kernel must run levels x steps x its SIX_PER_STEP count. Returns
  data_setup's dict with the launches, seconds a step, the state, the step
  and one more batch on the card."""
  from refnerf_tpu_torch.data import prefetch
  from refnerf_tpu_torch.train import step as step_lib
  run = data_setup(dev, root, dtype)
  model, cameras = run['model'], run['cameras']
  state = step_lib.create_train_state(run['config'], model)
  train_step = step_lib.make_train_step(model, run['config'], run['cast'])
  batches = prefetch.training_batches(run['ds'], device=dev)
  try:
    for _ in range(DATA_WARMUP):
      state, _ = train_step(state, next(batches), cameras)
    torch.cuda.synchronize()
    for k in fused_mlp.launches:
      fused_mlp.launches[k] = 0
    t0 = time.perf_counter()
    for _ in range(steps):
      state, stats = train_step(state, next(batches), cameras)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    launches = dict(fused_mlp.launches)
    batch = next(batches)
  finally:
    batches.close()
  want = {k: model.cfg.num_levels * steps * SIX_PER_STEP.get(k, 0)
          for k in launches}
  if launches != want:
    raise AssertionError(f'phase 16: train launches {launches}, expected '
                         f'{want}')
  if not torch.isfinite(stats['loss']):
    raise AssertionError('phase 16: the loss is not finite')
  log(f'phase 16: {model.nerf_mlp.cfg.compute_dtype} trunks, {steps} steps '
      f'from disk after {DATA_WARMUP} warm-up: {dt * 1e3:.2f} ms/step, '
      f'{TRAIN_BATCH / dt:.0f} train rays/s; step {state.step}: loss '
      f'{stats["loss"].item():.6g}, psnr {stats["psnr"].item():.3f}; '
      f'launches {launches}')
  run.update(launches=launches, step_s=dt, state=state,
             train_step=train_step, batch=batch)
  return run


def data_path_cost(fused_mlp, dev, run):
  """The data path's cost a step, in turns (5 steps a block, each arm four
  times, in the order given, reversed, given and reversed): steps from
  prefetched batches of the scene as `training_batches` ships them (sampled
  on this thread), from the same pipeline with a sampler thread
  (threaded=True), from one batch of Pixels kept on the card (the cast
  alone), and phase 10's steps on one batch of random rays; the sampler's
  host ms a batch; 5 steps from disk and 5 on random rays profiled. Returns
  the medians and the profiles' numbers."""
  import copy
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.data import prefetch
  config, train_step, cameras, ds = (run[k] for k in (
      'config', 'train_step', 'cameras', 'ds'))
  rng = np.random.RandomState(0)
  d = rng.randn(TRAIN_BATCH, 3).astype(np.float32)
  rays = rays_from(rays_lib, rng.randn(TRAIN_BATCH, 3).astype(np.float32) * 0.1,
                   d, np.full((TRAIN_BATCH, 1), 0.001, np.float32), config,
                   dev)
  rays.lossmult = torch.ones(TRAIN_BATCH, 1, device=dev)
  random_batch = rays_lib.Batch(rays=rays, rgb=torch.from_numpy(
      rng.uniform(0, 1, (TRAIN_BATCH, 3)).astype(np.float32)).to(dev))
  box = {'state': run['state']}
  batches = prefetch.training_batches(ds, device=dev)
  # A second stream of the same images, its own batch index.
  threaded = prefetch.training_batches(copy.copy(ds), device=dev,
                                       threaded=True)
  pixels_batch = next(batches)
  arms = {
      'disk': lambda: train_step(box['state'], next(batches), cameras),
      'disk, sampler thread': lambda: train_step(box['state'], next(threaded),
                                                 cameras),
      'pixels on the card': lambda: train_step(box['state'], pixels_batch,
                                               cameras),
      'random rays': lambda: train_step(box['state'], random_batch)}
  order = list(arms) + list(arms)[::-1]
  times = {a: [] for a in arms}
  profs = {}
  try:
    for a in order:
      box['state'], _ = arms[a]()
      for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box['state'], _ = arms[a]()
        torch.cuda.synchronize()
        times[a].append(time.perf_counter() - t0)
    for a in ('disk', 'random rays'):
      for k in fused_mlp.launches:
        fused_mlp.launches[k] = 0

      def step():
        box['state'], _ = arms[a]()
      profs[a] = profile(step, f'train step, {a}', 5, phase=16)
      if profs[a] is None:
        raise AssertionError('phase 16: the profiler saw no device time')
      if a == 'disk':
        launches = dict(fused_mlp.launches)
  finally:
    batches.close()
    threaded.close()
  run['state'] = box['state']
  # The sampler's host time a batch, on this thread.
  t0 = time.perf_counter()
  for _ in range(20):
    next(ds)
  host_ms = (time.perf_counter() - t0) / 20 * 1e3
  med = {a: float(np.median(v)) * 1e3 for a, v in times.items()}
  log(f'phase 16: bf16 train step in turns ({", ".join(order)}; 5 steps a '
      'block): ' + ', '.join(
          f'{a} {med[a]:.2f} ms median [{min(v) * 1e3:.2f}, '
          f'{max(v) * 1e3:.2f}]' for a, v in times.items()) +
      f'; the data path costs {med["disk"] - med["random rays"]:.2f} ms a '
      f'step, a sampler thread '
      f'{med["disk, sampler thread"] - med["disk"]:.2f} ms more; the sampler '
      f'{host_ms:.3f} host ms a batch; launches in the 6 profiled steps from '
      f'disk (one untimed): { {k: v for k, v in launches.items() if v} }')
  idle = lambda p: 1 - p['busy_ms'] / p['wall_ms']
  return dict(step_disk_ms=med['disk'],
              step_threaded_ms=med['disk, sampler thread'],
              step_pixels_ms=med['pixels on the card'],
              step_random_ms=med['random rays'], sampler_host_ms=host_ms,
              busy_ms=profs['disk']['busy_ms'],
              wall_ms=profs['disk']['wall_ms'], idle=idle(profs['disk']),
              random_busy_ms=profs['random rays']['busy_ms'],
              random_wall_ms=profs['random rays']['wall_ms'],
              random_idle=idle(profs['random rays']))


def prefetch_is_exact(dev, root, run):
  """Prefetched batches against the same batches copied to the card
  synchronously: every tensor and the step's loss, bit for bit."""
  from refnerf_tpu_torch.data import datasets
  from refnerf_tpu_torch.data import prefetch
  config, state, train_step, cameras = (run[k] for k in (
      'config', 'state', 'train_step', 'cameras'))
  fetched = prefetch.training_batches(datasets.load_dataset('train', root,
                                                            config), device=dev)
  direct = datasets.load_dataset('train', root, config)
  try:
    for i in range(3):
      a, b = next(fetched), next(direct).map(lambda x: x.to(dev))
      pairs = list(zip(_tensors(a), _tensors(b)))
      same = all(torch.equal(x, y) for x, y in pairs)
      la = train_step.loss_and_grads(state, a, cameras)[0]
      lb = train_step.loss_and_grads(state, b, cameras)[0]
      if not (same and torch.equal(la, lb)):
        raise AssertionError(f'phase 16: batch {i}: prefetched (loss '
                             f'{la.item()!r}) and synchronous (loss '
                             f'{lb.item()!r}) differ')
  finally:
    fetched.close()
  log('phase 16: 3 prefetched batches vs the same batches copied '
      'synchronously: every tensor and the losses bit-identical')


def _tensors(batch):
  out = []
  batch.map(lambda x: out.append(x) or x)
  return out


def evaluate(fused_mlp, dev, model, config, test_ds, views, what):
  """Render test views at full resolution with the extras, the first also
  with fused_trunk='off'; PSNR, SSIM and cc-PSNR on the card and again on
  the CPU. Returns (seconds a view, K1 launches, the metrics)."""
  from refnerf_tpu_torch import metrics
  from refnerf_tpu_torch.models import renderer
  chunk = config.render_chunk_size
  harness = metrics.MetricHarness(device=dev)
  host_harness = metrics.MetricHarness(device='cpu')
  out, seconds = [], []
  for i in views:
    batch = test_ds.generate_ray_batch(i)
    rays = batch.rays.map(lambda x: x.to(dev))
    before = fused_mlp.launches['K1']
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = renderer.render_image(model, rays, chunk, compute_extras=True,
                                vis_num_rays=config.vis_num_rays)
    seconds.append(time.perf_counter() - t0)
    h, w = rays.shape
    want_k1 = model.cfg.num_levels * -(-h * w // chunk)
    if fused_mlp.launches['K1'] - before != want_k1:
      raise AssertionError(f'phase 16: view {i}: K1 ran '
                           f'{fused_mlp.launches["K1"] - before} times, '
                           f'expected {want_k1}')
    check_rendering(img, (h, w), config, model.nerf_mlp.cfg.rgb_padding)
    if not torch.isfinite(img['distance_median']).all():
      raise AssertionError('phase 16: distance_median is not finite')
    bundles = [img[k] for k in ('ray_sdist', 'ray_weights', 'ray_rgbs')]
    if not all(len(b) == model.cfg.num_levels and
               b[0].shape[0] == config.vis_num_rays for b in bundles):
      raise AssertionError('phase 16: the ray bundles are missing')
    if not out:
      set_mode(model, fused_trunk='off')
      plain = renderer.render_image(model, rays, chunk, compute_extras=True,
                                    vis_num_rays=config.vis_num_rays)
      set_mode(model, fused_trunk='auto')
      diff = {k: (plain[k] - img[k]).abs().max().item()
              for k in ('rgb', 'acc')}
      log(f"phase 16: {what} view {i} vs fused_trunk='off': max |rgb| diff "
          f"{diff['rgb']:.3e}, max |acc| diff {diff['acc']:.3e} (bound "
          f'{PATH_BOUND})')
      if not all(v <= PATH_BOUND for v in diff.values()):
        raise AssertionError('phase 16: the kernel render disagrees')
    # render_image returns host tensors: each harness copies them to its
    # device.
    card = metrics.eval_metrics(harness, img['rgb'], batch.rgb, config)
    if card[2].device.type != 'cuda':
      raise AssertionError('phase 16: the metrics did not run on the card')
    host = metrics.eval_metrics(host_harness, img['rgb'], batch.rgb, config)
    d_psnr = max(abs(card[j]['psnr'] - host[j]['psnr']) for j in (0, 1))
    d_ssim = max(abs(card[j]['ssim'] - host[j]['ssim']) for j in (0, 1))
    log(f'phase 16: {what} view {i} ({w} x {h}): {seconds[-1]:.2f} s, '
        f'{h * w / seconds[-1]:.0f} rays/s; on the card psnr '
        f'{card[0]["psnr"]:.4f}, ssim {card[0]["ssim"]:.5f}, cc-psnr '
        f'{card[1]["psnr"]:.4f}; card vs CPU: psnr {d_psnr:.2e} dB (bound '
        f'{PSNR_BOUND}), ssim {d_ssim:.2e} (bound {SSIM_BOUND}); '
        f'distance_median [{img["distance_median"].min().item():.3f}, '
        f'{img["distance_median"].max().item():.3f}]')
    if not (d_psnr <= PSNR_BOUND and d_ssim <= SSIM_BOUND):
      raise AssertionError('phase 16: the metrics on the card disagree with '
                           'the CPU')
    out.append({'psnr': card[0]['psnr'], 'ssim': card[0]['ssim'],
                'cc_psnr': card[1]['psnr']})
  return float(np.mean(seconds)), out


def data_stage(fused_mlp, dev):
  """Phase 16: write a Blender-format scene, load it, train the flagship
  from it (bf16 and f32, rays cast in the step) and evaluate test views
  with the extras and metrics. Returns (the path's launches: K2-K10 of the
  bf16 steps, K1 of the bf16 views; a summary)."""
  import shutil
  import tempfile
  from refnerf_tpu_torch.data import datasets
  from refnerf_tpu_torch.tools import sphere_scene
  log(f'phase 16: packages here: {json.dumps(packages())}')
  root = tempfile.mkdtemp(prefix='refnerf_scene_')
  try:
    t0 = time.perf_counter()
    sphere_scene.make_scene(root, SCENE_TRAIN, SCENE_TEST, SCENE_RES)
    write_s = time.perf_counter() - t0
    png = png_read_ms(root)
    run = train_from_disk(fused_mlp, dev, root, 'bfloat16', DATA_STEPS)
    log(f'phase 16: scene of {SCENE_TRAIN} train + {SCENE_TEST} test views at '
        f'{SCENE_RES} x {SCENE_RES}: written in {write_s:.1f} s, train split '
        f'loaded in {run["load_s"]:.1f} s')
    path, step_ms = dict(run['launches']), run['step_s'] * 1e3
    check_cast(run['ds'], run['cameras'], run['cast'], dev)
    cost = data_path_cost(fused_mlp, dev, run)
    step_against_plain(fused_mlp, run['model'], run['train_step'],
                       run['state'], run['batch'], run['cameras'], 'bf16')
    prefetch_is_exact(dev, root, run)
    test_ds = datasets.load_dataset('test', root, run['config'])
    before = fused_mlp.launches['K1']
    view_s, views = evaluate(fused_mlp, dev, run['model'], run['config'],
                             test_ds, (0,), 'bf16')
    path['K1'] = fused_mlp.launches['K1'] - before
    del run
    torch.cuda.empty_cache()

    # The gin's own float32.
    run = train_from_disk(fused_mlp, dev, root, None, DATA_F32_STEPS)
    step_against_plain(fused_mlp, run['model'], run['train_step'],
                       run['state'], run['batch'], run['cameras'], 'f32')
    f32_view_s, f32_views = evaluate(fused_mlp, dev, run['model'],
                                     run['config'], test_ds, (2,), 'f32')
    f32_step_ms = run['step_s'] * 1e3
    del run
    torch.cuda.empty_cache()
  finally:
    shutil.rmtree(root, ignore_errors=True)
  missing = [k for k in ('K1', 'K2', 'K3', 'K4', 'K5', 'K6', 'K7', 'K8', 'K9',
                         'K10') if not path.get(k)]
  if missing:
    raise AssertionError(f'phase 16: the path never launched {missing}')
  summary = dict(write_s=write_s, **png, step_ms=step_ms,
                 f32_step_ms=f32_step_ms, view_s=view_s,
                 f32_view_s=f32_view_s, views=views + f32_views, **cost)
  log(f'phase 16: {json.dumps(summary)}')
  return path, summary


# Phase 17: the port's CLIs on configs/blender_refnerf.gin as shipped (f32,
# batch 1024, no fuse flags). The scene: the sphere at 50 train views (half
# nerf_synthetic's 100), at 400 x 400 (half its resolution, to fit the time
# limit), and 2 test views.
CLI_RES, CLI_TRAIN, CLI_TEST = 400, 50, 2
CLI_STEPS, CLI_EXIT = 10, 5
# Launches a level and step of the unfused flagship's train step.
CLI_PER_STEP = {'K2': 1, 'K3': 1, 'K4': 1, 'K5': 1}
# Eval's saved render (8-bit PNG, 0.5/255 of rounding) against the same view
# rendered in-process with fused_trunk='off'.
CLI_RENDER_BOUND = PATH_BOUND


class _Tee:
  """Writes to the real stdout and keeps a copy (the CLIs' own lines)."""

  def __init__(self, out):
    self.out, self.parts = out, []

  def write(self, s):
    self.parts.append(s)
    return self.out.write(s)

  def flush(self):
    self.out.flush()

  def text(self):
    return ''.join(self.parts)


def run_cli(main, argv):
  """main(argv) in this process: (its return value, its stdout, seconds)."""
  import contextlib
  tee = _Tee(sys.stdout)
  t0 = time.perf_counter()
  with contextlib.redirect_stdout(tee):
    out = main(argv)
  return out, tee.text(), time.perf_counter() - t0


def cli_tools():
  """Which of tensorboardX, torch.utils.tensorboard, ffmpeg and cv2 are
  here."""
  import importlib
  out = {}
  for name, mod in (('tensorboardX', 'tensorboardX'),
                    ('tensorboard', 'torch.utils.tensorboard'),
                    ('cv2', 'cv2')):
    try:
      m = importlib.import_module(mod)
      out[name] = getattr(m, '__version__', True)
    except ImportError:
      out[name] = None
  out['ffmpeg'] = shutil.which('ffmpeg')
  return out


def _routes(fused_mlp):
  """Record every library fused_mlp.forward_library and backward_library
  choose until the returned restore() is called."""
  seen = {'forward': set(), 'backward': set()}
  orig = fused_mlp.forward_library, fused_mlp.backward_library

  def fwd(*a, **k):
    route = orig[0](*a, **k)
    seen['forward'].add(route)
    return route

  def bwd(*a, **k):
    route = orig[1](*a, **k)
    seen['backward'].add(route)
    return route

  fused_mlp.forward_library, fused_mlp.backward_library = fwd, bwd

  def restore():
    fused_mlp.forward_library, fused_mlp.backward_library = orig
  return seen, restore


def cli_stage(fused_mlp, dev):
  """Phase 17: train (in-process, launches counted), kill and resume, eval
  (a subprocess, as the README runs it) and render through the port's CLIs.
  Returns (the train run's launches, a summary)."""
  import tempfile
  from refnerf_tpu_torch.cli import render as cli_render
  from refnerf_tpu_torch.cli import train as cli_train
  from refnerf_tpu_torch.data import datasets
  from refnerf_tpu_torch.models import renderer
  from refnerf_tpu_torch.tools import sphere_scene
  from refnerf_tpu_torch.train import checkpoints
  tools = cli_tools()
  log(f'phase 17: present here: {json.dumps(tools)}')
  repo = os.path.dirname(os.path.abspath(__file__))
  gin_file = os.path.join(repo, 'configs', FLAGSHIP)
  root = tempfile.mkdtemp(prefix='refnerf_cli_')
  try:
    t0 = time.perf_counter()
    scene = sphere_scene.make_scene(os.path.join(root, 'scene'), CLI_TRAIN,
                                    CLI_TEST, CLI_RES)
    write_s = time.perf_counter() - t0
    exp = os.path.join(root, 'exp')

    def argv(name, *more):
      bindings = [f"Config.data_dir = '{scene}'",
                  f"Config.checkpoint_dir = '{exp}'",
                  f"Config.exp_name = '{name}'",
                  f'Config.max_steps = {CLI_STEPS}',
                  f'Config.checkpoint_every = {CLI_EXIT}',
                  'Config.print_every = 5', 'Config.val_sample_num = 1',
                  'Config.eval_dataset_limit = 2', *more]
      return [f'--gin_configs={gin_file}'] + [
          f'--gin_bindings={b}' for b in bindings]

    # Run A: CLI_STEPS steps, validation and a checkpoint every CLI_EXIT,
    # its launches counted and each launch's library recorded; checkpoint
    # saves timed.
    save_ms = []
    save = checkpoints.CheckpointManager.save

    def timed_save(self, *a, **k):
      torch.cuda.synchronize()
      t = time.perf_counter()
      save(self, *a, **k)
      save_ms.append((time.perf_counter() - t) * 1e3)
    checkpoints.CheckpointManager.save = timed_save
    seen, restore = _routes(fused_mlp)
    try:
      for k in fused_mlp.launches:
        fused_mlp.launches[k] = 0
      run_a, out_a, train_s = run_cli(cli_train.main, argv('cli_a'))
      torch.cuda.synchronize()
      launches = dict(fused_mlp.launches)
    finally:
      restore()
      checkpoints.CheckpointManager.save = save
    config = run_a.config
    model = run_a.model
    cfg = model.nerf_mlp.cfg
    flags = [b.split('.', 1)[1].split(' = ')[0] for b in FUSE + SPATIAL]
    if (cfg.compute_dtype != 'float32' or cfg.fused_trunk != 'auto' or
        any(getattr(cfg, f) for f in flags)):
      raise AssertionError('phase 17: the shipped gin is not f32, unfused, '
                           "fused_trunk='auto'")
    if config.batch_size != 1024:
      raise AssertionError(f'phase 17: batch {config.batch_size}, not 1024')
    levels, h = model.cfg.num_levels, CLI_RES
    views = CLI_STEPS // CLI_EXIT  # validation at each checkpoint
    per_view = levels * -(-h * h // config.render_chunk_size)
    want = {k: levels * CLI_STEPS * CLI_PER_STEP.get(k, 0) for k in launches}
    want['K1'] += views * per_view
    want['K2'] += views * per_view
    if launches != want:
      raise AssertionError(f'phase 17: train launches {launches}, expected '
                           f'{want}')
    if seen != {'forward': {'trunk_fwd_f32'}, 'backward': {'trunk_bwd_f32'}}:
      raise AssertionError(f'phase 17: the trunks routed to {seen}')
    rays_line = [l for l in out_a.splitlines()
                 if l.startswith(f'step {CLI_STEPS}/')]
    if not rays_line or 'Resumed' in out_a:
      raise AssertionError('phase 17: no final step line from the train CLI')
    logs = os.listdir(os.path.join(exp, 'logs', 'cli', 'cli_a'))
    events = [n for n in logs if n.startswith('events.out.tfevents')]
    if 'config.gin' not in logs or (
        bool(events) != bool(tools['tensorboardX'] or tools['tensorboard'])):
      raise AssertionError(f'phase 17: the train CLI wrote {logs}')
    ckpt_a = checkpoints.checkpoint_dir(config)
    state_bytes = os.path.getsize(
        os.path.join(ckpt_a, 'last', str(CLI_STEPS), 'state.pt'))
    log(f'phase 17: train CLI {train_s:.1f} s; its line: {rays_line[0]}; '
        f'launches {launches} (K1, K2 in 2 validation views); forwards on '
        f'{sorted(seen["forward"])}, backwards on {sorted(seen["backward"])}; '
        f'checkpoint saves {", ".join(f"{m:.1f}" for m in save_ms)} ms, '
        f'{state_bytes} bytes each; the config snapshot and '
        f'{len(events)} TensorBoard event file(s) written')

    # Run B: killed at CLI_EXIT (an early exit), then resumed to CLI_STEPS.
    cut, _, cut_s = run_cli(
        cli_train.main, argv('cli_b', f'Config.early_exit_steps = {CLI_EXIT}'))
    if cut.state.step != CLI_EXIT:
      raise AssertionError(f'phase 17: the cut run stopped at step '
                           f'{cut.state.step}')
    del cut
    run_b, out_b, resume_s = run_cli(cli_train.main, argv('cli_b'))
    if f'Resumed from step {CLI_EXIT}' not in out_b:
      raise AssertionError('phase 17: the second run did not resume')
    diffs = []
    sd_a, sd_b = run_a.model.state_dict(), run_b.model.state_dict()
    for k, v in sd_a.items():
      if not torch.equal(sd_b[k], v):
        diffs.append((k, (sd_b[k] - v).abs().max().item()))
    for which in ('mu', 'nu'):
      for k, v in getattr(run_a.state.opt, which).items():
        other = getattr(run_b.state.opt, which)[k]
        if not torch.equal(other, v):
          diffs.append((f'{which} {k}', (other - v).abs().max().item()))
    if (run_b.state.step, run_b.state.opt.count) != (CLI_STEPS, CLI_STEPS):
      raise AssertionError('phase 17: the resumed run did not reach step '
                           f'{CLI_STEPS}')
    if diffs:
      worst = max(diffs, key=lambda d: d[1])
      raise AssertionError(f'phase 17: resume is not bit for bit: '
                           f'{len(diffs)} tensors differ, the largest {worst}')
    best = [n for n in os.listdir(os.path.join(
        checkpoints.checkpoint_dir(run_b.config), 'best')) if n.isdigit()]
    if len(best) > config.save_top_k:
      raise AssertionError(f'phase 17: best/ holds {best}')
    del run_b
    log(f'phase 17: run B: {cut_s:.1f} s to step {CLI_EXIT}, then '
        f'{resume_s:.1f} s resumed to {CLI_STEPS}; every parameter and Adam '
        f'moment equal to run A (torch.equal); best/ holds steps '
        f'{sorted(best, key=int)}')

    # Eval: a subprocess, as the README runs it.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'refnerf_tpu_torch.cli.eval'] + argv('cli_a'),
        cwd=repo, capture_output=True, text=True, timeout=600)
    eval_s = time.perf_counter() - t0
    if proc.returncode != 0:
      raise AssertionError(f'phase 17: eval failed: {proc.stderr[-3000:]}')
    preds = os.path.join(ckpt_a, 'test_preds')
    with open(os.path.join(preds, 'metric_psnr.txt')) as f:
      psnrs = [float(v) for v in f.read().split()]
    with open(os.path.join(preds, 'render_times.txt')) as f:
      view_s = [float(v) for v in f.read().split()]
    for name in ('metric_ssim.txt', 'metric_cc_psnr.txt', 'avg_metrics.txt'):
      if not os.path.exists(os.path.join(preds, name)):
        raise AssertionError(f'phase 17: eval wrote no {name}')
    if len(psnrs) != CLI_TEST or not np.all(np.isfinite(psnrs)):
      raise AssertionError(f'phase 17: eval PSNRs {psnrs}')
    test_ds = datasets.load_dataset('test', scene, config)
    rays = test_ds.generate_ray_batch(0).rays.map(lambda x: x.to(dev))
    set_mode(model, fused_trunk='off')
    before = dict(fused_mlp.launches)
    plain = renderer.render_image(model, rays, config.render_chunk_size,
                                  train_frac=1.0)['rgb']
    set_mode(model, fused_trunk='auto')
    if fused_mlp.launches != before:
      raise AssertionError("phase 17: fused_trunk='off' launched a kernel")
    from refnerf_tpu_torch.utils import io as io_lib
    saved = torch.from_numpy(io_lib.load_img(
        os.path.join(preds, 'color_000.png'))[..., :3] / 255.0)
    diff = (saved - plain.double()).abs().max().item()
    log(f'phase 17: eval CLI {eval_s:.1f} s (a subprocess); PSNR {psnrs}; '
        f's a view {view_s}; its view 0 vs fused_trunk=\'off\' in-process: '
        f'max |rgb| diff {diff:.3e} (bound {CLI_RENDER_BOUND})')
    if diff > CLI_RENDER_BOUND:
      raise AssertionError('phase 17: the eval render disagrees with plain')
    del run_a, model

    # Render, then render again: the frames already done are skipped.
    _, out_r, render_s = run_cli(cli_render.main, argv('cli_a'))
    frames = os.path.join(ckpt_a, f'test_preds_step_{CLI_STEPS}')
    for i in range(CLI_TEST):
      if not os.path.exists(os.path.join(frames, f'color_{i:03d}.png')):
        raise AssertionError(f'phase 17: render wrote no frame {i}')
    frame_s = [float(l.split(' in ')[1].rstrip('s'))
               for l in out_r.splitlines() if l.startswith('Rendered ')]
    writers = [l for l in out_r.splitlines() if l.startswith('Video writers')]
    if len(frame_s) != CLI_TEST or not writers:
      raise AssertionError('phase 17: render made no frames or no videos')
    _, out_r2, render2_s = run_cli(cli_render.main, argv('cli_a'))
    if 'Image 0/2 already exists, skipping' not in out_r2:
      raise AssertionError('phase 17: the second render did not skip')
    log(f'phase 17: render CLI {render_s:.1f} s, s a frame {frame_s}, '
        f'{writers[0]}; again {render2_s:.1f} s, frame 0 skipped')
  finally:
    shutil.rmtree(root, ignore_errors=True)
  summary = dict(tools=tools, scene_write_s=write_s, train_s=train_s,
                 train_line=rays_line[0], save_ms=save_ms,
                 state_bytes=state_bytes, cut_s=cut_s, resume_s=resume_s,
                 eval_s=eval_s, view_s=view_s, eval_psnr=psnrs,
                 eval_vs_plain=diff, render_s=render_s, frame_s=frame_s,
                 render_again_s=render2_s, writers=writers[0])
  return launches, summary


# Phase 18: the LLFF geometry gins. The scene: nerf_llff_data's fern has 20
# views; images_4/ at 1008 x 756 is the factor-4 size of a 4032 x 3024
# capture, which the gin's `factor = 4` reads.
GEO, FEW_SHOT = ('llff_refnerf_geometry_losses.gin',
                 'llff_srgb_multiray_128_4_a5_var_250k_w0.6_dis3e-6_ent3e-5_'
                 'm0.1_p3e-5_acc3e-4.gin')
GEO_VIEWS, GEO_W, GEO_H, GEO_FACTOR = 20, 1008, 756, 4
GEO_START = 150000  # 0.6 x 250,000: past the consistency warmup, ratio 1
GEO_FEW_STEPS = 3
# A level and step: the main forward and the noisy one, each with its
# backward; with the fused stages (c) K6-K9 count in both directions, and
# K10 is inactive under NerfMLP.srgb_mapping = False.
GEO_PER_STEP = {'K2': 2, 'K3': 2, 'K4': 2, 'K5': 2}
GEO_SIX_PER_STEP = {'K2': 2, 'K3': 2, 'K4': 2, 'K5': 2, 'K6': 4, 'K7': 4,
                    'K8': 4, 'K9': 4}


def geometry_setup(dev, root, gin_name=GEO, dtype=None, bindings=()):
  """The model of configs/<gin_name> as shipped (trunks in `dtype`; None:
  the gin's own float32) reading the LLFF scene at `root`, its train
  dataset, cameras on the card and the cast; a train state at GEO_START
  (its Adam count too, so the learning rate is the schedule's there) and
  the step."""
  from refnerf_tpu_torch.cameras import camera_utils
  from refnerf_tpu_torch.data import datasets
  from refnerf_tpu_torch.train import step as step_lib
  model, config = flagship(dev, [f"Config.data_dir = '{root}'", *bindings],
                           gin_name, dtype)
  ds = datasets.load_dataset('train', root, config)
  cast = lambda cams, pix: camera_utils.cast_ray_batch(cams, pix, ds.camtype)
  state = step_lib.create_train_state(config, model)
  state.step = state.opt.count = GEO_START
  return dict(model=model, config=config, ds=ds, cast=cast,
              cameras=ds.device_cameras(dev), state=state,
              train_step=step_lib.make_train_step(model, config, cast))


def render_gap(run, batch, step):
  """The largest |difference| between the kernels' renders and
  fused_trunk='off''s of the step's rays, for each quantity the
  consistency terms read (both levels of the main forward and of the noisy
  forward, at the step's angles), and the longest rotated direction:
  consistency.bound's `gap`."""
  from refnerf_tpu_torch.testing import consistency
  from refnerf_tpu_torch.train import sampling
  from refnerf_tpu_torch.train import step as step_lib
  model, config = run['model'], run['config']
  rays = run['cast'](run['cameras'], batch.rays)
  ratio = step_lib._consistency_ratio(config, step)
  # The angles the step draws at `step` (make_train_step's default).
  angles = sampling.draw_noise_angles(
      config.seed, step, config.sample_noise_angles,
      sampling.max_noise_angle(config.sample_angle_range, ratio),
      rays.origins.device)
  mode = model.nerf_mlp.cfg.fused_trunk
  got, noisy_rays = consistency.step_renders(model, rays, config, step,
                                             angles)
  set_mode(model, fused_trunk='off')
  try:
    want, _ = consistency.step_renders(model, rays, config, step, angles,
                                       noisy_rays)
  finally:
    set_mode(model, fused_trunk=mode)
  return consistency.render_gap(got, want, noisy_rays)


def geometry_against_plain(fused_mlp, run, batch, what):
  """Phase 18: one step's loss, gradient norm and each loss term through
  the kernels against fused_trunk='off' (the consistency terms within
  consistency.bound of the render gap), and three planted faults
  above those bounds: the rotated copies grouped angle-major, the specular
  negation dropped, a ratio of 1 at step 0. Returns a summary."""
  from refnerf_tpu_torch.testing import consistency
  from refnerf_tpu_torch.train import sampling
  from refnerf_tpu_torch.train import step as step_lib
  model, config, state = run['model'], run['config'], run['state']
  step_fn, cams = run['train_step'], run['cameras']
  mode = model.nerf_mlp.cfg.fused_trunk
  gap = render_gap(run, batch, state.step)
  ratio = step_lib._consistency_ratio(config, state.step)

  def terms(**arm):
    set_mode(model, **arm)
    before = dict(fused_mlp.launches)
    loss, stats, grads = step_fn.loss_and_grads(state, batch, cams)
    norm = step_lib.global_norm(grads.values()).item()
    del grads
    if arm.get('fused_trunk') == 'off' and fused_mlp.launches != before:
      raise AssertionError("phase 18: fused_trunk='off' launched a kernel")
    set_mode(model, fused_trunk=mode)
    return loss.item(), norm, {k: v.item() for k, v in
                               stats['losses'].items()}

  loss_k, norm_k, got = terms(fused_trunk=mode)
  loss_p, norm_p, want = terms(fused_trunk='off')
  dl = abs(loss_k - loss_p) / abs(loss_p)
  dn = abs(norm_k - norm_p) / norm_p
  bounds = {k: consistency.bound(k, want[k], config, ratio, gap)
            for k in consistency.TERMS}
  diffs = {k: abs(got[k] - want[k]) for k in want}
  rel = {k: diffs[k] / abs(want[k]) for k in want
         if k not in bounds and want[k] != 0}
  log(f"phase 18: {what} step {state.step} kernels vs fused_trunk='off': "
      f'loss {loss_k:.6g} vs {loss_p:.6g} (rel {dl:.2e}, bound '
      f'{TRAIN_LOSS_BOUND}), grad norm {norm_k:.6g} vs {norm_p:.6g} (rel '
      f'{dn:.2e}, bound {TRAIN_GNORM_BOUND}); render gap ' + ', '.join(
          f'{k} {v:.3e}' for k, v in gap.items()) + '; terms: ' + ', '.join(
          f'{k} {got[k]:.6g} vs {want[k]:.6g} (' + (
              f'|diff| {diffs[k]:.3e}, bound {bounds[k]:.3e}' if k in bounds
              else f'rel {rel.get(k, 0.0):.2e}, bound {TRAIN_LOSS_BOUND}')
          + ')' for k in want))
  if not (dl <= TRAIN_LOSS_BOUND and dn <= TRAIN_GNORM_BOUND):
    raise AssertionError('phase 18: the kernel step disagrees with the plain '
                         'one')
  bad = [k for k in bounds if diffs[k] > bounds[k]]
  bad += [k for k, r in rel.items() if r > TRAIN_LOSS_BOUND]
  if bad:
    raise AssertionError(f'phase 18: terms {bad} disagree with the plain step')

  # The planted faults, each through the kernels against the plain terms.
  faults = {}
  over = lambda d, b: d / b if b > 0 else (math.inf if d > 0 else 0.0)
  k = 'specular_consistency'
  faults['negation dropped'] = {k: over(abs(-got[k] - want[k]), bounds[k])}
  sample = sampling.sample_noisy_rays

  def angle_major(*a, **kw):
    out = sample(*a, **kw)
    n_a = config.sample_noise_angles
    return out.map(lambda x: x.reshape(-1, n_a, *x.shape[1:]).transpose(
        0, 1).reshape(x.shape))
  sampling.sample_noisy_rays = angle_major
  try:
    faulty = terms(fused_trunk=mode)[2]
  finally:
    sampling.sample_noisy_rays = sample
  faults['angle-major'] = {k: over(abs(faulty[k] - want[k]), bounds[k])
                           for k in bounds}
  zero_state = step_lib.create_train_state(config, model)
  zero_state.step = zero_state.opt.count = 0
  _, zero_stats, zero_grads = step_fn.loss_and_grads(zero_state, batch, cams)
  del zero_grads
  at_zero = {k: zero_stats['losses'][k].item() for k in bounds}
  ratio_fn = step_lib._consistency_ratio
  step_lib._consistency_ratio = lambda c, s: 1.0
  try:
    _, one_stats, one_grads = step_fn.loss_and_grads(zero_state, batch, cams)
    del one_grads
  finally:
    step_lib._consistency_ratio = ratio_fn
  faults['ratio 1 at step 0'] = {k: abs(one_stats['losses'][k].item())
                                 for k in bounds}
  log(f'phase 18: {what} planted faults, |fault - plain| / bound (must '
      f'exceed 1; at step 0 the bound is 0, so the fault\'s |term|): '
      f'{json.dumps(faults)}; at step 0 the consistency terms are '
      f'{json.dumps(at_zero)}')
  if any(v != 0 for v in at_zero.values()):
    raise AssertionError('phase 18: consistency terms at step 0 are not 0')
  # The regrouping is held on the terms it changes: at these weights a ray's
  # composited normals are short (its acc is small), so 1 - n.n' is ~1
  # whatever it is paired with, and the normals term barely moves.
  held = [faults['negation dropped']['specular_consistency']] + [
      faults['angle-major'][k] for k in ('diffuse_consistency',
                                         'specular_consistency',
                                         'distance_consistency')]
  if not all(v > 1 for v in held):
    raise AssertionError('phase 18: a planted fault lies within its bound')
  if not all(v > 0 for v in faults['ratio 1 at step 0'].values()):
    raise AssertionError('phase 18: a ratio of 1 at step 0 left a '
                         'consistency term at 0')
  return dict(loss_rel=dl, gnorm_rel=dn, render_gap=gap, terms=got,
              plain_terms=want, bounds=bounds, faults=faults, at_zero=at_zero)


def geometry_train(fused_mlp, run, per_step, what):
  """Phase 18: warm-up and timed steps from prefetched batches (rays cast
  in the step) at GEO_START; each kernel must run levels x steps x its
  `per_step` count, every loss term be finite and the four consistency
  terms nonzero. Returns (launches, seconds a step, the library of every
  launch, the last stats, one more batch)."""
  from refnerf_tpu_torch.data import prefetch
  from refnerf_tpu_torch.testing import consistency
  model, step_fn, cams = run['model'], run['train_step'], run['cameras']
  batches = prefetch.training_batches(run['ds'],
                                      device=next(model.parameters()).device)
  seen, restore = _routes(fused_mlp)
  try:
    for _ in range(TRAIN_WARMUP):
      run['state'], _ = step_fn(run['state'], next(batches), cams)
    torch.cuda.synchronize()
    for k in fused_mlp.launches:
      fused_mlp.launches[k] = 0
    t0 = time.perf_counter()
    all_stats = []
    for _ in range(TRAIN_STEPS):
      run['state'], stats = step_fn(run['state'], next(batches), cams)
      all_stats.append(stats)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = dict(fused_mlp.launches)
    batch = next(batches)
  finally:
    restore()
    batches.close()
  levels = model.cfg.num_levels
  want = {k: levels * TRAIN_STEPS * per_step.get(k, 0) for k in launches}
  if launches != want:
    raise AssertionError(f'phase 18: {what} launches {launches}, expected '
                         f'{want}')
  for stats in all_stats:
    terms = stats['losses']
    if not all(torch.isfinite(v).all() for v in terms.values()):
      raise AssertionError(f'phase 18: a loss term is not finite: {terms}')
    if len(terms) != 9 or any(terms[k].item() == 0
                              for k in consistency.TERMS):
      raise AssertionError(f'phase 18: the terms are {sorted(terms)}, the '
                           'consistency terms must be nonzero')
  last = all_stats[-1]
  log(f'phase 18: {what}: {TRAIN_STEPS} steps from step '
      f'{run["state"].step - TRAIN_STEPS} after {TRAIN_WARMUP} warm-up: '
      f'{dt * 1e3:.2f} ms/step, {run["config"].batch_size / dt:.0f} train '
      f'rays/s; loss {last["loss"].item():.6g} (' + ', '.join(
          f'{k} {v.item():.6g}' for k, v in last['losses'].items()) +
      f'), psnr {last["psnr"].item():.3f}; launches {launches}; libraries '
      f'{json.dumps({k: sorted(v) for k, v in seen.items()})}')
  return launches, dt, seen, last, batch


def noisy_share(run, batch, what):
  """The step's share of time in the noisy forward, its backward and the
  consistency losses: full steps with them and without (the same gin with
  sample_noise_size 0 and no distance consistency), timed in turns. The
  arm without keeps the main forward's extras (compute_extras, which the
  noisy forward turns on): compute_disp_metrics turns them on and adds no
  metric, since an LLFF batch holds no disparities."""
  import dataclasses
  from refnerf_tpu_torch.train import step as step_lib
  if batch.disps is not None:
    raise AssertionError('phase 18: the batch holds disparities')
  config = dataclasses.replace(
      run['config'], sample_noise_size=0, consistency_distance_loss_mult=0.0,
      consistency_distance_coarse_loss_mult=0.0, compute_disp_metrics=True)
  arms = {'with': run['train_step'],
          'without': step_lib.make_train_step(run['model'], config,
                                              run['cast'])}
  times = {a: [] for a in arms}
  for a in ('with', 'without', 'without', 'with'):
    for i in range(4):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      run['state'], _ = arms[a](run['state'], batch, run['cameras'])
      torch.cuda.synchronize()
      if i:  # the first after a switch is not timed
        times[a].append(time.perf_counter() - t0)
  med = {a: float(np.median(v)) for a, v in times.items()}
  share = 1 - med['without'] / med['with']
  log(f'phase 18: {what}: a step in turns with / without the noisy forward '
      f'(median of 6): {med["with"] * 1e3:.2f} / {med["without"] * 1e3:.2f} '
      f'ms; the noisy forward, its backward and the consistency losses '
      f'{100 * share:.1f}% of the step')
  return med, share


def geometry_stage(fused_mlp, dev):
  """Phase 18: the LLFF geometry gins from a 20-view forward-facing scene on
  disk. (b) configs/llff_refnerf_geometry_losses.gin as shipped (float32,
  batch 1024, NDC, all_images, no fuse flags, fused_trunk='auto') from
  step 150,000; (c) the same in bf16 with all six fuse flags and
  fused_trunk='on'; (d) the few-shot gin on 3 views. Returns ((b)'s
  launches, (c)'s, a summary)."""
  import tempfile
  from refnerf_tpu_torch.tools import sphere_scene
  root = tempfile.mkdtemp(prefix='refnerf_llff_')
  out = {}
  try:
    t0 = time.perf_counter()
    scene = sphere_scene.make_llff_scene(os.path.join(root, 'scene'),
                                         GEO_VIEWS, GEO_W, GEO_H, GEO_FACTOR)
    out['scene_write_s'] = time.perf_counter() - t0

    # (b) the gin as shipped.
    t0 = time.perf_counter()
    run = geometry_setup(dev, scene)
    out['load_s'] = time.perf_counter() - t0
    model, config, ds = run['model'], run['config'], run['ds']
    cfg = model.nerf_mlp.cfg
    flags = [b.split('.', 1)[1].split(' = ')[0] for b in FUSE + SPATIAL]
    if (cfg.compute_dtype != 'float32' or cfg.fused_trunk != 'auto' or
        any(getattr(cfg, f) for f in flags) or cfg.srgb_mapping or
        config.batch_size != 1024 or not config.forward_facing or
        config.batching != 'all_images' or config.factor != GEO_FACTOR or
        ds.images.shape[1:3] != (GEO_H, GEO_W)):
      raise AssertionError('phase 18: the geometry gin is not as shipped')
    log(f'phase 18: scene of {GEO_VIEWS} views at {GEO_W} x {GEO_H} '
        f'(images_{GEO_FACTOR}/) written in {out["scene_write_s"]:.1f} s; '
        f'{GEO} as shipped: {ds.images.shape[0]} train views loaded in '
        f'{out["load_s"]:.1f} s, batch {config.batch_size}, '
        f'{config.sample_noise_size} noise rays x {config.sample_noise_angles}'
        f' angles, f32 trunks, fused_trunk={cfg.fused_trunk!r}')
    launches, step_s, seen, _, batch = geometry_train(
        fused_mlp, run, GEO_PER_STEP, 'f32 as shipped')
    if seen != {'forward': {'trunk_fwd_f32'}, 'backward': {'trunk_bwd_f32'}}:
      raise AssertionError(f'phase 18: the trunks routed to {seen}')
    out['f32'] = dict(step_ms=step_s * 1e3,
                      rays_s=config.batch_size / step_s)
    out['f32']['vs_plain'] = geometry_against_plain(fused_mlp, run, batch,
                                                    'f32')
    box = {'state': run['state']}

    def step():
      box['state'], _ = run['train_step'](box['state'], batch,
                                          run['cameras'])
    prof = profile(step, 'geometry f32 train step', 2, phase=18)
    new_kernels(prof, 18, ('trunk_fwd_f32_kernel', 'trunk_bwd_f32_kernel'))
    out['f32']['profile'] = {k: prof[k] for k in ('wall_ms', 'busy_ms')}
    out['f32']['noisy'] = noisy_share(run, batch, 'f32 as shipped')
    del run, model, box, batch
    torch.cuda.empty_cache()

    # (c) bf16, all six fuse flags, fused_trunk='on'.
    run = geometry_setup(dev, scene, dtype='bfloat16', bindings=[
        *FUSE, *SPATIAL, "NerfMLP.fused_trunk = 'on'"])
    launches_b, step_s, seen, _, batch = geometry_train(
        fused_mlp, run, GEO_SIX_PER_STEP, 'bf16, six fuse flags, on')
    if seen != {'forward': {'trunk_fwd_tma'}, 'backward': {'trunk_bwd_tma'}}:
      raise AssertionError(f'phase 18: the bf16 trunks routed to {seen}')
    out['bf16'] = dict(step_ms=step_s * 1e3,
                       rays_s=run['config'].batch_size / step_s)
    out['bf16']['vs_plain'] = geometry_against_plain(fused_mlp, run, batch,
                                                     'bf16 six flags')
    out['bf16']['noisy'] = noisy_share(run, batch, 'bf16, six fuse flags')
    del run, batch
    torch.cuda.empty_cache()

    # (d) the few-shot gin: 3 input views.
    run = geometry_setup(dev, scene, FEW_SHOT)
    if run['ds'].images.shape[0] != 3 or run['config'].n_input_views != 3:
      raise AssertionError('phase 18: the few-shot gin did not load 3 views')
    from refnerf_tpu_torch.data import prefetch
    batches = prefetch.training_batches(run['ds'], device=dev)
    try:
      t0 = time.perf_counter()
      for _ in range(GEO_FEW_STEPS):
        run['state'], stats = run['train_step'](run['state'], next(batches),
                                                run['cameras'])
      torch.cuda.synchronize()
      few_s = time.perf_counter() - t0
    finally:
      batches.close()
    if not torch.isfinite(stats['loss']):
      raise AssertionError('phase 18: the few-shot loss is not finite')
    out['few_shot'] = dict(steps=GEO_FEW_STEPS, s=few_s,
                           loss=stats['loss'].item())
    log(f'phase 18: {FEW_SHOT}: 3 train views, {GEO_FEW_STEPS} steps in '
        f'{few_s:.2f} s (the first builds nothing new), loss '
        f'{stats["loss"].item():.6g}')
    del run
    torch.cuda.empty_cache()
  finally:
    shutil.rmtree(root, ignore_errors=True)
  return launches, launches_b, out


# Phase 19: configs/blender_refnerf.gin over mip-NeRF 360's proposal cascade:
# the Model's defaults (JAX's and multinerf's: 3 levels, 64 / 32 samples,
# weight dilation, annealing, single-jitter stratified sampling), a
# separate PropMLP as mip-NeRF 360 publishes it (4 x 256, density only, on
# the MLP's default encoding: 21 basis vectors x 12 degrees, 504 IPE
# columns) and the losses a cascade trains with, at JAX's defaults; the
# normal losses at theirs (0): JAX's loss loops read every level's normals
# and raise where a level has none (losses.py:130-137, :152-158).
CASCADE = [
    'Model.num_levels = 3', 'Model.single_mlp = False',
    'Model.num_prop_samples = 64', 'Model.num_nerf_samples = 32',
    'Model.anneal_slope = 10.', 'Model.dilation_bias = 0.0025',
    'Model.dilation_multiplier = 0.5', 'Model.single_jitter = True',
    'Model.resample_padding = 0.', 'Config.randomized = True',
    'Config.interlevel_loss_mult = 1.0', 'Config.distortion_loss_mult = 0.01',
    'PropMLP.net_depth = 4', 'PropMLP.net_width = 256',
    'PropMLP.disable_rgb = True', 'PropMLP.disable_density_normals = True',
    'Config.orientation_loss_mult = 0.',
    'Config.orientation_coarse_loss_mult = 0.',
    'Config.predicted_normal_loss_mult = 0.',
    'Config.predicted_normal_coarse_loss_mult = 0.']
CASCADE_ON = ["NerfMLP.fused_trunk = 'on'", "PropMLP.fused_trunk = 'on'"]
CASCADE_NOISE = ['NerfMLP.density_noise = 1.0',
                 'NerfMLP.bottleneck_noise = 0.1',
                 'Model.bg_intensity_range = (0., 1.)']
PROP_SCALES = 2.0**np.arange(0, 12)  # the MLP's default max_deg_point 12
CASCADE_RES, CASCADE_TRAIN, CASCADE_TEST = 400, 20, 2
CASCADE_BATCH = 1024  # the gin's own
CASCADE_STEPS, CASCADE_RESUME = 10, 4
# Launches a step (not a level): the PropMLP's forward and backward at the
# two proposal levels (on the wide-input instances in both dtypes), the
# NeRF level's K3, K4 (with u's cotangent), K2 and K5; with the six fuse
# flags (bf16) K6, K7 in K3 and K4, K8-K10 in K2 and K5.
CASCADE_PER_STEP = {'K1': 2, 'K1 wide': 2, 'K2': 1, 'K3': 1, 'K4': 3,
                    'K4 wide': 2, 'K5': 1}
CASCADE_SIX_PER_STEP = {'K1': 2, 'K1 wide': 2, 'K2': 1, 'K3': 1, 'K4': 3,
                        'K4 wide': 2, 'K5': 1, 'K6': 2, 'K7': 2, 'K8': 2,
                        'K9': 2, 'K10': 2}
# The columns of the proposal trunk's input (two IPE segments of 252) that
# two planted faults of the wide-input fill overwrite: 251-259, the last
# column of segment 0 and the first 8 of segment 1 (an 8-column chunk of
# the swizzled layout holds both segments there; the forward's 128-column
# and the backward's chunks meet at 256), and 500-503, the last 4-column
# copy of segment 1 before the zero padding of columns 504-511.
FILL_FAULTS = ((251, 260), (500, 504))


def prop_case(fused_mlp, gen, dev, depth, cdt):
  """mip-NeRF 360's proposal trunk on N_SAMPLES rows: the IPE (in `cdt`)
  of random lifted means and variances on 21 basis vectors x 12 degrees,
  two segments of 252 columns (kin 512 packed), width 256 with He-scaled
  weights, the density head alone; depth 4, or 8 with the skip at layer 5.
  Returns (segs, ws, bs, kw)."""
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  lm = torch.rand(N_SAMPLES, 21, generator=gen).to(dev) * 3 - 1.5
  lv = 10.0**(torch.rand(N_SAMPLES, 21, generator=gen).to(dev) * 4 - 6)
  segs = list(fused_mlp.encode_ipe(lm, lv, PROP_SCALES, cdt))
  skips = fused_mlp.skip_input_layers(depth, 4)
  ws = []
  for l in range(depth):
    k_in = 504 if l == 0 else 256 + (504 if l in skips else 0)
    ws.append(rand(256, k_in) * math.sqrt(2 / k_in))
  bs = [rand(256) * 0.05 for _ in range(depth)]
  kw = dict(skip_period=4, wd=rand(1, 256) / 16, head_f32=None,
            head_cdt=None)
  return segs, ws, bs, kw


def fill_faults(fused_mlp, cdt, cs, ws, bs, kw, cots, depth):
  """What planted faults of the wide-input fill would read on the plain
  proposal trunk: each FILL_FAULTS column range of the input overwritten
  with ones (stale values), sigma and the gradients against the plain
  versions on the true input, as `errors` reads the kernel (share of
  KERNEL_BOUND on sigma, of GRAD_BOUND on each gradient). Fails unless
  each reads above its bound, so that phase 19's check would see either."""
  with torch.no_grad():
    want = flatten(fused_mlp.trunk_reference(cs, ws, bs, compute_dtype=cdt,
                                             **kw))
    want += flatten(fused_mlp.trunk_backward_reference(
        cs, ws, bs, cots, compute_dtype=cdt, **kw))
    reads = {}
    for lo, hi in FILL_FAULTS:
      bad = [s.clone() for s in cs]
      for j, s in enumerate(bad):
        a, b = max(lo - 252 * j, 0), min(hi - 252 * j, 252)
        if a < b:
          s[:, a:b] = 1
      got = flatten(fused_mlp.trunk_reference(bad, ws, bs, compute_dtype=cdt,
                                              **kw))
      got += flatten(fused_mlp.trunk_backward_reference(
          bad, ws, bs, cots, compute_dtype=cdt, **kw))
      reads[f'{lo}-{hi - 1}'] = max(r[3] for r in errors(got, want, cdt, 1))
      del bad, got
  log(f'phase 19: K1/K4 wide {cdt} depth {depth}: a fault of the input fill '
      'would read ' + ', '.join(f'{v:.2f} (columns {k})'
                                for k, v in reads.items()) +
      ' times the bound')
  if not min(reads.values()) > 1:
    raise AssertionError(f'phase 19: the bounds do not see a fault of the '
                         f'wide input fill: {reads}')


def prop_tf32_faults(fused_mlp, cs, ws, bs, kw, sbar):
  """Phase 19 (a): what three planted faults of the f32 proposal trunk's
  design on the TF32 libraries would read on the plain versions, as
  `errors` reads the kernels (the share of KERNEL_BOUND on sigma, of
  GRAD_BOUND on each gradient): 'one TF32 pass' (every product of the
  plain pair as one TF32 pass, hi.hi: cuBLAS with TF32 allowed), 'head
  unmasked' (zeta_{L-1} = sbar wd without relu'(h_{L-1}): the outer
  product that stands in for the head's product) and 'x padded' (dW_0 from
  an x scratch that holds each 252-column segment padded to 256, its first
  504 columns read). Fails unless each reads above its bound. Returns the
  reads."""
  F = torch.nn.functional
  L = len(ws)
  skips = fused_mlp.skip_input_layers(L, kw['skip_period'])
  cots = (sbar, None, None, None)

  def plain():
    with torch.no_grad():
      return flatten(fused_mlp.trunk_reference(cs, ws, bs, **kw)) + flatten(
          fused_mlp.trunk_backward_reference(cs, ws, bs, cots, **kw))

  def chain(unmasked):  # [sigma, dws, dbs, dwd, zeta_0] by autograd
    params = [t.detach().clone().requires_grad_()
              for t in ws + bs + [kw['wd']]]
    x = torch.cat(cs, -1)
    h = x
    for l in range(L):
      a = F.linear(torch.cat([h, x], -1) if l in skips else h, params[l],
                   params[L + l])
      if l == 0:
        pre0 = a
      h = F.relu(a)
      if unmasked and l == L - 1:
        h = a + (h - a).detach()  # relu's value, the identity's derivative
    sig = h @ params[-1].reshape(-1)
    grads = torch.autograd.grad((sig * sbar).sum(), params + [pre0])
    return [sig.detach()] + list(grads)

  want = plain()
  reads = {}
  allow = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = True
  try:
    got = plain()
  finally:
    torch.backends.cuda.matmul.allow_tf32 = allow
  reads['one TF32 pass'] = max(r[3] for r in errors(got, want, 'float32', 1))
  got = chain(True)[:-1]
  reads['head unmasked'] = max(r[3] for r in errors(got, want, 'float32', 1))
  got = chain(False)
  d = cs[0].shape[1]
  pad = torch.cat([F.pad(c, (0, 256 - d)) for c in cs], -1)[:, :2 * d]
  got[1] = got[-1].t() @ pad  # dW_0 from the padded scratch
  reads['x padded'] = max(r[3] for r in errors(got[:-1], want, 'float32', 1))
  del want, got, pad
  log(f'phase 19: K1/K4 wide float32 depth {L}: a fault of the TF32 design '
      'would read ' + ', '.join(f'{v:.2f} ({k})' for k, v in reads.items()) +
      ' times the bound')
  if not min(reads.values()) > 1:
    raise AssertionError(f'phase 19: the bounds do not see a fault of the '
                         f'TF32 design: {reads}')
  return reads


PROP_FAULT_ROWS = 65536  # rows of the planted faults of the TF32 design


def check_prop_kernels(fused_mlp, dev):
  """Phase 19 (a): the proposal trunk at N_SAMPLES rows against its plain
  versions, forward (sigma by KERNEL_BOUND) and backward (every weight and
  bias gradient by GRAD_BOUND, given a random cotangent of sigma), each
  run twice more bit-identical, in f32 and bf16 (depth 4, and 8), each
  route asserted: f32 on the head-0 instances of trunk_wide_tf32.cu and
  trunk_wide_bwd_tf32.cu (three TF32 passes of wgmma, bounds of three TF32
  products), also at REDESIGNED_ROWS (`redesigned_fwd_rows`,
  `redesigned_rows`) and in turns with the FMA instances of
  trunk_fwd_f32.cu and trunk_bwd_f32.cu that ran them before
  (`redesigned_in_turns`, the routes forced), and at depth 4 the planted
  faults of the design (`prop_tf32_faults`); bf16 on the wide-input
  instances of trunk_fwd_tma.cu and trunk_bwd_tma.cu, the planted faults
  of the fill (`fill_faults`) and, at depth 4, the design the bf16 pair
  replaced (trunk_fwd.cu and trunk_bwd.cu, the routes forced), checked
  likewise and timed: 'was_ms' (`old_prop_kernels`). At depth 4 the
  PyTorch chain of each (`w1024_chain`) is timed as its yardstick."""
  gen = torch.Generator().manual_seed(SEED + 19)
  results = {}
  for depth in (4, 8):
    segs, ws, bs, kw = prop_case(fused_mlp, gen, dev, depth, 'float32')
    sbar = torch.randn(N_SAMPLES, generator=gen).to(dev)
    cots = (sbar, None, None, None)
    for cdt in ('float32', 'bfloat16'):
      cs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
      pack = fused_mlp.pack_trunk(ws, bs, (252, 252), compute_dtype=cdt, **kw)
      tf32 = cdt == 'float32'
      want = ((fused_mlp.WIDE_TF32_LIBRARY, fused_mlp.WIDE_TF32_BWD_LIBRARY)
              if tf32 else (FWD_ROUTE[cdt], BWD_ROUTE[cdt]))
      got = (fused_mlp.forward_library(pack), fused_mlp.backward_library(pack))
      if (got != want or not fused_mlp.wide_input(pack) or
          fused_mlp.missing_instance(pack, 0) is not None):
        raise AssertionError(f'phase 19: the {cdt} proposal trunk routed to '
                             f'{got}')
      tag = tuple(t + (' depth 8' if depth == 8 else '')
                  for t in ('K1 wide', 'K4 wide'))
      results[tag[0], cdt], results[tag[1], cdt] = prop_pair(
          fused_mlp, tag, cdt, cs, ws, bs, kw, pack, cots,
          library=depth == 4, tf32_passes=3 if tf32 else 0)
      if tf32:
        redesigned_fwd_rows(fused_mlp, tag[0], cdt, pack, cs, ws, bs, kw,
                            None, phase=19)
        redesigned_rows(fused_mlp, tag[1], pack, cs, ws, bs, kw, cots, None,
                        phase=19)
        for t, run in zip(tag, (
            lambda: fused_mlp.trunk_kernel(cs, pack),
            lambda: fused_mlp.trunk_backward_kernel(cs, pack, cots))):
          results[t, cdt]['in_turns'] = redesigned_in_turns(
              fused_mlp, t, cdt, run, None, phase=19, iters=10)
        if depth == 4:
          m = PROP_FAULT_ROWS
          results[tag[1], cdt]['faults'] = prop_tf32_faults(
              fused_mlp, [c[:m] for c in cs], ws, bs, kw, sbar[:m])
      if cdt == 'bfloat16':
        fill_faults(fused_mlp, cdt, cs, ws, bs, kw, cots, depth)
      if cdt == 'bfloat16' and depth == 4:
        was = old_prop_kernels(fused_mlp, cs, ws, bs, kw, pack, cots)
        for t, r in zip(tag, was):
          results[t, cdt]['was_ms'] = r['ms']
      del pack, cs
    del segs, ws, bs, kw, cots
    torch.cuda.empty_cache()
  return results


def prop_pair(fused_mlp, tags, cdt, cs, ws, bs, kw, pack, cots,
              library=False, tf32_passes=0):
  """Phase 19 (a): the proposal trunk's forward (tags[0]) and backward
  (tags[1]) on `pack` against their plain versions (compare()), each run
  twice more bit-identical; with `library` the PyTorch chain of each
  (`w1024_chain`) timed beside them; `tf32_passes` as compare() takes it.
  Returns compare()'s two results."""
  kernel = lambda: fused_mlp.trunk_kernel(cs, pack)
  plain = lambda: fused_mlp.trunk_reference(cs, ws, bs, compute_dtype=cdt,
                                            **kw)
  chain = lambda *c: (w1024_chain(fused_mlp, cs, ws, bs, kw, cdt, *c)
                      if library else None)
  f = compare(tags[0], cdt, kernel, plain, n_values=1, phase=19,
              inputs=cs + pack_tensors(pack),
              flops=trunk_flops(ws, N_SAMPLES, 1), library=chain(),
              tf32_passes=tf32_passes)
  deterministic(tags[0], kernel, phase=19, cdt=cdt)
  kernel = lambda: fused_mlp.trunk_backward_kernel(cs, pack, cots)
  plain = lambda: fused_mlp.trunk_backward_reference(
      cs, ws, bs, cots, compute_dtype=cdt, **kw)
  b = compare(tags[1], cdt, kernel, plain, n_values=0, iters=3, phase=19,
              inputs=cs + pack_tensors(pack) + [cots[0]],
              flops=trunk_flops(ws, N_SAMPLES, 1, backward=True),
              library=chain(cots[:3]), tf32_passes=tf32_passes)
  deterministic(tags[1], kernel, phase=19, cdt=cdt)
  return f, b


def old_prop_kernels(fused_mlp, cs, ws, bs, kw, pack, cots):
  """Phase 19 (a): the bf16 proposal trunk's forward and backward on
  trunk_fwd.cu and trunk_bwd.cu (the mma.sync design the wide-input
  instances replaced, the routes forced), held against the same plain
  versions by the same bounds as the new pair (`prop_pair`) and timed.
  Returns compare()'s two results."""
  fwd, bwd = fused_mlp.forward_library, fused_mlp.backward_library
  fused_mlp.forward_library = lambda *a, **k: 'trunk_fwd'
  fused_mlp.backward_library = lambda *a, **k: 'trunk_bwd'
  try:
    return prop_pair(fused_mlp, ('K1 wide on trunk_fwd.cu (was)',
                                 'K4 wide on trunk_bwd.cu (was)'),
                     'bfloat16', cs, ws, bs, kw, pack, cots)
  finally:
    fused_mlp.forward_library, fused_mlp.backward_library = fwd, bwd


def cascade_setup(dev, root, dtype=None, bindings=()):
  """The flagship over the cascade (CASCADE) reading the Blender scene at
  `root` (trunks in `dtype`: None the gins' own float32, both MLPs'; both
  under fused_trunk='on'), its train dataset, cameras on the card, the
  cast, a fresh train state and the step."""
  from refnerf_tpu_torch.cameras import camera_utils
  from refnerf_tpu_torch.data import datasets
  from refnerf_tpu_torch.train import step as step_lib
  more = [f"PropMLP.compute_dtype = '{dtype}'"] if dtype else []
  model, config = flagship(dev, [f"Config.data_dir = '{root}'", *CASCADE,
                                 *CASCADE_ON, *more, *bindings],
                           FLAGSHIP, dtype)
  ds = datasets.load_dataset('train', root, config)
  cast = lambda cams, pix: camera_utils.cast_ray_batch(cams, pix, ds.camtype)
  return dict(model=model, config=config, ds=ds, cast=cast,
              cameras=ds.device_cameras(dev),
              state=step_lib.create_train_state(config, model),
              train_step=step_lib.make_train_step(model, config, cast))


def cascade_train(fused_mlp, run, per_step, what, steps=CASCADE_STEPS,
                  warmup=TRAIN_WARMUP):
  """Phase 19: warm-up and timed steps from prefetched batches (rays cast
  in the step, every draw from the step's generators); each kernel must
  run steps x its `per_step` count, every loss term be finite. Returns
  (launches, seconds a step, the library of every launch, the last stats,
  one more batch)."""
  from refnerf_tpu_torch.data import prefetch
  model, step_fn, cams = run['model'], run['train_step'], run['cameras']
  batches = prefetch.training_batches(run['ds'],
                                      device=next(model.parameters()).device)
  seen, restore = _routes(fused_mlp)
  try:
    for _ in range(warmup):
      run['state'], _ = step_fn(run['state'], next(batches), cams)
    torch.cuda.synchronize()
    for k in fused_mlp.launches:
      fused_mlp.launches[k] = 0
    t0 = time.perf_counter()
    all_stats = []
    for _ in range(steps):
      run['state'], stats = step_fn(run['state'], next(batches), cams)
      all_stats.append(stats)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    launches = dict(fused_mlp.launches)
    batch = next(batches)
  finally:
    restore()
    batches.close()
  want = {k: steps * per_step.get(k, 0) for k in launches}
  if launches != want:
    raise AssertionError(f'phase 19: {what} launches {launches}, expected '
                         f'{want}')
  for stats in all_stats:
    terms = stats['losses']
    if not all(torch.isfinite(v).all() for v in terms.values()):
      raise AssertionError(f'phase 19: a loss term is not finite: {terms}')
    if not {'data', 'interlevel', 'distortion'} <= set(terms):
      raise AssertionError(f'phase 19: the terms are {sorted(terms)}')
  last = all_stats[-1]
  batch_size = run['config'].batch_size
  log(f'phase 19: {what}: {steps} steps after {warmup} warm-up: '
      f'{dt * 1e3:.2f} ms/step, {batch_size / dt:.0f} train rays/s; loss '
      f'{last["loss"].item():.6g} (' + ', '.join(
          f'{k} {v.item():.6g}' for k, v in last['losses'].items()) +
      f'), psnr {last["psnr"].item():.3f}; launches {launches}; libraries '
      f'{json.dumps({k: sorted(v) for k, v in seen.items()})}')
  return launches, dt, seen, last, batch


def cascade_against_plain(fused_mlp, run, batch, what, phase=19):
  """Phase 19: one step's loss, gradient norm and each loss term through the
  kernels against fused_trunk='off', from the same state and so with the
  same draws (seeded from (seed, step)): the loss within TRAIN_LOSS_BOUND
  relative, the gradient norm within TRAIN_GNORM_BOUND, each term within
  TRAIN_LOSS_BOUND of the loss. Returns a summary."""
  from refnerf_tpu_torch.train import step as step_lib
  model, state, step_fn = run['model'], run['state'], run['train_step']

  def arm(mode):
    set_mode(model, fused_trunk=mode)
    before = dict(fused_mlp.launches)
    loss, stats, grads = step_fn.loss_and_grads(state, batch, run['cameras'])
    norm = step_lib.global_norm(grads.values()).item()
    del grads
    if mode == 'off' and fused_mlp.launches != before:
      raise AssertionError(f"phase {phase}: fused_trunk='off' launched a "
                           'kernel')
    return loss.item(), norm, {k: v.item() for k, v in
                               stats['losses'].items()}
  try:
    (lk, nk, tk), (lp, np_, tp) = arm('on'), arm('off')
  finally:
    set_mode(model, fused_trunk='on')
  dl, dn = abs(lk - lp) / abs(lp), abs(nk - np_) / np_
  dt = {k: abs(tk[k] - tp[k]) / abs(lp) for k in tp}
  log(f"phase {phase}: {what}: step {state.step} kernels vs fused_trunk='off' "
      f'(the same draws): loss {lk:.6g} vs {lp:.6g} (rel {dl:.2e}, bound '
      f'{TRAIN_LOSS_BOUND}), grad norm {nk:.6g} vs {np_:.6g} (rel {dn:.2e}, '
      f'bound {TRAIN_GNORM_BOUND}); each term, |diff| / loss: ' + ', '.join(
          f'{k} {tk[k]:.6g} vs {tp[k]:.6g} ({v:.2e})' for k, v in dt.items()))
  if not (dl <= TRAIN_LOSS_BOUND and dn <= TRAIN_GNORM_BOUND and
          all(v <= TRAIN_LOSS_BOUND for v in dt.values())):
    raise AssertionError(f'phase {phase}: {what}: the kernel step disagrees '
                         'with the plain one')
  return dict(loss_rel=dl, gnorm_rel=dn, terms_rel=dt)


def cascade_request(fused_mlp, dev, run, what, profiled=False):
  """Phase 19: a 4096-ray request (eval: no draws) through the kernels,
  timed, its launches counted (K1 at each level, the PropMLP's also under
  'K1 wide', K2 at the NeRF level), against fused_trunk='off' (rgb and acc
  within PATH_BOUND). Returns (ms, launches); `profiled`: instead one
  request profiled, {wall_ms, busy_ms}, with the wide-input forward in it
  (`wide_instances`)."""
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.models import renderer
  model, config = run['model'], run['config']
  rays = random_rays(rays_lib, 4096, config, 19, dev)
  n, chunk = rays.shape[0], config.render_chunk_size
  if profiled:
    prof = profile(lambda: renderer.render_rays(model, rays, chunk),
                   f'cascade {what} request', 1, phase=19)
    wide_instances(prof, backward=False)
    return {k: prof[k] for k in ('wall_ms', 'busy_ms')}
  renderer.render_rays(model, rays, chunk)  # warm-up
  torch.cuda.synchronize()
  for k in fused_mlp.launches:
    fused_mlp.launches[k] = 0
  t0 = time.perf_counter()
  out = renderer.render_rays(model, rays, chunk)
  torch.cuda.synchronize()
  ms = (time.perf_counter() - t0) * 1e3
  launches = {k: v for k, v in fused_mlp.launches.items() if v}
  ranges = check_rendering(out, (n,), config, model.nerf_mlp.cfg.rgb_padding)
  chunks = -(-n // chunk)
  if (launches.get('K1') != 3 * chunks or launches.get('K2') != chunks or
      any(launches.get(k) for k in ('K3', 'K4', 'K5'))):
    raise AssertionError(f'phase 19: {what} request launches {launches}')
  set_mode(model, fused_trunk='off')
  try:
    plain = renderer.render_rays(model, rays, chunk)
  finally:
    set_mode(model, fused_trunk='on')
  diff = (plain['rgb'] - out['rgb']).abs().max().item()
  acc_diff = (plain['acc'] - out['acc']).abs().max().item()
  log(f'phase 19: {what}: a {n}-ray request {ms:.1f} ms, {ranges}, '
      f"launches {launches}; vs fused_trunk='off': max |rgb| diff "
      f'{diff:.3e}, max |acc| diff {acc_diff:.3e} (bound {PATH_BOUND})')
  if not (diff <= PATH_BOUND and acc_diff <= PATH_BOUND):
    raise AssertionError(f'phase 19: {what}: the request disagrees with the '
                         'plain path')
  return ms, launches


def wide_instances(prof, backward=True):
  """Phase 19 (c): the bf16 profile shows the wide-input instances of
  trunk_fwd_tma.cu (and of trunk_bwd_tma.cu, `backward`) and no kernel of
  trunk_fwd.cu or trunk_bwd.cu (the design they replaced), or this fails.
  The instances' last template argument is WIDE (true), perhaps followed
  by trailing ones at their defaults (false)."""
  names = list((prof or {}).get('kernels', {}))
  need = ['trunk_fwd_tma_kernel'] + (['trunk_bwd_tma_kernel'] if backward
                                     else [])
  new = {k: [n for n in names
             if re.search(rf'\b{k}<[^>]*\b256, true(, false)*>', n)]
         for k in need}
  old = [n for n in names
         if re.search(r'\btrunk_(fwd|bwd)_kernel<', n)]
  if prof is None or not all(new.values()) or old:
    raise AssertionError(f'phase 19: the bf16 cascade ran {names}: wide '
                         f'instances {new}, trunk_fwd.cu / trunk_bwd.cu '
                         f'{old}')


def cascade_resume(dev, scene, root):
  """Phase 19 (d): NeRFSystem trains the configuration (f32, 'auto',
  Config.randomized, with the noise and a random background) for
  CASCADE_RESUME steps, and again killed at half and resumed: every
  parameter and Adam moment equal under torch.equal (the draws come from
  (seed, step, stream); no generator state rides the checkpoint)."""
  from refnerf_tpu_torch import configs
  from refnerf_tpu_torch import system

  def trained(exp, more=()):
    gin_file = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'configs', FLAGSHIP)
    config, gin = configs.parse([gin_file], [
        f'Config.seed = {SEED}', f"Config.data_dir = '{scene}'", *CASCADE,
        *CASCADE_NOISE, f"Config.checkpoint_dir = '{root}'",
        f"Config.exp_name = '{exp}'", f'Config.max_steps = {CASCADE_RESUME}',
        f'Config.checkpoint_every = {CASCADE_RESUME // 2}',
        'Config.val_sample_num = 1', 'Config.eval_dataset_limit = 1', *more])
    psys = system.NeRFSystem(config, gin, device=dev)
    psys.train()
    return psys

  t0 = time.perf_counter()
  whole = trained('whole')
  cut = trained('cut', [f'Config.early_exit_steps = {CASCADE_RESUME // 2}'])
  if (whole.state.step, cut.state.step) != (CASCADE_RESUME,
                                            CASCADE_RESUME // 2):
    raise AssertionError('phase 19: the runs stopped at steps '
                         f'{whole.state.step}, {cut.state.step}')
  resumed = trained('cut')
  same = resumed.state.step == CASCADE_RESUME and all(
      torch.equal(resumed.model.state_dict()[k], v)
      for k, v in whole.model.state_dict().items()) and all(
          torch.equal(getattr(resumed.state.opt, w)[k], v)
          for w in ('mu', 'nu')
          for k, v in getattr(whole.state.opt, w).items())
  log(f'phase 19: killed at step {CASCADE_RESUME // 2} and resumed to '
      f'{CASCADE_RESUME} (randomized, noise, random backgrounds) == the '
      f'uninterrupted run under torch.equal: {same} '
      f'({time.perf_counter() - t0:.1f} s for the three runs)')
  if not same:
    raise AssertionError('phase 19: the resumed run differs')


def check_draws(dev):
  """Phase 19 (d): the step's draws on the card depend on (seed, step,
  stream) alone: the same key draws the same tensors, the next step other
  ones."""
  from refnerf_tpu_torch.train import sampling

  def seq(step):
    d = sampling.Draws(SEED, step, sampling.FWD_STREAM, dev)
    return [d.jitter((TRAIN_BATCH,), 64, True), d.mlp().normal((4096, 32)),
            d.background((TRAIN_BATCH, 3), 0.0, 1.0)]
  a, b, c = seq(7), seq(7), seq(8)
  same = all(torch.equal(x, y) for x, y in zip(a, b))
  other = not any(torch.equal(x, y) for x, y in zip(a, c))
  log(f'phase 19: draws on {a[0].device}: step 7 twice bit-identical {same}, '
      f'step 8 different {other}')
  if not (same and other and a[0].is_cuda):
    raise AssertionError('phase 19: the draws do not depend on (seed, step) '
                         'alone')


def cascade_stage(fused_mlp, dev):
  """Phase 19 (b)-(d): the flagship over mip-NeRF 360's proposal cascade
  from a Blender sphere scene. (b) float32 (the gins' own) under 'on' at
  the gin's batch of 1024; (c) bf16 with all six fuse flags at batch 4096;
  (d) the draws, a kill and resume, and (c) with the noise and a random
  background. Returns ((b)'s launches, (c)'s, a summary)."""
  import tempfile
  from refnerf_tpu_torch.models import mlp as mlp_lib
  from refnerf_tpu_torch.tools import sphere_scene
  root = tempfile.mkdtemp(prefix='refnerf_cascade_')
  out = {}
  try:
    t0 = time.perf_counter()
    scene = sphere_scene.make_scene(os.path.join(root, 'scene'),
                                    CASCADE_TRAIN, CASCADE_TEST, CASCADE_RES)
    out['scene_write_s'] = time.perf_counter() - t0

    # (b) float32, the gin's batch.
    run = cascade_setup(dev, scene)
    model, config = run['model'], run['config']
    prop = model.prop_mlp
    if (config.batch_size != CASCADE_BATCH or prop is None or
        model.cfg.num_levels != 3 or prop.cfg.compute_dtype != 'float32' or
        not config.randomized or sum(
            p.numel() for p in prop.parameters()) != 504 * 256 + 3 * 256 *
        256 + 4 * 256 + 257):
      raise AssertionError('phase 19: the configuration is not as bound')
    log(f'phase 19: scene of {CASCADE_TRAIN} + {CASCADE_TEST} views at '
        f'{CASCADE_RES} x {CASCADE_RES} written in {out["scene_write_s"]:.1f}'
        f' s; {FLAGSHIP} over the proposal cascade: 3 levels x 64, 64, 32 '
        f'samples, PropMLP 4 x 256 on 504 columns, batch '
        f'{config.batch_size}, f32 trunks, randomized')
    launches, step_s, seen, _, batch = cascade_train(
        fused_mlp, run, CASCADE_PER_STEP, 'f32, on')
    # The PropMLP's pair on the TF32 libraries, the NeRF level's on the FMA.
    if seen != {'forward': {'trunk_fwd_f32', fused_mlp.WIDE_TF32_LIBRARY},
                'backward': {'trunk_bwd_f32',
                             fused_mlp.WIDE_TF32_BWD_LIBRARY}}:
      raise AssertionError(f'phase 19: the f32 trunks routed to {seen}')
    out['f32'] = dict(step_ms=step_s * 1e3, rays_s=config.batch_size / step_s)
    out['f32']['vs_plain'] = cascade_against_plain(fused_mlp, run, batch,
                                                   'f32')
    box = {'state': run['state']}

    def step():
      box['state'], _ = run['train_step'](box['state'], batch,
                                          run['cameras'])
    prof = profile(step, 'cascade f32 train step', 2, phase=19)
    new_kernels(prof, 19, ('trunk_fwd_f32_kernel', 'trunk_bwd_f32_kernel',
                           'trunk_fwd_tf32_kernel', 'trunk_bwd_tf32_kernel'))
    out['f32']['profile'] = {k: prof[k] for k in ('wall_ms', 'busy_ms')}
    out['f32']['request_ms'], out['f32']['request_launches'] = (
        cascade_request(fused_mlp, dev, run, 'f32'))
    del run, model, prop, box, batch
    torch.cuda.empty_cache()

    # (c) bf16, all six fuse flags, batch 4096.
    run = cascade_setup(dev, scene, 'bfloat16', [
        *FUSE, *SPATIAL, f'Config.batch_size = {TRAIN_BATCH}'])
    launches_b, step_s, seen, _, batch = cascade_train(
        fused_mlp, run, CASCADE_SIX_PER_STEP, 'bf16, six fuse flags, on')
    if seen != {'forward': {'trunk_fwd_tma'}, 'backward': {'trunk_bwd_tma'}}:
      raise AssertionError(f'phase 19: the bf16 trunks routed to {seen}')
    out['bf16'] = dict(step_ms=step_s * 1e3, rays_s=TRAIN_BATCH / step_s)
    out['bf16']['vs_plain'] = cascade_against_plain(fused_mlp, run, batch,
                                                    'bf16 six flags')
    box = {'state': run['state']}

    def step():
      box['state'], _ = run['train_step'](box['state'], batch,
                                          run['cameras'])
    prof = profile(step, 'cascade bf16 six flags train step', 2, phase=19)
    wide_instances(prof)
    out['bf16']['profile'] = {k: prof[k] for k in ('wall_ms', 'busy_ms')}
    out['bf16']['request_ms'], _ = cascade_request(fused_mlp, dev, run,
                                                   'bf16 six flags')
    out['bf16']['request_profile'] = cascade_request(
        fused_mlp, dev, run, 'bf16 six flags', profiled=True)
    del run, batch, box
    torch.cuda.empty_cache()

    # (d) the draws, a kill and resume, and (c) with the noise.
    check_draws(dev)
    cascade_resume(dev, scene, os.path.join(root, 'exp'))
    mlp_lib._FALLBACK_WARNED.clear()
    run = cascade_setup(dev, scene, 'bfloat16', [
        *FUSE, *SPATIAL, *CASCADE_NOISE, f'Config.batch_size = {TRAIN_BATCH}'])
    noisy = dict(CASCADE_SIX_PER_STEP, K6=0)
    noisy_launches, noisy_s, _, last, _ = cascade_train(
        fused_mlp, run, noisy, 'bf16, six flags, density and bottleneck '
        'noise, random backgrounds', steps=3, warmup=0)
    k6_off = [w for w in mlp_lib._FALLBACK_WARNED
              if w[0] == 'fuse_compositing inactive' and
              'density_noise == 0' in w[1]]
    log(f'phase 19: with the noise, K6 logged inactive: {k6_off}')
    if len(k6_off) != 1 or not torch.isfinite(last['loss']):
      raise AssertionError('phase 19: the noisy arm did not keep K6 off or '
                           'is not finite')
    out['noisy'] = dict(step_ms=noisy_s * 1e3, launches=noisy_launches)
    del run
    torch.cuda.empty_cache()
  finally:
    shutil.rmtree(root, ignore_errors=True)
  return launches, launches_b, out


MESH_RES = 96  # the density grid's points per axis (884,736 points)
MESH_BOX = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))  # the Blender object box
MESH_CHUNK = 2 ** 16  # points a launch (geometry.density_grid's default)


def mesh_points():
  """The density grid's points [MESH_RES^3, 3], in geometry.density_grid's
  order."""
  axes = [np.linspace(MESH_BOX[0][i], MESH_BOX[1][i], MESH_RES,
                      dtype=np.float32) for i in range(3)]
  return np.stack(np.meshgrid(*axes, indexing='ij'), axis=-1).reshape(-1, 3)


def spread_l2(got, want):
  """|got - want|_2 over |want - mean(want)|_2, the means per column: the
  error against the plain field's spread about its mean. The flagship's
  random weights leave a nearly flat field (a density of 0.96..0.99), which
  its own relative L2 cannot tell from a constant; here a constant reads 1."""
  got, want = (np.asarray(a, np.float64) for a in (got, want))
  return float(np.linalg.norm(got - want)
               / max(np.linalg.norm(want - want.mean(0)), 1e-30))


def mesh_faults(model, cdt, grid_pts, verts, var):
  """What planted faults of phase 20's K1 launches would read on the plain
  spatial stage (fused_trunk='off'): `flat`, the plain output's mean
  everywhere (a kernel that returns a constant), and `x dropped`, the
  lifted means' first column zeroed (an input column lost); for the
  grid's launch (the density, no bottleneck) at grid_pts and the colours'
  (the diffuse head, with it) at verts, each a Gaussian of diagonal
  covariance var (the lattice's, as the mesh tools make it), as
  spread_l2's share of KERNEL_BOUND. Fails unless each reads above 1."""
  from refnerf_tpu_torch.ops import coord
  mlp = model.nerf_mlp
  dev = next(mlp.parameters()).device
  set_mode(model, fused_trunk='off')
  reads = {}
  with torch.no_grad():
    for what, pts, heads in (('grid', grid_pts, False),
                             ('diffuse', verts, True)):
      p = torch.from_numpy(pts).to(dev)
      means = p[:, None, :]
      lm, lv = coord.lift_and_diagonalize(means, torch.full_like(means, var),
                                          mlp.pos_basis_t)
      bad = lm.clone()
      bad[..., 0] = 0
      outs = []
      for lifted in ((lm, lv.reshape(lm.shape)), (bad, lv.reshape(lm.shape))):
        _, raw, fh, _ = mlp.spatial_stage(means, None, heads, False,
                                          lifted=lifted)
        out = (fh['diffuse'][:, 0] if heads else mlp.density_activation(
            raw[:, 0] + mlp.cfg.density_bias))
        outs.append(out.float().cpu().numpy())
      want, dropped = outs
      flat = np.broadcast_to(want.mean(0), want.shape)
      for fault, got in (('flat', flat), ('x dropped', dropped)):
        reads[f'{what}, {fault}'] = spread_l2(got, want) / KERNEL_BOUND[cdt]
  set_mode(model, fused_trunk='on')
  log(f'phase 20: {cdt} planted faults of the mesh launches would read ' +
      ', '.join(f'{v:.1f} ({k})' for k, v in reads.items()) +
      ' times the bound')
  if not min(reads.values()) > 1:
    raise AssertionError(f'phase 20 {cdt}: the bounds do not see a fault '
                         f'of the mesh launches: {reads}')
  return reads


def mesh_run(fused_mlp, geometry, model, cdt):
  """Phase 20's main path in one dtype: the density grid at MESH_RES, the
  mesh of its midpoint isovalue and the mesh's vertex colours, through K1
  with the launches counted (set to 0 just before, read just after) and
  every launch's route recorded. Returns (the launches, the routes, the
  grid, the mesh, the colours, seconds of each part)."""
  counts = fused_mlp.launches
  routes = []
  kernel = fused_mlp.trunk_kernel

  def recorded(segs, pack, fold=None, **kw):
    routes.append((int(segs[0].shape[0]), pack.wc is not None,
                   fused_mlp.forward_library(
                       pack, kw.get('out_y', False), fold,
                       kw.get('spa_modes') or fused_mlp.SpaModes())))
    return kernel(segs, pack, fold, **kw)

  fused_mlp.trunk_kernel = recorded
  try:
    for k in counts:
      counts[k] = 0
    t0 = time.perf_counter()
    grid = geometry.density_grid(model, MESH_RES, *MESH_BOX)
    t1 = time.perf_counter()
    grid_launches = counts['K1']
    iso = float(grid.min() + grid.max()) / 2
    spacing = 3.0 / (MESH_RES - 1)
    mesh = geometry.marching_tetrahedra(grid, iso, MESH_BOX[0], spacing)
    t2 = time.perf_counter()
    colors = geometry.vertex_colors(model, mesh[0], spacing)
    t3 = time.perf_counter()
    launches = dict(counts)
  finally:
    fused_mlp.trunk_kernel = kernel
  want_grid = -(-MESH_RES ** 3 // MESH_CHUNK)
  want_colors = -(-len(mesh[0]) // MESH_CHUNK)
  others = {k: v for k, v in launches.items() if v and k != 'K1'}
  if (grid_launches != want_grid or launches['K1'] != want_grid + want_colors
      or others):
    raise AssertionError(
        f'phase 20 {cdt}: launches {launches} (K1 {grid_launches} for the '
        f'grid), expected K1 {want_grid} + {want_colors} and nothing else')
  # The grid without the bottleneck (a compute-dtype head of 0), the
  # colours with it, every launch on the forward of its dtype.
  chunks = lambda n: [min(MESH_CHUNK, n - i) for i in range(0, n, MESH_CHUNK)]
  want = ([(n, False) for n in chunks(MESH_RES ** 3)] +
          [(n, True) for n in chunks(len(mesh[0]))])
  if [r[:2] for r in routes] != want or {r[2] for r in routes} != {
      FWD_ROUTE[cdt]}:
    raise AssertionError(f'phase 20 {cdt}: launches {routes[:3]}..., '
                         f'expected {FWD_ROUTE[cdt]}')
  return launches, grid, iso, mesh, colors, (t1 - t0, t2 - t1, t3 - t2)


def mesh_stage(fused_mlp, dev):
  """Phase 20: the flagship's mesh tools and interop at full width, in
  float32 and bfloat16, each under fused_trunk='on' against 'off'. Returns
  ({dtype: K1's launches on the path}, a summary)."""
  import tempfile
  from refnerf_tpu_torch import geometry
  from refnerf_tpu_torch import interop
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.models import renderer
  from refnerf_tpu_torch.tools import export_torch_checkpoint as export_lib
  from refnerf_tpu_torch.tools import import_torch_checkpoint as import_lib
  root = tempfile.mkdtemp(prefix='refnerf_mesh_')
  path, out = {}, {}
  try:
    for cdt in ('float32', 'bfloat16'):
      model, config = flagship(dev, dtype=cdt)
      set_mode(model, fused_trunk='on')
      # Warm-up: builds each pack and loads the libraries; not counted.
      geometry.extract_mesh(model, resolution=16, iso=None)
      launches, grid, iso, mesh, colors, (grid_s, mt_s, col_s) = mesh_run(
          fused_mlp, geometry, model, cdt)
      path[cdt] = launches['K1']
      verts, faces, normals = mesh
      npts = MESH_RES ** 3
      log(f'phase 20: {cdt} density grid {MESH_RES}^3 through K1: '
          f'{grid_s * 1e3:.1f} ms, {npts / grid_s:.0f} points/s, K1 '
          f'{-(-npts // MESH_CHUNK)} launches; density '
          f'{grid.min():.4f}..{grid.max():.4f}; marching tetrahedra at the '
          f'midpoint {iso:.6f}: {len(verts)} vertices, {len(faces)} faces '
          f'in {mt_s:.2f} s on the host; vertex colours {col_s * 1e3:.1f} ms '
          f'({len(verts) / col_s:.0f} vertices/s); K1 {launches["K1"]} '
          'launches on the path')

      # The grid's time in turns with the plain spatial stage (the first
      # run above also allocates and packs).
      times = in_turns(
          lambda: geometry.density_grid(model, MESH_RES, *MESH_BOX),
          {'on': (model, {'fused_trunk': 'on'}),
           'off': (model, {'fused_trunk': 'off'})}, reps=2)
      turns = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
      log(f'phase 20: {cdt} density grid in turns (on, off, off, on; 2 a '
          f'block, medians): on {turns["on"]:.1f} ms, off '
          f'{turns["off"]:.1f} ms')

      # The same through the plain spatial stage.
      set_mode(model, fused_trunk='off')
      before = dict(fused_mlp.launches)
      t0 = time.perf_counter()
      plain = geometry.density_grid(model, MESH_RES, *MESH_BOX)
      plain_s = time.perf_counter() - t0
      pmesh = geometry.marching_tetrahedra(plain, iso, MESH_BOX[0],
                                           3.0 / (MESH_RES - 1))
      spacing = 3.0 / (MESH_RES - 1)
      var_c = float(np.float32((spacing / 2.0) ** 2))
      # The diffuse head (K1 with the bottleneck) at one chunk of the plain
      # mesh's vertices; the grid's launch is the grid itself.
      vpts = pmesh[0][:MESH_CHUNK]
      pcolors = geometry.vertex_colors(model, pmesh[0], spacing)
      pdiffuse = geometry.spatial_heads(
          model.nerf_mlp, torch.from_numpy(vpts).to(dev), var_c,
          True)[1]['diffuse'].float().cpu().numpy()
      if fused_mlp.launches != before:
        raise AssertionError("phase 20: fused_trunk='off' launched a kernel")
      set_mode(model, fused_trunk='on')
      kcolors = geometry.vertex_colors(model, pmesh[0], spacing)
      kdiffuse = geometry.spatial_heads(
          model.nerf_mlp, torch.from_numpy(vpts).to(dev), var_c,
          True)[1]['diffuse'].float().cpu().numpy()
      rel = float(np.linalg.norm(grid - plain) / np.linalg.norm(plain))
      max_err = float(np.abs(grid - plain).max())
      reads = {'grid': spread_l2(grid.reshape(-1), plain.reshape(-1)),
               'diffuse': spread_l2(kdiffuse, pdiffuse),
               'colours': spread_l2(kcolors, pcolors)}
      spread = float(plain.std())
      # Where no lattice value crosses the isovalue between the two grids
      # the meshes share their topology; a flip is allowed only within the
      # kernel bound times the field's spread of the isovalue (H8), and
      # changes the vertex count.
      flipped = (grid > iso) != (plain > iso)
      near = float(np.abs(plain[flipped] - iso).max()) if flipped.any() else 0
      dv = len(verts) - len(pmesh[0])
      col_err = float(np.abs(kcolors - pcolors).max())
      log(f"phase 20: {cdt} vs fused_trunk='off' (the grid in "
          f'{plain_s * 1e3:.1f} ms, {npts / plain_s:.0f} points/s; density '
          f'spread {spread:.3e} about its mean), L2 error over the plain '
          'spread: ' + ', '.join(f'{k} {v:.3e}' for k, v in reads.items()) +
          f' (bound {KERNEL_BOUND[cdt]:.0e}); the grid\'s relative L2 '
          f'{rel:.3e}, max abs {max_err:.3e}; lattice values across the '
          f'isovalue {int(flipped.sum())} (farthest {near:.3e} from it), '
          f'vertices {len(verts)} vs {len(pmesh[0])} (difference {dv}); '
          f'colours of the plain mesh, max abs {col_err:.3e}')
      if max(reads.values()) > KERNEL_BOUND[cdt]:
        raise AssertionError(f'phase 20 {cdt}: the kernel grid, diffuse head '
                             f"or colours disagree with fused_trunk='off': "
                             f'{reads}')
      faults = mesh_faults(model, cdt, mesh_points()[::32], vpts, var_c)
      # (A face's winding follows the interpolated gradient, so compare the
      # faces as vertex sets.)
      if near > KERNEL_BOUND[cdt] * spread or (
          not flipped.any() and not (dv == 0 and np.array_equal(
              np.sort(faces, axis=1), np.sort(pmesh[1], axis=1)))):
        raise AssertionError(f'phase 20 {cdt}: the meshes differ beyond the '
                             'lattice values at the isovalue')

      # The PLY round trip.
      ply = os.path.join(root, f'mesh_{cdt}.ply')
      t0 = time.perf_counter()
      geometry.write_ply(ply, verts, faces, normals, colors=colors)
      back = geometry.read_ply(ply)
      ply_s = time.perf_counter() - t0
      if not (np.array_equal(back['verts'], verts) and
              np.array_equal(back['faces'], faces) and
              np.array_equal(back['normals'], normals) and
              np.abs(back['colors'] - colors).max() <= 0.5 / 255 + 1e-6):
        raise AssertionError(f'phase 20 {cdt}: the PLY does not read back')
      log(f'phase 20: {cdt} PLY of {os.path.getsize(ply)} bytes written and '
          f'read back in {ply_s:.2f} s')

      # Interop: export to a refnerf-pl .ckpt, import it into a model built
      # from another seed, and serve a request from both.
      ckpt = os.path.join(root, f'{cdt}.ckpt')
      export_lib.export(model, 0, ckpt)
      other, _ = flagship(dev, ['Config.seed = 1'], dtype=cdt)
      set_mode(other, fused_trunk='on')
      if torch.equal(other.nerf_mlp.spatial_0.weight,
                     model.nerf_mlp.spatial_0.weight):
        raise AssertionError('phase 20: the seeds built the same weights')
      sd, _ = import_lib.load_lightning(ckpt)
      other.load_state_dict(interop.torch_state_dict_to_params(
          sd, other.state_dict(), other))
      rays = random_rays(rays_lib, 4096, config, 4, dev)
      with torch.no_grad():
        a = renderer.render_rays(model, rays, config.render_chunk_size)
        b = renderer.render_rays(other, rays, config.render_chunk_size)
      same = torch.equal(a['rgb'], b['rgb'])
      log(f'phase 20: {cdt} exported to {os.path.getsize(ckpt)} bytes, '
          f'imported into a model of seed 1, a 4096-ray request bit for '
          f'bit: {same}')
      if not same:
        raise AssertionError(f'phase 20 {cdt}: the imported model serves '
                             'another rgb')
      out[cdt] = dict(
          grid_ms=grid_s * 1e3, grid_points_s=npts / grid_s,
          plain_grid_ms=plain_s * 1e3, grid_turns_ms=turns['on'],
          plain_grid_turns_ms=turns['off'], grid_rel_l2=rel,
          grid_max_abs=max_err, spread_l2=reads, density_spread=spread,
          fault_reads=faults, marching_s=mt_s, vertices=len(verts), faces=len(faces),
          vertices_vs_plain=dv, flipped=int(flipped.sum()),
          colors_ms=col_s * 1e3, colors_max_abs=col_err, ply_s=ply_s,
          interop_bit_for_bit=same)
      del model, other, grid, plain, mesh, pmesh
      torch.cuda.empty_cache()
  finally:
    shutil.rmtree(root, ignore_errors=True)
  return path, out


# Phase 21: serving from a weight-embedded artifact. Its chunk, the timed
# requests of each arm (in turns), and what each artifact must hold and
# launch: the trunk operator twice for each trunk kind (2 levels), and a
# request's launches counted in a fresh process.
SERVE_CHUNK = 4096
REQUESTS = 16
ARTIFACT_OPS = {'K1': 2, 'K2': 2}
ARTIFACTS = {
    'flagship': (FLAGSHIP, 'bfloat16', FUSE + SPATIAL, 'trunk_fwd_tma',
                 {'K1': 2, 'K2': 2, 'K6': 2, 'K7': 2, 'K8': 2, 'K9': 2,
                  'K10': 2}),
    'mipnerf': (MIPNERF, None, (), 'trunk_fwd_f32', {'K1': 2, 'K2': 2})}
# The served artifact's rgb, acc and distance against the in-process
# fused_trunk='off' render: spread_l2 (the L2 error over the plain render's
# spread about its mean across the request's rays, as phase 20 holds the
# mesh fields), at most SERVE_BOUND[compute dtype]: 20 times the sound
# reads on an H100 of the flagship (bf16, 9.9e-6) and mip-NeRF (f32,
# 8.4e-7), under what a zeroed bottleneck head reads (5.7e-4 / 1.7e-3).
SERVE_BOUND = {'float32': 2e-5, 'bfloat16': 2e-4}
# Modules the fresh serving process must not import.
FOREIGN = ('jax', 'jaxlib', 'flax', 'optax', 'refnerf_tpu')


def load_and_serve(*args):
  """Phase 21's fresh process, for each (path, rays_npz, out_npz) of
  `args` in turn: load the artifact at `path` with torch and the port
  alone, serve the rays of `rays_npz` once, the launches counted (set to 0
  just before, read just after), write the buffers to `out_npz` and print
  one JSON line (load s, the request's ms, the launches, any module of
  FOREIGN imported so far)."""
  from refnerf_tpu_torch import serving
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.ops import fused_mlp
  for path, rays_npz, out_npz in zip(args[::3], args[1::3], args[2::3]):
    t0 = time.perf_counter()
    served = serving.load_serving(path)
    load_s = time.perf_counter() - t0
    data = np.load(rays_npz)
    rays = rays_lib.Rays(**{k: torch.from_numpy(data[k]).to(served.device)
                            for k in data.files})
    counts = fused_mlp.launches
    for k in counts:
      counts[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = served(rays)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in counts.items() if v}
    np.savez(out_npz, **{k: v.float().cpu().numpy() for k, v in out.items()})
    foreign = sorted(m for m in sys.modules if m.split('.')[0] in FOREIGN)
    print(json.dumps(dict(load_s=load_s, load_parts=served.load_seconds,
                          first_ms=first_ms, launches=launches,
                          foreign=foreign)), flush=True)
    del served, out
  return 0


def max_diffs(got, want, far):
  """max |got - want| of rgb and acc, and of distance over far (tensors on
  any device, or numpy)."""
  host = lambda v: (v.float().cpu().numpy() if torch.is_tensor(v)
                    else np.asarray(v, np.float32))
  d = lambda k: float(np.abs(host(got[k]) - host(want[k])).max())
  return {'rgb': d('rgb'), 'acc': d('acc'), 'distance': d('distance') / far}


def spread_reads(got, want):
  """spread_l2 of rgb, acc and distance (tensors on any device, or numpy)."""
  host = lambda v: (v.float().cpu().numpy() if torch.is_tensor(v)
                    else np.asarray(v, np.float32))
  return {k: spread_l2(host(got[k]), host(want[k]))
          for k in ('rgb', 'acc', 'distance')}


def drop_skip_columns(pack):
  """A planted pack fault: the skip layer's trunk-input columns zeroed in
  both of the pack's layouts (w: [width, K] a layer, wt: [K, width])."""
  k = pack.k_dims()
  at, n = sum(pack.width * kl for kl in k[:pack.skip]), pack.width * k[
      pack.skip]
  w, wt = pack.w.clone(), pack.wt.clone()
  w[at:at + n].view(pack.width, k[pack.skip])[:, pack.width:] = 0
  wt[at:at + n].view(k[pack.skip], pack.width)[pack.width:] = 0
  return pack._replace(w=w, wt=wt)


@contextlib.contextmanager
def planted_pack(fault):
  """Within, export_serving freezes every spatial trunk's pack with
  `fault` applied: the fault enters the artifact's constants alone, and
  each model's own cached pack is put back on the way out."""
  from refnerf_tpu_torch.models import mlp as mlp_lib
  real, saved = mlp_lib.frozen_packs, []

  @contextlib.contextmanager
  def frozen(module):
    with real(module):
      for m in module.modules():
        if not isinstance(m, mlp_lib.MLP):
          continue
        for key, (sig, pack) in list(m._packs.items()):
          if key[0].startswith('spatial') and pack.skip >= 0:
            saved.append((m, key, (sig, pack)))
            m._packs[key] = (sig, fault(pack))
      yield

  mlp_lib.frozen_packs = frozen
  try:
    yield saved
  finally:
    mlp_lib.frozen_packs = real
    for m, key, hit in saved:
      m._packs[key] = hit


def artifact_case(fused_mlp, dev, root, name):
  """Phase 21 for one model of ARTIFACTS: export its artifacts (the kernels
  under fused_trunk='on', 'off', and the planted faults), check the graph,
  and write the rays that the fresh process (`serving_stage`, one for
  every model) serves. Returns ((the artifact, the rays' file, the file of
  what the fresh process serves), finish): finish(its JSON line, its
  seconds) checks what it served against the in-process renders, reads
  the planted faults, times the three arms in turns, and returns (the
  fresh process's launches, a summary, (the artifact, the loaded program,
  the rays, the config))."""
  from refnerf_tpu_torch import serving
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.models import renderer
  gin_name, dtype, bindings, lib, want_launches = ARTIFACTS[name]
  model, config = flagship(dev, bindings, gin_name, dtype)
  cdt = model.nerf_mlp.cfg.compute_dtype
  rays = random_rays(rays_lib, SERVE_CHUNK, config, 1, dev)
  with torch.no_grad():
    set_mode(model, fused_trunk='off')
    plain = renderer.render_rays(model, rays, SERVE_CHUNK)
    set_mode(model, fused_trunk='on')
    kern = renderer.render_rays(model, rays, SERVE_CHUNK)
  paths = {arm: os.path.join(root, f'{name}_{arm}.rnsrv')
           for arm in ('on', 'off', 'fault')}
  t0 = time.perf_counter()
  meta = serving.export_serving(model, paths['on'], chunk=SERVE_CHUNK,
                                device=dev, near=config.near, far=config.far)
  export_s = time.perf_counter() - t0
  size = os.path.getsize(paths['on'])
  t0 = time.perf_counter()
  served = serving.load_serving(paths['on'])
  load_here_s = time.perf_counter() - t0
  nodes = fused_mlp.trunk_op_nodes(served.exported.graph)
  ops = {}
  for _, which, _ in nodes:
    ops[which] = ops.get(which, 0) + 1
  libs = sorted({route for _, _, route in nodes})
  log(f'phase 21: {name} {cdt}: exported in {export_s:.2f} s, {size} bytes, '
      f'buffers {sorted(meta["buffers"])}, loaded here in {load_here_s:.2f} '
      f's; the graph holds the trunk operator {ops} on {libs}')
  if ops != ARTIFACT_OPS or libs != [lib]:
    raise AssertionError(f'phase 21: {name}: trunk operators {ops} on '
                         f'{libs}, expected {ARTIFACT_OPS} on {lib}')
  set_mode(model, fused_trunk='off')
  serving.export_serving(model, paths['off'], chunk=SERVE_CHUNK, device=dev,
                         near=config.near, far=config.far)
  off_served = serving.load_serving(paths['off'])
  if fused_mlp.trunk_op_nodes(off_served.exported.graph):
    raise AssertionError(f"phase 21: {name}: the 'off' artifact holds a "
                         'trunk operator')
  # The planted faults: an artifact whose frozen spatial pack lost the skip
  # layer's input columns (a pack fault, which the kernels run), one whose
  # program takes the rays' fields in another order than its loader passes
  # them (directions and viewdirs swapped), and one with the bottleneck
  # head zeroed.
  set_mode(model, fused_trunk='on')
  paths['skip'] = os.path.join(root, f'{name}_skip.rnsrv')
  with planted_pack(drop_skip_columns) as planted:
    serving.export_serving(model, paths['skip'], chunk=SERVE_CHUNK,
                           device=dev, near=config.near, far=config.far)
  if not planted:
    raise AssertionError(f'phase 21: {name}: no spatial pack with a skip '
                         'layer to plant the fault in')
  fields = serving.RAY_FIELDS
  i, j = fields.index('directions'), fields.index('viewdirs')
  serving.RAY_FIELDS = tuple(fields[j] if k == i else fields[i] if k == j
                             else f for k, f in enumerate(fields))
  try:
    serving.export_serving(model, paths['fault'], chunk=SERVE_CHUNK,
                           device=dev, near=config.near, far=config.far)
  finally:
    serving.RAY_FIELDS = fields
  head = model.nerf_mlp.bottleneck
  saved = [t.detach().clone() for t in (head.weight, head.bias)]
  with torch.no_grad():
    for t in (head.weight, head.bias):
      t.zero_()
  paths['bottleneck'] = os.path.join(root, f'{name}_bottleneck.rnsrv')
  serving.export_serving(model, paths['bottleneck'], chunk=SERVE_CHUNK,
                         device=dev, near=config.near, far=config.far)
  with torch.no_grad():
    for t, v in zip((head.weight, head.bias), saved):
      t.copy_(v)

  # A fresh process loads the kernels' artifact and serves the rays.
  rays_npz = os.path.join(root, f'{name}_rays.npz')
  out_npz = os.path.join(root, f'{name}_out.npz')
  np.savez(rays_npz, **{f: getattr(rays, f).cpu().numpy()
                        for f in serving.RAY_FIELDS})
  return (paths['on'], rays_npz, out_npz), lambda res, proc_s: artifact_check(
      fused_mlp, name, model, config, rays, plain, kern, paths, served,
      off_served, want_launches, export_s, size, load_here_s, out_npz, res,
      proc_s)


def artifact_check(fused_mlp, name, model, config, rays, plain, kern, paths,
                   served, off_served, want_launches, export_s, size,
                   load_here_s, out_npz, res, proc_s):
  """Phase 21 for one model, after the fresh process served its rays
  (`artifact_case`'s finish)."""
  from refnerf_tpu_torch import serving
  from refnerf_tpu_torch.models import renderer
  cdt = model.nerf_mlp.cfg.compute_dtype
  loaded = dict(np.load(out_npz))
  check = check_rendering({k: torch.from_numpy(v) for k, v in loaded.items()},
                          (SERVE_CHUNK,), config,
                          model.nerf_mlp.cfg.rgb_padding)
  bound = SERVE_BOUND[cdt]
  vs_plain = max_diffs(loaded, plain, config.far)
  spread = spread_reads(loaded, plain)
  vs_kern = max_diffs(loaded, kern, config.far)
  log(f'phase 21: {name}: a fresh process ({proc_s:.1f} s for every '
      f'model\'s artifact) loaded the artifact in {res["load_s"]:.2f} s ({res["load_parts"]}) and served {SERVE_CHUNK} rays in '
      f'{res["first_ms"]:.1f} ms, launches {res["launches"]}, modules of '
      f'{FOREIGN} imported: {res["foreign"]}; {check}; vs '
      f"fused_trunk='off': spread_l2 {spread} (bound {bound}), max diff "
      f'{vs_plain} (distance over far); max diff vs the in-process kernels '
      f'{vs_kern} (bit for bit: 0)')
  if res['foreign']:
    raise AssertionError(f'phase 21: {name}: the serving process imported '
                         f'{res["foreign"]}')
  if res['launches'] != want_launches:
    raise AssertionError(f'phase 21: {name}: launches {res["launches"]}, '
                         f'expected {want_launches}')
  if max(spread.values()) > bound or max(vs_kern.values()) > 0:
    raise AssertionError(f'phase 21: {name}: the loaded artifact disagrees')
  # Each planted fault must read above the plain render's bound and fail
  # the bit for bit check against the in-process kernels.
  faults, moved = {}, {}
  for f in ('skip', 'fault', 'bottleneck'):
    got = serving.load_serving(paths[f])(rays)
    faults[f] = max(spread_reads(got, plain).values())
    moved[f] = max(max_diffs(got, kern, config.far).values())
  log(f'phase 21: {name}: planted faults against the plain render, spread_l2 '
      f'over the bound {bound}: skip columns dropped from the pack '
      f'{faults["skip"] / bound:.1f}, fields out of order '
      f'{faults["fault"] / bound:.1f}, the bottleneck head zeroed '
      f'{faults["bottleneck"] / bound:.1f}; max diff against the in-process '
      f'kernels {moved} (bit for bit: 0)')
  if not (min(faults.values()) > bound and min(moved.values()) > 0):
    raise AssertionError(f'phase 21: {name}: a planted fault reads within '
                         'its bound')

  # The three arms in turns.
  set_mode(model, fused_trunk='on')
  arms = {'artifact': lambda: served(rays),
          'in-process': lambda: renderer.render_rays(model, rays, SERVE_CHUNK),
          'off artifact': lambda: off_served(rays)}
  times = {a: [] for a in arms}
  with torch.no_grad():
    for run in arms.values():
      run()
    for _ in range(REQUESTS):
      for a, run in arms.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times[a].append((time.perf_counter() - t0) * 1e3)
  timing = {a: dict(median_ms=float(np.median(v)),
                    p90_ms=float(np.percentile(v, 90))) for a, v in times.items()}
  log(f'phase 21: {name} {cdt}: {REQUESTS} {SERVE_CHUNK}-ray requests of '
      f'each arm in turns: {json.dumps(timing)}')
  summary = dict(export_s=export_s, bytes=size, load_s=res['load_s'],
                 load_here_s=load_here_s,
                 process_s=proc_s, first_ms=res['first_ms'],
                 vs_plain=vs_plain, spread_l2=spread, bound=bound,
                 vs_kernels=vs_kern, skip_dropped=faults['skip'],
                 fields_swapped=faults['fault'],
                 bottleneck_zeroed=faults['bottleneck'],
                 faults_vs_kernels=moved,
                 requests=timing)
  del off_served, model
  torch.cuda.empty_cache()
  return res['launches'], summary, (paths['on'], served, rays, config)


def http_check(path, served, rays, config, trips=3):
  """Phase 21: `trips` /render POSTs of the rays to tools/serve_http.py on
  127.0.0.1 serving the artifact at `path`, the rgb equal to the direct
  call's (`served`, the same artifact loaded); returns the round trips'
  median ms."""
  import threading
  import urllib.request
  from refnerf_tpu_torch.tools import serve_http
  server = serve_http.make_server(path, '127.0.0.1', 0)
  thread = threading.Thread(target=server.serve_forever, daemon=True)
  thread.start()
  try:
    n = rays.origins.shape[0]
    payload = json.dumps({
        'origins': rays.origins.cpu().tolist(),
        'directions': rays.directions.cpu().tolist(),
        'viewdirs': rays.viewdirs.cpu().tolist(),
        'radii': rays.radii.cpu().tolist(), 'near': float(config.near),
        'far': float(config.far)}).encode()
    url = f'http://127.0.0.1:{server.server_port}/render'
    times = []
    for _ in range(trips):
      req = urllib.request.Request(url, data=payload, method='POST', headers={
          'Content-Type': 'application/json'})
      t0 = time.perf_counter()
      with urllib.request.urlopen(req, timeout=300) as r:
        out = json.loads(r.read())
      times.append((time.perf_counter() - t0) * 1e3)
  finally:
    server.shutdown()
    server.server_close()
    thread.join()
  direct = served.serve_image(rays.reshape(n, 1))
  diff = float(np.abs(np.asarray(out['rgb'], np.float32) -
                      direct['rgb'][:, 0]).max())
  log(f'phase 21: /render POST of {n} rays ({len(payload)} bytes): round '
      f'trips {", ".join(f"{t:.1f}" for t in times)} ms; buffers '
      f'{sorted(out)}; max |rgb| diff vs the direct call {diff:.3e}')
  if diff > 1e-6 or sorted(out) != ['acc', 'rgb']:
    raise AssertionError('phase 21: /render disagrees with the direct call')
  return float(np.median(times))


def serving_stage(fused_mlp, dev):
  """Phase 21: the flagship (bf16, six flags) and mip-NeRF (f32) served from
  artifacts; the HTTP host; bench_render and profile_step. Returns ({name:
  the fresh process's launches}, a summary)."""
  import tempfile
  from refnerf_tpu_torch.tools import bench_render
  from refnerf_tpu_torch.tools import profile_step
  root = tempfile.mkdtemp(prefix='refnerf_serve_')
  path, out = {}, {}
  try:
    cases = {name: artifact_case(fused_mlp, dev, root, name)
             for name in ARTIFACTS}
    # One fresh process loads every model's kernels' artifact and serves
    # its rays.
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-c', 'import sys, chip_smoke; '
         'sys.exit(chip_smoke.load_and_serve(*sys.argv[1:]))',
         *[a for files, _ in cases.values() for a in files]], cwd=repo,
        capture_output=True, text=True, timeout=600)
    proc_s = time.perf_counter() - t0
    if proc.returncode != 0:
      raise AssertionError(f'phase 21: the serving process failed: '
                           f'{proc.stderr[-3000:]}')
    lines = proc.stdout.strip().splitlines()[-len(cases):]
    for (name, (_, finish)), line in zip(cases.items(), lines):
      path[name], out[name], served = finish(json.loads(line), proc_s)
      if name == 'flagship':
        out['http_ms'] = http_check(*served)
      del served
    del cases
  finally:
    shutil.rmtree(root, ignore_errors=True)
  out['bench_render'] = bench_render.main(['--frames', '3',
                                           '--device', dev.type])
  prof = profile_step.main(['--steps', '5', '--device', dev.type])
  out['profile_step'] = {k: prof[k] for k in (
      'ms_per_step', 'traced_ms_per_step', 'rays_per_sec',
      'device_ms_per_step')}
  torch.cuda.empty_cache()
  return path, out


# Phase 22: data parallelism. The ranks are processes of torchrun, each
# running refnerf_tpu_torch/testing/data_parallel.py (or a CLI); on this
# machine's one card they share it over gloo (DP_DEVICE), and NCCL runs at
# one rank (two ranks only where there are two cards).
DP_RANKS, DP_STEPS, DP_TIMEOUT = 2, 2, 420
DP_DEVICE, DP_BACKEND = 'cuda:0', 'gloo'
DP_ENV = ('RANK', 'LOCAL_RANK', 'WORLD_SIZE', 'LOCAL_WORLD_SIZE',
          'MASTER_ADDR', 'MASTER_PORT')
# Two ranks against one process on the same state and global batch; they
# differ by the order of f32 sums (the loss's, the masked means', the
# weight gradients' over 2,048 rays against 4,096). Set from the spread of
# the first run on the card (PERF.md section 6): the losses and each
# masked-mean term relative, the reduced gradients by global relative L2
# (H8: never by their max), the parameters by their largest difference over
# the step's largest move. Each planted fault must read above its bound.
DP_LOSS_BOUND, DP_GRAD_BOUND, DP_MOVE_BOUND = 1e-5, 1e-4, 1e-2
DP_TERM_BOUND = 1e-4
DP_FAULT_TERMS = ('diffuse_consistency', 'specular_consistency',
                  'normals_consistency', 'distance_consistency',
                  'weights_entropy')
# The flagship of phase 10 (bf16, the six fuse flags, bench.py's bindings).
DP_FLAGSHIP = [f'Config.seed = {SEED}', "NerfMLP.compute_dtype = 'bfloat16'",
               f'Config.batch_size = {TRAIN_BATCH}',
               'Config.randomized = False', 'Config.sample_noise_size = 0',
               *FUSE, *SPATIAL]
DP_CLI_STEPS, DP_CLI_KILL = 4, 2
REMAT_STEPS = 3


def _free_port():
  import socket
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    return s.getsockname()[1]


def torchrun(nproc, args, what, timeout=DP_TIMEOUT):
  """`python -m torch.distributed.run` of `args` on `nproc` ranks of this
  host, in a session of its own (killed whole on a timeout); raises unless
  it exits 0. Returns (its output, seconds)."""
  import signal
  root = os.path.dirname(os.path.abspath(__file__))
  env = {k: v for k, v in os.environ.items() if k not in DP_ENV}
  env['PYTHONPATH'] = root + os.pathsep + env.get('PYTHONPATH', '')
  cmd = [sys.executable, '-m', 'torch.distributed.run',
         f'--nproc_per_node={nproc}', '--master_addr=127.0.0.1',
         f'--master_port={_free_port()}', *args]
  t0 = time.perf_counter()
  proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          start_new_session=True)
  try:
    out, _ = proc.communicate(timeout=timeout)
  except subprocess.TimeoutExpired:
    os.killpg(proc.pid, signal.SIGKILL)
    out, _ = proc.communicate()
    raise AssertionError(f'{what}: torchrun timed out after {timeout} s:\n'
                         f'{out[-4000:]}')
  if proc.returncode != 0:
    raise AssertionError(f'{what}: torchrun exited {proc.returncode}:\n'
                         f'{out[-6000:]}')
  return out, time.perf_counter() - t0


def cli_one_rank(argv):
  """The train CLI with `argv` in this process as one rank of a world of
  one (the environment torchrun gives a rank: RANK, LOCAL_RANK,
  WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), its standard
  output captured. Returns (the output, seconds)."""
  import io
  from refnerf_tpu_torch.cli import train as train_cli
  env = dict(RANK='0', LOCAL_RANK='0', WORLD_SIZE='1', LOCAL_WORLD_SIZE='1',
             MASTER_ADDR='127.0.0.1', MASTER_PORT=str(_free_port()))
  saved = {k: os.environ.get(k) for k in env}
  os.environ.update(env)
  out = io.StringIO()
  t0 = time.perf_counter()
  try:
    with contextlib.redirect_stdout(out):
      train_cli.main(argv)
  finally:
    for k, v in saved.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v
  return out.getvalue(), time.perf_counter() - t0


def _flat_rel(got, want):
  """|got - want|_2 / |want|_2 over every tensor of two dicts."""
  num = sum(float(((got[k].double() - w.double())**2).sum())
            for k, w in want.items())
  den = sum(float((w.double()**2).sum()) for w in want.values())
  return math.sqrt(num / den)


def _move_rel(got, want, before):
  """The largest |got - want| over the largest move want - before, taken
  over every parameter."""
  diff = max(float((got[k] - w).abs().max()) for k, w in want.items())
  move = max(float((w - before[k]).abs().max()) for k, w in want.items())
  return diff / move


def _dp_compare(one, rank, steps):
  """Per step: the loss's relative difference, each term's, the reduced
  gradients' relative L2 and the parameters' largest difference over the
  largest move, of `rank`'s record against the one-process record."""
  out = []
  for s in range(steps):
    before = one['start'] if s == 0 else one['params'][s - 1]
    rel = lambda a, b: abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
    out.append(dict(
        loss=rel(rank['loss'][s], one['loss'][s]),
        terms={k: rel(rank['losses'][s][k], v)
               for k, v in one['losses'][s].items()},
        grads=_flat_rel(rank['grads'][s], one['grads'][s]),
        params=_move_rel(rank['params'][s], one['params'][s], before)))
  return out


def _same_params(a, b, steps):
  return all(torch.equal(a['params'][s][k], b['params'][s][k])
             for s in range(steps) for k in a['params'][s])


def data_parallel_stage(fused_mlp, dev):
  """Phase 22: the flagship trained on two ranks sharing the card (gloo),
  against one process; three planted faults; the train CLI in the same
  ranks (a kill and a resume, bit for bit against NeRFSystem's
  uninterrupted two-rank run; a test view split across the ranks): one
  torchrun launch for all of them; the CLI with NCCL at one rank in this
  process.
  Returns (a rank's launches in the flagship's DP_STEPS steps, a summary)."""
  import tempfile
  from refnerf_tpu_torch.testing import data_parallel as dp
  from refnerf_tpu_torch.tools import sphere_scene
  root = tempfile.mkdtemp(prefix='refnerf_dp_')
  res = {}
  try:
    t0 = time.perf_counter()
    blender = sphere_scene.make_scene(os.path.join(root, 'blender'),
                                      CASCADE_TRAIN, CASCADE_TEST,
                                      CASCADE_RES)
    llff = sphere_scene.make_llff_scene(os.path.join(root, 'llff'),
                                        GEO_VIEWS, GEO_W, GEO_H, GEO_FACTOR)
    res['scenes_s'] = time.perf_counter() - t0
    model, config, state, _, batch = train_setup(dev, FUSE + SPATIAL)
    levels = model.cfg.num_levels
    state_path = os.path.join(root, 'state.pt')
    batch_path = os.path.join(root, 'batch.pt')
    dp.save_state(state_path, state)
    dp.save_batch(batch_path, batch.map(lambda x: x.cpu()))
    del model, state, batch
    torch.cuda.empty_cache()
    gin = lambda name: os.path.join(os.path.dirname(os.path.abspath(
        __file__)), 'configs', name)
    out_dir = os.path.join(root, 'out')
    flag = dict(kind='steps', gin=gin(FLAGSHIP), bindings=DP_FLAGSHIP,
                state=state_path, batch=batch_path, out=out_dir)
    # The geometry gin's acc thresholds (0.1) pass every ray of the
    # untrained field: full masks, whose per-rank ratios are the global
    # ratio, so no reduction fault can show. At dp.threshold_bindings the
    # ranks' masks hold different counts.
    run = geometry_setup(dev, llff)
    run['ds'].seek(GEO_START)
    rays = next(run['ds']).rays.map(lambda x: x.to(dev))
    train_frac = (GEO_START - 1) / (run['config'].max_steps - 1)
    with torch.no_grad():
      acc = run['model'](run['cast'](run['cameras'], rays),
                         train_frac=train_frac, train=True)[0][-1]['acc']
    thresholds = dp.threshold_bindings(
        acc, min(run['config'].sample_noise_size, acc.shape[0]), DP_RANKS)
    del run, rays, acc
    geo = dict(kind='steps', gin=gin(GEO), out=out_dir, steps=1,
               start_step=GEO_START, bindings=[
                   f'Config.seed = {SEED}', f"Config.data_dir = '{llff}'",
                   *thresholds])
    # No validation views: the split render is checked on its own.
    system_bindings = DP_FLAGSHIP + [
        f"Config.data_dir = '{blender}'", 'Config.checkpoint_every = 2',
        'Config.print_every = 1', 'Config.val_sample_num = 0']
    exp = os.path.join(root, 'exp')
    # The train CLI on the same gin, in the same ranks (after the runs
    # above: it joins and leaves the group itself), killed at DP_CLI_KILL,
    # then resumed; its last checkpoint must be NeRFSystem's uninterrupted
    # run's, bit for bit.
    cli = [f'--gin_configs={gin(FLAGSHIP)}',
           *[f'--gin_bindings={b}' for b in system_bindings + [
               f"Config.checkpoint_dir = '{exp}'",
               "Config.exp_name = 'dp_cli'",
               f'Config.max_steps = {DP_CLI_STEPS}']],
           f'--device={DP_DEVICE}', f'--dist_backend={DP_BACKEND}']
    runs = [
        dict(flag, name='flagship', steps=DP_STEPS),
        dict(flag, name='skip_reduce', steps=1, fault='skip_reduce'),
        dict(flag, name='same_half', steps=1, fault='same_half'),
        dict(geo, name='geometry'),
        dict(geo, name='ratio_mean', fault='ratio_mean'),
        dict(kind='system', name='system', gin=gin(FLAGSHIP),
             bindings=system_bindings, exp=exp, steps=DP_CLI_STEPS,
             out=out_dir),
        dict(kind='cli', name='killed', argv=cli + [
            f'--gin_bindings=Config.early_exit_steps = {DP_CLI_KILL}']),
        dict(kind='cli', name='resumed', argv=cli)]
    spec = os.path.join(root, 'spec.json')
    with open(spec, 'w') as f:
      json.dump(dict(device=DP_DEVICE, backend=DP_BACKEND, runs=runs), f)
    # One process first, on the same files.
    one = {r['name']: dp.run(dict(r, out=None), None, dev)
           for r in (runs[0], runs[3])}
    text, res['ranks_s'] = torchrun(DP_RANKS, [
        '-m', 'refnerf_tpu_torch.testing.data_parallel', spec],
        'phase 22 ranks')
    for r in range(DP_RANKS):
      if f'rank {r}: {len(runs)} runs done' not in text:
        raise AssertionError(f'phase 22: rank {r} did not finish:\n'
                             f'{text[-4000:]}')
    # Rank 0's output of each CLI run (the CLI prints on rank 0 alone).
    cli_text = lambda name: text.split(f'rank 0: cli {name} begins')[1].split(
        f'rank 0: cli {name} ends')[0]
    killed, resumed = cli_text('killed'), cli_text('resumed')
    rec = lambda name, r: torch.load(os.path.join(out_dir,
                                                  f'{name}.rank{r}.pt'),
                                     weights_only=False)
    two = {name: [rec(name, r) for r in range(DP_RANKS)]
           for name in ('flagship', 'skip_reduce', 'same_half', 'geometry',
                        'ratio_mean', 'system')}

    # (1) the flagship: every rank against one process, per step.
    f0, f1 = two['flagship']
    if not _same_params(f0, f1, DP_STEPS):
      raise AssertionError('phase 22: the ranks hold different parameters')
    want = {k: levels * v for k, v in SIX_PER_STEP.items()}
    for r, rank in enumerate(two['flagship']):
      for s, got in enumerate(rank['launches']):
        got = {k: v for k, v in got.items() if v}
        if got != want:
          raise AssertionError(f'phase 22: rank {r} step {s} launched {got}, '
                               f'expected {want}')
    spread = _dp_compare(one['flagship'], f0, DP_STEPS)
    res['spread'] = spread
    worst = dict(loss=max(s['loss'] for s in spread),
                 grads=max(s['grads'] for s in spread),
                 params=max(s['params'] for s in spread))
    # (1) the faults, each read where its bound reads.
    skip = _dp_compare(one['flagship'], two['skip_reduce'][1], 1)[0]
    half = _dp_compare(one['flagship'], two['same_half'][0], 1)[0]
    geo_ok = _dp_compare(one['geometry'], two['geometry'][0], 1)[0]
    geo_bad = _dp_compare(one['geometry'], two['ratio_mean'][0], 1)[0]
    term_ok = max(geo_ok['terms'][k] for k in DP_FAULT_TERMS)
    term_bad = max(geo_bad['terms'][k] for k in DP_FAULT_TERMS)
    res['faults'] = {
        'skip_reduce': {'grads': skip['grads'],
                        'ranks_equal': _same_params(*two['skip_reduce'], 1)},
        'same_half': {'grads': half['grads'], 'loss': half['loss']},
        'ratio_mean': {'terms': geo_bad['terms']}}
    res['geometry'] = geo_ok
    log(f'phase 22: flagship bf16, six flags, global batch {TRAIN_BATCH} on '
        f'{DP_RANKS} ranks sharing {DP_DEVICE} over {DP_BACKEND} (each '
        f'{TRAIN_BATCH // DP_RANKS} rays) against one process, {DP_STEPS} '
        f'steps: loss rel {worst["loss"]:.2e} (bound {DP_LOSS_BOUND}), '
        f'reduced gradients rel L2 {worst["grads"]:.2e} (bound '
        f'{DP_GRAD_BOUND}), parameters {worst["params"]:.2e} of the largest '
        f'move (bound {DP_MOVE_BOUND}); the ranks bit-identical after every '
        f'step; each rank launched {want} a step')
    log(f'phase 22: faults: one rank skips the reduction: gradients rel L2 '
        f'{skip["grads"]:.3e}, ranks equal '
        f'{res["faults"]["skip_reduce"]["ranks_equal"]}; both ranks on the '
        f'same half: gradients rel L2 {half["grads"]:.3e}; the LLFF geometry '
        f'gin (f32, batch 1024, step {GEO_START}, {thresholds}) with '
        f'masked means reduced '
        f'as a mean of per-rank ratios: terms rel {term_bad:.3e} against '
        f'{term_ok:.3e} reduced right (bound {DP_TERM_BOUND}); '
        f'{json.dumps(geo_ok["terms"])}')
    if not (worst['loss'] <= DP_LOSS_BOUND and worst['grads'] <= DP_GRAD_BOUND
            and worst['params'] <= DP_MOVE_BOUND):
      raise AssertionError('phase 22: two ranks disagree with one process')
    if not (geo_ok['loss'] <= DP_LOSS_BOUND and term_ok <= DP_TERM_BOUND and
            geo_ok['grads'] <= DP_GRAD_BOUND):
      raise AssertionError('phase 22: the geometry gin on two ranks '
                           'disagrees with one process')
    if not (skip['grads'] > DP_GRAD_BOUND and half['grads'] > DP_GRAD_BOUND
            and term_bad > DP_TERM_BOUND and
            not res['faults']['skip_reduce']['ranks_equal']):
      raise AssertionError('phase 22: a planted fault reads within bounds')
    one_ms = float(np.median(one['flagship']['ms'][1:]))
    two_ms = float(np.median(f0['ms'][1:]))
    res['one_process_ms'], res['two_ranks_one_card_ms'] = one_ms, two_ms

    # (2) NeRFSystem on two ranks, uninterrupted; the split view.
    for r, sysrec in enumerate(two['system']):
      if not (sysrec['render_equal'] and sysrec['step'] == DP_CLI_STEPS):
        raise AssertionError(f'phase 22: rank {r}: step {sysrec["step"]}, '
                             f'split view equal {sysrec["render_equal"]} '
                             f'{sysrec["render_max_diff"]}')
    # The train CLI's two runs (killed, resumed) in the ranks above.
    if (f'Resumed from step {DP_CLI_KILL}' not in resumed or
        resumed.count('Training with') != 1):
      raise AssertionError(f'phase 22: the CLI did not resume once:\n'
                           f'{resumed[-3000:]}')
    for what, text in (('killed', killed), ('resumed', resumed)):
      for line in text.splitlines():
        if line.startswith(('step ', 'Resumed')):
          log(f'phase 22: train CLI ({what}): {line}')
    ckpt = lambda name: torch.load(os.path.join(
        exp, 'ckpt', 'dp', name, 'last', str(DP_CLI_STEPS), 'state.pt'),
        map_location='cpu', weights_only=True)
    a, b = ckpt('dp_cli'), ckpt('dp_full')
    same = all(torch.equal(v, b['model'][k]) for k, v in a['model'].items())
    same = same and all(torch.equal(v, b[m][k]) for m in ('mu', 'nu')
                        for k, v in a[m].items())
    if not same:
      raise AssertionError('phase 22: the CLI killed and resumed differs '
                           "from NeRFSystem's uninterrupted two-rank run")
    log(f'phase 22: train CLI on {DP_RANKS} ranks ({DP_BACKEND}, '
        f'{DP_DEVICE}; in the ranks of the launch above, {res["ranks_s"]:.1f} '
        f's with every run), {FLAGSHIP} bf16 six flags at batch {TRAIN_BATCH} '
        f'from a {CASCADE_TRAIN} + {CASCADE_TEST} view scene at '
        f'{CASCADE_RES} x {CASCADE_RES}: killed at step {DP_CLI_KILL}, '
        f'resumed to {DP_CLI_STEPS}; its checkpoint equals NeRFSystem\'s '
        f'uninterrupted two-rank run; test view 0 split across the ranks '
        f'equals one rank\'s render bit for bit')

    # (3) NCCL: at one rank here, the CLI in this process with the
    # environment torchrun gives a rank; at two only with a card a rank.
    nccl = lambda name: [
        '-m', 'refnerf_tpu_torch.cli.train', f'--gin_configs={gin(FLAGSHIP)}',
        *[f'--gin_bindings={b}' for b in system_bindings + [
            f"Config.checkpoint_dir = '{exp}'", 'Config.max_steps = 2',
            f"Config.exp_name = '{name}'"]],
        '--device=cuda', '--dist_backend=nccl']
    text, res['nccl_1_s'] = cli_one_rank(nccl('dp_nccl')[2:])
    if 'step 2/2' not in text:
      raise AssertionError(f'phase 22: NCCL at one rank:\n{text[-3000:]}')
    cards = torch.cuda.device_count()
    if cards >= 2:
      text, res['nccl_2_s'] = torchrun(2, nccl('dp_nccl2'),
                                       'phase 22 NCCL at two ranks')
      if 'step 2/2' not in text:
        raise AssertionError(f'phase 22: NCCL at two ranks:\n{text[-3000:]}')
      nccl2 = f'NCCL at 2 ranks, one card each: {res["nccl_2_s"]:.1f} s'
    else:
      nccl2 = (f'NCCL at 2 ranks did not run: torch.cuda.device_count() = '
               f'{cards}, and NCCL needs one card a rank')
    log(f'phase 22: train CLI with NCCL at one rank (2 steps): '
        f'{res["nccl_1_s"]:.1f} s; {nccl2}')
    log(f'phase 22: ms a step, two ranks sharing one card (no scaling '
        f'figure): {two_ms:.2f} ms a step of {TRAIN_BATCH} rays, against '
        f'{one_ms:.2f} ms in one process (median of steps 2-{DP_STEPS})')
    return f0['launches'], res
  finally:
    shutil.rmtree(root, ignore_errors=True)


def remat_run(fused_mlp, dev, bindings):
  """REMAT_STEPS steps of train_setup's model with `bindings`: the
  parameters, losses, launches, peak bytes allocated after a reset, ms a
  step (the median of the steps after the first), and the launches of one
  train forward alone (no backward)."""
  model, config, state, train_step, batch = train_setup(dev, bindings)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  for k in fused_mlp.launches:
    fused_mlp.launches[k] = 0
  losses, times = [], []
  for _ in range(REMAT_STEPS):
    t0 = time.perf_counter()
    state, stats = train_step(state, batch)
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
    losses.append(stats['loss'])
  # The first step warms the caches up, as in phase 22.
  ms = float(np.median(times[1:])) * 1e3
  out = dict(params={k: p.detach().clone() for k, p in model.named_parameters()},
             losses=torch.stack(losses), launches=dict(fused_mlp.launches),
             peak=torch.cuda.max_memory_allocated(), ms=ms, remat=model.remat)
  for k in fused_mlp.launches:
    fused_mlp.launches[k] = 0
  model(batch.rays, train_frac=0.5, train=True)
  out['forward'] = dict(fused_mlp.launches)
  del model, state, train_step, batch
  torch.cuda.empty_cache()
  return out


def remat_stage(fused_mlp, dev):
  """Phase 23: Model.remat. The flagship (bf16, six flags, batch 4096) and
  phase 19's bf16 cascade, REMAT_STEPS steps with and without remat: bit
  for bit the same, the forwards launched twice, the peak memory. Returns
  (the flagship's launches with remat, a summary)."""
  res = {}
  cascade = CASCADE + CASCADE_ON + FUSE + SPATIAL + [
      "PropMLP.compute_dtype = 'bfloat16'"]
  for name, bindings in (('flagship', FUSE + SPATIAL), ('cascade', cascade)):
    plain = remat_run(fused_mlp, dev, bindings)
    remat = remat_run(fused_mlp, dev, bindings + ['Model.remat = True'])
    if not remat['remat'] or plain['remat']:
      raise AssertionError('phase 23: Model.remat was not honoured')
    same = torch.equal(plain['losses'], remat['losses']) and all(
        torch.equal(v, remat['params'][k]) for k, v in plain['params'].items())
    n = plain['launches']
    # Every forward launch of a step runs again in its backward: the
    # launches of one train forward alone, once more a step.
    want = {k: v + REMAT_STEPS * plain['forward'][k] for k, v in n.items()}
    res[name] = dict(bit_for_bit=same, launches=n,
                     remat_launches=remat['launches'],
                     forward_launches=plain['forward'],
                     peak_gib=plain['peak'] / 2**30,
                     remat_peak_gib=remat['peak'] / 2**30, ms=plain['ms'],
                     remat_ms=remat['ms'])
    log(f'phase 23: {name} bf16 six flags, batch {TRAIN_BATCH}, '
        f'{REMAT_STEPS} steps with Model.remat and without: bit for bit '
        f'{same}; launches without {json.dumps({k: v for k, v in n.items() if v})}'
        f', with {json.dumps({k: v for k, v in remat["launches"].items() if v})}; '
        f'peak allocated {plain["peak"] / 2**30:.3f} GiB without, '
        f'{remat["peak"] / 2**30:.3f} GiB with; {plain["ms"]:.2f} ms a step '
        f'without, {remat["ms"]:.2f} ms with (median of the steps after '
        f'the first)')
    if not same:
      raise AssertionError(f'phase 23: {name}: the remat step differs')
    if remat['launches'] != want:
      raise AssertionError(f'phase 23: {name}: remat launched '
                           f'{remat["launches"]}, expected {want}')
  return res['flagship']['remat_launches'], res


# Phase 24: mip-NeRF 360's published model (MIPNERF360, in
# refnerf_tpu_torch/testing/mipnerf360.py; no gin file): its NeRF MLP's
# spatial trunk (8 x 1024, the skip at layer 5, the density head and the
# 256-wide bottleneck on 504 IPE columns) on the width-1024 kernels
# (csrc/trunk_w1024.cu), held against the plain
# versions at a 4096-ray request's NeRF samples (4096 x 32) and a step's
# (16,384 x 32 = N_SAMPLES); its directional pair (1 x 128 on 256 + 27
# columns, csrc/trunk_dir1.cu) likewise; then the model trained at its
# batch and served, under 'on' against 'off'.
W1024_NS = (4096 * 32, N_SAMPLES)
M360_BATCH, M360_STEPS = 16384, 3  # the configuration's batch (360.gin's)
# Rays a served request, rendered in one chunk of as many (the Config's
# render_chunk_size of 16,384 would pad it to 16,384 rays).
M360_REQUEST = 4096
# Launches a step: the PropMLP's pair at the two proposal levels (also under
# 'K1 wide' / 'K4 wide'), the NeRF level's width-1024 pair (also 'K1
# w1024' / 'K4 w1024') and its directional pair (K2, K5).
M360_PER_STEP = {'K1': 3, 'K1 wide': 2, 'K1 w1024': 1, 'K2': 1, 'K4': 3,
                 'K4 wide': 2, 'K4 w1024': 1, 'K5': 1}
M360_SCALES = 2.0**np.arange(0, 12)  # the MLP's default max_deg_point 12
# A served request against 'off' (`m360_request`): spread_l2 at most
# M360_SERVE_BOUND[compute dtype]. f32 SERVE_BOUND's. bf16 20 times its
# sound reads on an H100 (1.98e-4 to 1.99e-4, 20 times the flagship's: the
# flip cascade of 8 x 1024 bf16 layers sat at 0.99-1.00 of SERVE_BOUND), as
# SERVE_BOUND is 20 times the flagship's, and 31 times under what the skip
# layer's input dropped from the served pack reads (rgb 0.124).
M360_SERVE_BOUND = {'float32': SERVE_BOUND['float32'], 'bfloat16': 4e-3}


def w1024_case(fused_mlp, gen, dev, n):
  """The NeRF MLP's spatial trunk at full width on n rows: the IPE (f32) of
  random lifted means and variances on 21 basis vectors x 12 degrees (two
  segments of 252), He-scaled weights, the density head and the 256-wide
  bottleneck. Returns (segs, ws, bs, kw, cots): cots the cotangents of
  sigma and the bottleneck (f32)."""
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  lm = torch.rand(n, 21, generator=gen).to(dev) * 3 - 1.5
  lv = 10.0**(torch.rand(n, 21, generator=gen).to(dev) * 4 - 6)
  segs = list(fused_mlp.encode_ipe(lm, lv, M360_SCALES))
  skips = fused_mlp.skip_input_layers(8, 4)
  ws = []
  for l in range(8):
    k_in = 504 if l == 0 else 1024 + (504 if l in skips else 0)
    ws.append(rand(1024, k_in) * math.sqrt(2 / k_in))
  bs = [rand(1024) * 0.05 for _ in range(8)]
  kw = dict(skip_period=4, wd=rand(1, 1024) / 32, head_f32=None,
            head_cdt=(rand(256, 1024) / 32, rand(256) * 0.1))
  return segs, ws, bs, kw, (rand(n), None, rand(n, 256), None)


def w1024_chain(fused_mlp, cs, ws, bs, kw, cdt, cots=None, needs_dx=False,
                out_y=False):
  """The yardstick of phase 24's trunks (`library_ms`), the nearest chain
  of PyTorch calls at the same shapes in `cdt`: the segments concatenated
  (torch.cat, inside the timed call: the kernels read them in place), the
  layers as torch.nn.functional.linear + relu (the skip layer on the
  concatenated input), then the heads on y: sigma as the f32 dot with the
  density head, the f32 head (on y in f32), the compute-dtype head; with
  `cots` (the heads' cotangents: sigma's, the f32 head's, the compute-dtype
  head's) autograd of that chain, its forward included (the kernel's
  backward recomputes its own), for the parameters and with `needs_dx` the
  segments too; with `out_y` (a forward) y itself among the outputs (K11).
  The width-1024 pair (eight layers, sigma, the bottleneck), the
  directional pair (one layer, the rgb head), the proposal trunk (phase
  19) and, through tools/ab_trees.py's `chain_rows`, the other trunks
  without fused stages. Returns a function of no arguments; the port never
  calls it."""
  F = torch.nn.functional
  dt = fused_mlp.DTYPES[cdt]
  grad = cots is not None
  segs = [c.detach().to(dt).requires_grad_(grad and needs_dx) for c in cs]
  L = len(ws)
  params = [w.detach().to(dt) for w in ws] + [b.detach().to(dt) for b in bs]
  heads = []  # (index of the cotangent, weight, bias or None, f32)
  for i, (key, f32) in enumerate((('wd', True), ('head_f32', True),
                                  ('head_cdt', False))):
    head = kw.get(key)
    if head is None:
      continue
    w, b = (head, None) if key == 'wd' else head
    cast = (lambda t: t.detach().float()) if f32 else (
        lambda t: t.detach().to(dt))
    params.append(cast(w))
    heads.append((i, len(params) - 1, None if b is None else len(params),
                  f32))
    if b is not None:
      params.append(cast(b))
  params = [t.requires_grad_(grad) for t in params]
  skips = fused_mlp.skip_input_layers(L, kw['skip_period'])
  if grad:
    cast = lambda i, c: c.float().reshape(-1, 1) if i == 0 else c.to(
        dt if i == 2 else torch.float32)
    bars = [cast(i, cots[i]) for i, _, _, _ in heads]

  def run():
    x = torch.cat(segs, -1)
    h = x
    for l in range(L):
      h = F.relu(F.linear(torch.cat([h, x], -1) if l in skips else h,
                          params[l], params[L + l]))
    outs = [F.linear(h.float() if f32 else h, params[w],
                     None if b is None else params[b])
            for _, w, b, f32 in heads]
    if not grad:
      return [h] + outs if out_y else outs
    return torch.autograd.grad(outs, params + (segs if needs_dx else []),
                               bars)
  return run


def w1024_faults(fused_mlp, cs, ws, bs, kw, cots, cdt):
  """What two planted faults of the width-1024 pair would read on the plain
  versions, as `errors` reads the kernels (share of KERNEL_BOUND on the
  values, of GRAD_BOUND on each gradient): `skip input dropped`, the skip
  layer's second K segment (the trunk input beside h) left out of its
  product, forward and backward; `last slab dropped`, the backward's last
  slab of fused_mlp.bwd_slab_rows(1024) rows missing from every sum over
  rows. Fails
  unless each reads above its bound."""
  n = cs[0].shape[0]
  with torch.no_grad():
    want = flatten(fused_mlp.trunk_reference(cs, ws, bs, compute_dtype=cdt,
                                             **kw))
    want_b = flatten(fused_mlp.trunk_backward_reference(
        cs, ws, bs, cots, compute_dtype=cdt, **kw)[:7])
    bad = [w.clone() for w in ws]
    bad[5][:, 1024:] = 0
    got = flatten(fused_mlp.trunk_reference(cs, bad, bs, compute_dtype=cdt,
                                            **kw))
    got_b = flatten(fused_mlp.trunk_backward_reference(
        cs, bad, bs, cots, compute_dtype=cdt, **kw)[:7])
    reads = {'skip input dropped': max(
        r[3] for r in errors(got + got_b, want + want_b, cdt, len(want)))}
    keep = n - fused_mlp.bwd_slab_rows(1024)
    got_b = flatten(fused_mlp.trunk_backward_reference(
        [c[:keep] for c in cs], ws, bs,
        tuple(None if c is None else c[:keep] for c in cots),
        compute_dtype=cdt, **kw)[:7])
    reads['last slab dropped'] = max(r[3] for r in errors(got_b, want_b, cdt,
                                                          0))
    del want, want_b, got, got_b, bad
  log(f'phase 24: width-1024 pair {cdt} N={n} [{CARD}]: planted faults '
      'would read ' +
      ', '.join(f'{k} {v:.2f}' for k, v in reads.items()) +
      ' times the bound')
  if not min(reads.values()) > 1:
    raise AssertionError(f'phase 24: the bounds do not see a planted fault: '
                         f'{reads}')
  return reads


# The directional pair's planted faults are read at this many rows (a
# 256-ray request's NeRF samples): one 64-row tile is 1/128 of them, whose
# share of dW1 reads ~1.8 times bf16's GRAD_BOUND by relative L2, where at
# N_SAMPLES it would read ~0.2 of it (a relative L2 bound sees a share of
# rows, not which rows).
DIR1_FAULT_ROWS = 8192


def dir1_case(gen, dev, n):
  """mip-NeRF 360's directional trunk on n rows: [bottleneck 256 in [-1,
  1] | the positional encoding of degree 4 of random unit directions, 27],
  He-scaled W1, the rgb head, rgb's cotangent (f32). Returns (segs, ws, bs,
  kw, cots)."""
  from refnerf_tpu_torch.ops import coord
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  d = rand(n, 3)
  segs = [torch.rand(n, 256, generator=gen).to(dev) * 2 - 1,
          coord.pos_enc(d / d.norm(dim=-1, keepdim=True), 0, 4)]
  ws, bs = [rand(128, 283) * math.sqrt(2 / 283)], [rand(128) * 0.05]
  kw = dict(skip_period=4, wd=None, head_f32=(rand(3, 128) / 11.3,
                                              rand(3) * 0.1), head_cdt=None)
  return segs, ws, bs, kw, (None, rand(n, 3), None, None)


def dir1_faults(fused_mlp, cs, ws, bs, kw, cots, cdt):
  """What two planted faults of the directional pair would read on the
  plain versions at DIR1_FAULT_ROWS rows, as `errors` reads the kernels
  (share of KERNEL_BOUND on rgb, of GRAD_BOUND on each gradient and dx):
  `27-column segment dropped`, W1's columns past the bottleneck zeroed,
  forward and backward; `one tile missing from dW1`, the second tile's rows
  (64 in bf16, 128 in f32: the kernels' tiles) left out of dW1 and db1.
  Fails unless each reads above its bound."""
  n = DIR1_FAULT_ROWS
  xs = [c[:n] for c in cs]
  cn = tuple(None if c is None else c[:n] for c in cots)
  run = lambda segs, w, c: (
      flatten(fused_mlp.trunk_reference(segs, w, bs, compute_dtype=cdt,
                                        **kw)),
      flatten(fused_mlp.trunk_backward_reference(
          segs, w, bs, c, compute_dtype=cdt, needs_dx=True, **kw)))
  with torch.no_grad():
    want_f, want_b = run(xs, ws, cn)
    bad = [ws[0].clone()]
    bad[0][:, 256:] = 0
    got_f, got_b = run(xs, bad, cn)
    reads = {'27-column segment dropped': max(
        r[3] for r in errors(got_f + got_b, want_f + want_b, cdt, 1))}
    tile = 64 if cdt == 'bfloat16' else 128
    keep = torch.cat([torch.arange(tile), torch.arange(2 * tile, n)]).to(
        xs[0].device)
    _, got_b = run([x[keep] for x in xs], ws,
                   tuple(None if c is None else c[keep] for c in cn))
    reads['one tile missing from dW1'] = max(
        r[3] for r in errors(got_b[:2], want_b[:2], cdt, 0))
  log(f'phase 24: directional pair {cdt} N={n} [{CARD}]: planted faults '
      'would read ' +
      ', '.join(f'{k} {v:.2f}' for k, v in reads.items()) +
      ' times the bound')
  if not min(reads.values()) > 1:
    raise AssertionError(f'phase 24: the bounds do not see a planted fault '
                         f'of the directional pair: {reads}')
  return reads


def check_w1024_kernels(fused_mlp, dev):
  """Phase 24 (a): the width-1024 forward (sigma and the bottleneck by
  KERNEL_BOUND) and first-order backward (every gradient by GRAD_BOUND,
  given random cotangents of sigma and the bottleneck) against their plain
  versions at W1024_NS rows, in bf16 and f32, the routes asserted, each run
  twice more bit-identical; the planted faults (`w1024_faults`, bf16 and
  f32); then the 283-column directional pair of the same model (K2 and K5
  with dx, csrc/trunk_dir1.cu: `dir1`) likewise, the f32 bound that of
  three TF32 products, and its planted faults (`dir1_faults`). Returns
  ({(name, cdt): compare()'s dict} ('K1 W1024 hc256', 'K4 1st W1024', 'K2
  m360', 'K5 m360' at N_SAMPLES, with their N = 131,072 times under
  'request_*'), {what: planted faults' reads})."""
  gen = torch.Generator().manual_seed(SEED + 24)
  results, faults = {}, {}
  segs, ws, bs, kw, cots = w1024_case(fused_mlp, gen, dev, N_SAMPLES)
  for cdt in ('bfloat16', 'float32'):
    cs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
    cc = cots[:2] + (cots[2].to(fused_mlp.DTYPES[cdt]), None)
    pack = fused_mlp.pack_trunk(ws, bs, (252, 252), compute_dtype=cdt, **kw)
    got = (fused_mlp.forward_library(pack), fused_mlp.backward_library(pack))
    if (got != (fused_mlp.W1024_LIBRARY,) * 2 or
        fused_mlp.missing_instance(pack, 256) is not None):
      raise AssertionError(f'phase 24: the {cdt} width-1024 trunk routed to '
                           f'{got}')
    runs = {}
    for n in W1024_NS:
      xs = [c[:n] for c in cs]
      cn = tuple(None if c is None else c[:n] for c in cc)
      kernel = lambda: fused_mlp.trunk_kernel(xs, pack)
      plain = lambda: fused_mlp.trunk_reference(xs, ws, bs, compute_dtype=cdt,
                                                **kw)
      lib = w1024_chain(fused_mlp, xs, ws, bs, kw, cdt)
      passes = 3 if cdt == 'float32' else 0  # f32: three TF32 passes
      f = compare('K1 W1024 hc256', cdt, kernel, plain, n_values=2,
                  phase=24, iters=3, inputs=xs + pack_tensors(pack), n=n,
                  flops=trunk_flops(ws, n, 257), library=lib,
                  tf32_passes=passes)
      deterministic('K1 W1024 hc256', kernel, phase=24, cdt=cdt)
      kernel = lambda: fused_mlp.trunk_backward_kernel(xs, pack, cn)
      plain = lambda: fused_mlp.trunk_backward_reference(
          xs, ws, bs, cn, compute_dtype=cdt, **kw)
      lib = w1024_chain(fused_mlp, xs, ws, bs, kw, cdt, cn)
      b = compare('K4 1st W1024', cdt, kernel, plain, n_values=0, iters=2,
                  phase=24, inputs=xs + pack_tensors(pack) + list(cn), n=n,
                  flops=trunk_flops(ws, n, 257, backward=True), library=lib,
                  tf32_passes=passes)
      del lib
      deterministic('K4 1st W1024', kernel, phase=24, cdt=cdt)
      runs[n] = (f, b)
      del xs, cn
    (rf, rb), (f, b) = runs[W1024_NS[0]], runs[N_SAMPLES]
    results['K1 W1024 hc256', cdt] = dict(
        f, **{'request_' + k: v for k, v in rf.items()})
    results['K4 1st W1024', cdt] = dict(
        b, **{'request_' + k: v for k, v in rb.items()})
    faults[cdt] = w1024_faults(fused_mlp, [c[:W1024_NS[0] * 2] for c in cs],
                               ws, bs, kw,
                               tuple(None if c is None else
                                     c[:W1024_NS[0] * 2] for c in cc), cdt)
    del pack, cs, cc
    torch.cuda.empty_cache()
  del segs, ws, bs, kw, cots
  torch.cuda.empty_cache()
  # The directional pair: 1 x 128 on [bottleneck 256 | positional encoding
  # of degree 4, 27], the rgb head; K5 returns the segments' cotangents.
  segs, ws, bs, kw, cots = dir1_case(gen, dev, N_SAMPLES)
  for cdt in ('bfloat16', 'float32'):
    cs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
    pack = fused_mlp.pack_trunk(ws, bs, (256, 27), compute_dtype=cdt, **kw)
    got = (fused_mlp.forward_library(pack), fused_mlp.backward_library(pack))
    if (got != (fused_mlp.DIR1_LIBRARY,) * 2 or
        fused_mlp.missing_instance(pack, 0) is not None):
      raise AssertionError(f'phase 24: the {cdt} directional pair routed to '
                           f'{got}')
    passes = 3 if cdt == 'float32' else 0  # f32: three TF32 passes
    runs = {}
    for n in W1024_NS:
      xs = [c[:n] for c in cs]
      cn = (None, cots[1][:n], None, None)
      kernel = lambda: fused_mlp.trunk_kernel(xs, pack)
      f = compare('K2 m360', cdt, kernel,
                  lambda: fused_mlp.trunk_reference(xs, ws, bs,
                                                    compute_dtype=cdt, **kw),
                  n_values=1, phase=24, inputs=xs + pack_tensors(pack), n=n,
                  flops=trunk_flops(ws, n, 3), tf32_passes=passes,
                  library=w1024_chain(fused_mlp, xs, ws, bs, kw, cdt))
      deterministic('K2 m360', kernel, phase=24, cdt=cdt)
      kernel = lambda: fused_mlp.trunk_backward_kernel(xs, pack, cn,
                                                       needs_dx=True)
      b = compare('K5 m360', cdt, kernel,
                  lambda: fused_mlp.trunk_backward_reference(
                      xs, ws, bs, cn, compute_dtype=cdt, needs_dx=True, **kw),
                  n_values=0, iters=3, phase=24, n=n,
                  inputs=xs + pack_tensors(pack) + [cn[1]],
                  flops=trunk_flops(ws, n, 3, backward=True, needs_dx=True),
                  tf32_passes=passes,
                  library=w1024_chain(fused_mlp, xs, ws, bs, kw, cdt, cn,
                                      needs_dx=True))
      deterministic('K5 m360', kernel, phase=24, cdt=cdt)
      runs[n] = (f, b)
      del xs, cn
    (rf, rb), (f, b) = runs[W1024_NS[0]], runs[N_SAMPLES]
    results['K2 m360', cdt] = dict(
        f, **{'request_' + k: v for k, v in rf.items()})
    results['K5 m360', cdt] = dict(
        b, **{'request_' + k: v for k, v in rb.items()})
    faults['directional ' + cdt] = dir1_faults(fused_mlp, cs, ws, bs, kw,
                                               cots, cdt)
    del pack, cs
  del segs, ws, bs, kw, cots
  torch.cuda.empty_cache()
  return results, faults


def m360_setup(dev, dtype, mode='on'):
  """MIPNERF360 at full width, trunks in `dtype` (both MLPs), weights from
  Config.seed, under fused_trunk `mode`; a batch of Config.batch_size
  random rays (bench.py's, from near 0.2 to far 1e6) and pixels, a fresh
  train state and the step (the draws seeded from (seed, step))."""
  from refnerf_tpu_torch import configs
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.models import construct
  from refnerf_tpu_torch.testing.mipnerf360 import MIPNERF360
  from refnerf_tpu_torch.train import step as step_lib
  config, gin = configs.parse([], [
      *MIPNERF360, f'Config.seed = {SEED}',
      f"NerfMLP.compute_dtype = '{dtype}'",
      f"PropMLP.compute_dtype = '{dtype}'",
      f"NerfMLP.fused_trunk = '{mode}'", f"PropMLP.fused_trunk = '{mode}'",
      f'Config.batch_size = {M360_BATCH}'])
  model = construct.construct_model(config, gin, dev)
  n = config.batch_size
  rng = np.random.RandomState(24)
  rays = rays_from(rays_lib, rng.randn(n, 3).astype(np.float32) * 0.1,
                   rng.randn(n, 3).astype(np.float32),
                   np.full((n, 1), 0.001, np.float32), config, dev)
  rays.lossmult = torch.ones(n, 1, device=dev)
  rgb = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32)).to(dev)
  return dict(model=model, config=config, cameras=None,
              batch=rays_lib.Batch(rays=rays, rgb=rgb),
              state=step_lib.create_train_state(config, model),
              train_step=step_lib.make_train_step(model, config))


def m360_train(fused_mlp, run, what):
  """Phase 24 (b): one warm step, then M360_STEPS steps timed one by one
  (the median a step), each kernel launched M360_STEPS x its
  M360_PER_STEP count, every loss term finite; the peak memory allocated
  over the timed steps. Returns (launches, median ms, peak GiB, libraries,
  the last stats)."""
  model, step_fn, batch = run['model'], run['train_step'], run['batch']
  seen, restore = _routes(fused_mlp)
  try:
    run['state'], _ = step_fn(run['state'], batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in fused_mlp.launches:
      fused_mlp.launches[k] = 0
    times, all_stats = [], []
    for _ in range(M360_STEPS):
      t0 = time.perf_counter()
      run['state'], stats = step_fn(run['state'], batch)
      torch.cuda.synchronize()
      times.append(time.perf_counter() - t0)
      all_stats.append(stats)
    launches = dict(fused_mlp.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
  finally:
    restore()
  want = {k: M360_STEPS * M360_PER_STEP.get(k, 0) for k in launches}
  if launches != want:
    raise AssertionError(f'phase 24: {what} launches {launches}, expected '
                         f'{want}')
  for stats in all_stats:
    terms = stats['losses']
    if not (set(terms) == {'data', 'interlevel', 'distortion'} and
            all(torch.isfinite(v).all() for v in terms.values())):
      raise AssertionError(f'phase 24: {what}: loss terms {terms}')
  ms = float(np.median(times)) * 1e3
  last = all_stats[-1]
  log(f'phase 24: {what}: {M360_STEPS} steps after 1 warm-up at batch '
      f'{run["config"].batch_size}: median {ms:.2f} ms a step ('
      + ', '.join(f'{t * 1e3:.2f}' for t in times) +
      f'), {run["config"].batch_size / ms * 1e3:.0f} train rays/s, peak '
      f'{peak:.2f} GiB allocated; loss {last["loss"].item():.6g} (' +
      ', '.join(f'{k} {v.item():.6g}' for k, v in last['losses'].items()) +
      f'); launches {launches}; libraries '
      f'{json.dumps({k: sorted(v) for k, v in seen.items()})}')
  return launches, ms, peak, seen, last


def m360_request(fused_mlp, dev, run, what):
  """Phase 24 (c): a 4096-ray request (eval, one chunk of 4096 rays: the
  NeRF level's trunk on 131,072 samples) through the kernels, timed
  after a warm one, its launches counted (K1 at each level, 'K1 w1024' at
  the NeRF level, K2), then one profiled; against fused_trunk='off' (timed
  too): rgb and the
  distance by spread_l2 within M360_SERVE_BOUND, the distance in the warp's
  normalized space s = (1/t - 1/near) / (1/far - 1/near) (with far = 1e6
  an ulp of s near 1 moves t by ~30%); acc, which the opaque background
  makes 1 on every ray (its spread is rounding), by its largest difference
  within KERNEL_BOUND['float32']. A planted fault of the served model, the
  NeRF MLP's spatial pack without the skip layer's input columns
  (`drop_skip_columns`) run through the kernels, must read above
  M360_SERVE_BOUND. Returns a summary."""
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.models import mlp as mlp_lib
  from refnerf_tpu_torch.models import renderer
  model, config = run['model'], run['config']
  cdt = model.nerf_mlp.cfg.compute_dtype
  rays = random_rays(rays_lib, M360_REQUEST, config, 24, dev)
  chunk = M360_REQUEST

  def timed():
    renderer.render_rays(model, rays, chunk)  # warm-up (packs the weights)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = renderer.render_rays(model, rays, chunk)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3
  for k in fused_mlp.launches:
    fused_mlp.launches[k] = 0
  out, ms = timed()
  launches = {k: v // 2 for k, v in fused_mlp.launches.items() if v}
  if launches != {'K1': 3, 'K1 wide': 2, 'K1 w1024': 1, 'K2': 1}:
    raise AssertionError(f'phase 24: {what} request launches {launches}')
  ranges = check_rendering(out, (M360_REQUEST,), config,
                           model.nerf_mlp.cfg.rgb_padding)
  set_mode(model, fused_trunk='off')
  try:
    before = dict(fused_mlp.launches)
    plain, plain_ms = timed()
    if fused_mlp.launches != before:
      raise AssertionError("phase 24: fused_trunk='off' launched a kernel")
  finally:
    set_mode(model, fused_trunk='on')
  host = lambda t: t.detach().double().reshape(t.shape[0], -1).cpu().numpy()
  warp = lambda t: (1 / t - 1 / config.near) / (1 / config.far -
                                                1 / config.near)
  spread = lambda got: {
      'rgb': spread_l2(host(got['rgb']), host(plain['rgb'])),
      'distance': spread_l2(warp(host(got['distance'])),
                            warp(host(plain['distance'])))}
  reads = spread(out)
  acc_diff = (out['acc'] - plain['acc']).abs().max().item()
  with planted_pack(drop_skip_columns) as planted, mlp_lib.frozen_packs(
      model):
    fault = spread(renderer.render_rays(model, rays, chunk))
  if [m for m, _, _ in planted] != [model.nerf_mlp]:
    raise AssertionError(f'phase 24: {what}: the skip fault went into '
                         f'{len(planted)} packs, not the NeRF MLP\'s alone')
  bound = M360_SERVE_BOUND[cdt]
  log(f'phase 24: {what}: a {M360_REQUEST}-ray request {ms:.1f} ms under "on", '
      f'{plain_ms:.1f} ms under "off"; {ranges}; launches {launches}; vs '
      f"fused_trunk='off' by spread_l2: " + ', '.join(
          f'{k} {v:.3e} ({v / bound:.3f} of the bound)'
          for k, v in reads.items()) +
      f' (bound {bound}), max |acc| diff {acc_diff:.3e} (bound '
      f"{KERNEL_BOUND['float32']}); the skip input dropped from the served "
      'pack would read ' + ', '.join(
          f'{k} {v:.3e} ({v / bound:.1f} times the bound)'
          for k, v in fault.items()))
  if not (max(reads.values()) <= bound and
          acc_diff <= KERNEL_BOUND['float32']):
    raise AssertionError(f'phase 24: {what}: the request disagrees with '
                         'the plain path')
  if not max(fault.values()) > bound:
    raise AssertionError(f'phase 24: {what}: the bound does not see the '
                         f'skip input dropped from the served pack: {fault}')
  prof = profile(lambda: renderer.render_rays(model, rays, chunk),
                 f'{what} request', 1, phase=24)
  busy = None if prof is None else {
      'wall_ms': prof['wall_ms'], 'busy_ms': prof['busy_ms'],
      'top': dict(sorted(prof['kernels'].items(), key=lambda kv: -kv[1])[:6])}
  return dict(ms=ms, off_ms=plain_ms, launches=launches, spread_l2=reads,
              acc_diff=acc_diff, fault_spread_l2=fault, profile=busy)


def m360_stage(fused_mlp, dev):
  """Phase 24 (b)-(c): MIPNERF360 at full width in bf16 and in f32 under
  'on': M360_STEPS steps at batch 16,384 (`m360_train`, the routes
  asserted: the NeRF level's spatial pair on the width-1024 libraries), one
  step against 'off' from the same state (cascade_against_plain: loss
  within TRAIN_LOSS_BOUND, gradient norm within TRAIN_GNORM_BOUND), a bf16
  step profiled, the step under 'off' timed in turns with 'on'; a 4096-ray
  request (`m360_request`). Returns ({dtype: launches}, summary)."""
  out, paths = {}, {}
  for dtype in ('bfloat16', 'float32'):
    run = m360_setup(dev, dtype)
    model = run['model']
    mlp = model.nerf_mlp
    if (mlp.cfg.net_width != 1024 or mlp.spatial_5.in_features != 1528 or
        mlp.viewdir_0.in_features != 283 or model.prop_mlp is None or
        run['config'].batch_size != M360_BATCH or
        not model.cfg.opaque_background):
      raise AssertionError('phase 24: the configuration is not as bound')
    what = f'MIPNERF360 {dtype}'
    launches, ms, peak, seen, last = m360_train(fused_mlp, run, what)
    # The PropMLP's pair: in f32 on the TF32 libraries' head-0 instances.
    f32 = dtype == 'float32'
    want_f = {fused_mlp.W1024_LIBRARY, fused_mlp.DIR1_LIBRARY,
              fused_mlp.WIDE_TF32_LIBRARY if f32
              else fused_mlp.FWD_LIBRARY[dtype]}
    want_b = {fused_mlp.W1024_LIBRARY, fused_mlp.DIR1_LIBRARY,
              fused_mlp.WIDE_TF32_BWD_LIBRARY if f32
              else fused_mlp.BWD_LIBRARY[dtype]}
    if seen != {'forward': want_f, 'backward': want_b}:
      raise AssertionError(f'phase 24: {what} routed to {seen}')
    paths[dtype] = launches
    res = dict(step_ms=ms, rays_s=run['config'].batch_size / ms * 1e3,
               peak_gib=peak, loss=last['loss'].item())
    res['vs_plain'] = cascade_against_plain(fused_mlp, run, run['batch'],
                                            what, phase=24)
    box = {'state': run['state']}

    def step():
      box['state'], _ = run['train_step'](box['state'], run['batch'])
    prof = profile(step, f'{what} train step', 1, phase=24)
    if prof is not None:
      res['profile'] = {k: prof[k] for k in ('wall_ms', 'busy_ms')}
      res['profile']['top'] = dict(sorted(
          prof['kernels'].items(), key=lambda kv: -kv[1])[:6])
    torch.cuda.reset_peak_memory_stats()
    times = in_turns(step, {'on': (model, {'fused_trunk': 'on'}),
                            'off': (model, {'fused_trunk': 'off'})},
                     blocks=2, reps=1)
    res['turns_ms'] = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
    res['off_peak_gib'] = torch.cuda.max_memory_allocated() / 2**30
    set_mode(model, fused_trunk='on')
    res['request'] = m360_request(fused_mlp, dev, run, what)
    out[dtype] = res
    log(f'phase 24: {what} [{CARD}]: {json.dumps(res)}')
    del run, model, mlp, box
    torch.cuda.empty_cache()
  return paths, out


# ---------------------------------------------------------------------------
# Phase 25: the JAX package's default Model (refnerf_tpu_torch/testing/
# mlp_defaults.py DEFAULTS: 3 levels on two MLPs of 8 x 256 on 504 IPE
# columns with the 256-wide bottleneck and density normals), its spatial
# trunk on the wide-input instances in both dtypes: K1 with the bottleneck,
# K3 (the density gradient, u folded chunk by chunk) and K4 with u's
# cotangent (the second-order pass, the tangent made chunk by chunk), and
# the 128-wide head's pair on the same 504 columns.
DEFAULTS_BATCH, DEFAULTS_STEPS = 16384, 2  # Config.batch_size's default
DEFAULTS_REQUEST = 4096
# Launches a step and a request of the defaults: each level's spatial trunk
# (K3 and K4 with u's cotangent in training, K1 in a request, all on the
# wide-input instances) and its directional trunk (trunk_dir1.cu).
DEFAULTS_PER_STEP = {'K2': 3, 'K3': 3, 'K3 wide': 3, 'K4': 3, 'K4 wide': 3,
                     'K5': 3}
DEFAULTS_PER_REQUEST = {'K1': 3, 'K1 wide': 3, 'K2': 3}
# The loss terms of Config()'s defaults.
DEFAULTS_TERMS = ('data', 'interlevel', 'distortion')
# Two variants of the defaults at batch 1024 (a step and a request
# counted): without density normals (the 256-wide head's first-order K4)
# and with a 128-wide bottleneck too (the 128-wide head's K1 and
# first-order K4).
NO_NORMALS = ['NerfMLP.disable_density_normals = True',
              'PropMLP.disable_density_normals = True',
              'Config.batch_size = 1024']
DEFAULTS_VARIANTS = {
    'DEFAULTS_FIRST': NO_NORMALS,
    'DEFAULTS_HC128': NO_NORMALS + ['NerfMLP.bottleneck_width = 128',
                                    'PropMLP.bottleneck_width = 128']}
VARIANT_PER_STEP = {'K1': 3, 'K1 wide': 3, 'K2': 3, 'K4': 3, 'K4 wide': 3,
                    'K5': 3}
# Rows of the planted faults of the chunked contract (on the plain versions).
DEFAULTS_FAULT_ROWS = 8192
# A served request against 'off' (`defaults_request`): spread_l2 at most
# DEFAULTS_SERVE_BOUND[compute dtype], SERVE_BOUND's (the flagship's 8 x 256
# trunks, as these). Its sound reads on an H100: rgb 2.3e-5 in bf16 and
# 7.2e-7 in f32, 0.11 and 0.04 of the bound; the skip layer's input dropped
# from the served packs reads 53 and 530 times it.
DEFAULTS_SERVE_BOUND = dict(SERVE_BOUND)


def defaults_case(fused_mlp, gen, dev, n, hc):
  """The defaults' spatial trunk on n rows: the IPE (f32) of random lifted
  means and variances on 21 basis vectors x 12 degrees (two segments of
  252 columns, 512 packed), 8 x 256 with the skip at layer 5 and He-scaled
  weights, the density head and an hc-wide compute-dtype head; the scale
  fold [252, 21]; random cotangents of sigma, the head and u. Returns
  (segs, ws, bs, kw, fold, (sbar, cbar, ubar))."""
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  lm = torch.rand(n, 21, generator=gen).to(dev) * 3 - 1.5
  lv = 10.0**(torch.rand(n, 21, generator=gen).to(dev) * 4 - 6)
  segs = list(fused_mlp.encode_ipe(lm, lv, PROP_SCALES))
  skips = fused_mlp.skip_input_layers(8, 4)
  ws = [rand(256, k) * math.sqrt(2 / k) for k in
        (504 if l == 0 else 256 + (504 if l in skips else 0)
         for l in range(8))]
  bs = [rand(256) * 0.05 for _ in range(8)]
  kw = dict(skip_period=4, wd=rand(1, 256) / 16, head_f32=None,
            head_cdt=(rand(hc, 256) / 16, rand(hc) * 0.1))
  fold = fused_mlp._scale_fold(tuple(float(s) for s in PROP_SCALES), 21, dev)
  return segs, ws, bs, kw, fold, (rand(n), rand(n, hc) * 0.1, rand(n, 21))


def defaults_faults(fused_mlp, cdt, cs, ws, bs, kw, fold, cots):
  """What the planted faults of the chunked contract
  (mlp_defaults.FAULTS: the skip layer's input columns left out of u's
  fold, the tangent's skip term dropped, the sin / cos pairing swapped)
  would read on the plain versions (`mlp_defaults.chunked_density_grad`
  with the fault, against the plain u and, first-order plus the model's
  second-order share, against the plain backward with u's cotangent), as
  `errors` reads the kernels: the share of GRAD_BOUND of u and of the
  gradients. Fails unless each reads above its bound."""
  from refnerf_tpu_torch.testing import mlp_defaults
  sbar, cbar, ubar = cots
  reads = {}
  with torch.no_grad():
    u = fused_mlp.trunk_reference(cs, ws, bs, compute_dtype=cdt,
                                  density_grad=True, fold=fold, **kw)[-1]
    full = fused_mlp.trunk_backward_reference(
        cs, ws, bs, (sbar, None, cbar, ubar), compute_dtype=cdt, fold=fold,
        **kw)
    first = fused_mlp.trunk_backward_reference(
        cs, ws, bs, (sbar, None, cbar, None), compute_dtype=cdt, fold=fold,
        **kw)
    want = [u] + full[0] + [full[2]]
    for fault in mlp_defaults.FAULTS:
      bu, (dws, dwd) = mlp_defaults.chunked_density_grad(
          cs, ws, bs, kw['wd'], fold, ubar, compute_dtype=cdt,
          faults=[fault])
      got = [bu] + [a + b for a, b in zip(first[0], dws)] + [first[2] + dwd]
      reads[fault] = max(r[3] for r in errors(got, want, cdt, 0))
      del bu, dws, got
  log(f'phase 25: {cdt}: a fault of the chunked contract would read ' +
      ', '.join(f'{v:.1f} ({k})' for k, v in reads.items()) +
      ' times the bound')
  if not min(reads.values()) > 1:
    raise AssertionError(f'phase 25: the bounds do not see a fault of the '
                         f'chunked contract: {reads}')
  return reads


def in_turns_ms(arms, iters=2):
  """Device ms a call of each of `arms` ({name: fn}), by cuda_ms in turns:
  a, b, ..., b, a. Returns {name: ms}."""
  names = list(arms)
  out = {a: [] for a in names}
  with torch.no_grad():
    for a in names + names[::-1]:
      out[a].append(cuda_ms(arms[a], iters))
  return {a: sum(v) / len(v) for a, v in out.items()}


def patched(module, attr, value, fn):
  """fn with module.attr set to value for the call."""
  def run():
    orig = getattr(module, attr)
    setattr(module, attr, value)
    try:
      return fn()
    finally:
      setattr(module, attr, orig)
  return run


def redesigned_in_turns(fused_mlp, which, cdt, kernel, was_bwd, phase=25,
                        iters=2):
  """Phase 25 (a): the redesigned instances (REDESIGNED) in turns with the
  designs they replaced, in this process (phase 19 (a) likewise the f32
  proposal trunk's, K1 wide and K4 wide on the TF32 libraries' head-0
  instances against `fwd_f32_wide<0, false>` and `bwd_f32_wide<0, false>`):
  f32 K3 and K1 wide hc256 on
  trunk_wide_tf32.cu (the route) and the parent's trunk_fwd_f32.cu instance
  (`fwd_f32_wide<256, true>`, `fwd_f32_wide<256, false>`, the route
  forced); bf16 K3 wide hc256 on trunk_wide_bf16.cu (the route) and the
  parent's trunk_fwd_tma.cu instance (`fwd_wide<256, 1>`, the route
  forced); f32 K4 wide hc256, first
  order and with u's cotangent, on trunk_wide_bwd_tf32.cu (the route) and
  the parent's trunk_bwd_f32.cu instance (`bwd_f32_wide<256, DG>`, the
  route forced); bf16 K4 wide hc256 ubar
  with the tangent read back at the skip layer and the parent's, which
  made it again (trunk_bwd_tma.cu built with REFNERF_TS_REBUILD: `was_bwd`,
  a future of cuda_build.variant), which must agree bit for bit. `iters`:
  calls an arm's block (`in_turns_ms`). Returns {arm: ms}."""
  from refnerf_tpu_torch.ops import cuda_build
  if which.startswith(('K1', 'K3')):
    was = fused_mlp.FWD_LIBRARY[cdt]
    arms = {'ms': kernel,
            'was_ms': patched(fused_mlp, 'forward_library',
                              lambda *a, **k: was, kernel)}
  elif cdt == 'float32':
    arms = {'ms': kernel,
            'was_ms': patched(fused_mlp, 'backward_library',
                              lambda *a, **k: 'trunk_bwd_f32', kernel)}
  else:
    variant, normal = was_bwd.result(), cuda_build.library
    arms = {'ms': kernel,
            'was_ms': patched(cuda_build, 'library', lambda name: variant
                              if name == 'trunk_bwd_tma' else normal(name),
                              kernel)}
    with torch.no_grad():  # the same arithmetic: bit for bit
      a, b = flatten(arms['ms']()), flatten(arms['was_ms']())
      torch.cuda.synchronize()
      if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f'phase 25: {which} {cdt}: the tangent read '
                             'back differs from the one made again')
      del a, b
  ms = in_turns_ms(arms, iters)
  log(f'phase {phase}: {which} {cdt} in turns with the design it replaced '
      f'[{CARD}]: ' + ', '.join(f'{k} {v:.3f}' for k, v in ms.items()))
  return ms


# The defaults' instances redesigned last, each timed in turns with the
# design it replaced.
REDESIGNED = (('K3 wide hc256', 'float32'), ('K4 wide hc256 ubar', 'bfloat16'),
              ('K4 wide hc256 1st', 'float32'),
              ('K4 wide hc256 ubar', 'float32'),
              ('K3 wide hc256', 'bfloat16'), ('K1 wide hc256', 'float32'))
# The redesigned rows but the bf16 backward's are also held to their plain
# versions at these rows, across their 64- and 128-row tiles, each rerun
# bit-identical.
REDESIGNED_ROWS = (1, 63, 64, 65, 128, 129, 257, 4097)


def redesigned_fwd_rows(fused_mlp, which, cdt, pack, xs, ws, bs, kw, fold,
                        phase=25):
  """Phase 25 (a): a forward row of REDESIGNED (f32 K3 and K1 on
  trunk_wide_tf32.cu, bf16 K3 on trunk_wide_bf16.cu; phase 19 (a): the f32
  proposal trunk's K1 on its head-0 instance) against its plain
  version at each of REDESIGNED_ROWS rows, as compare() holds it: sigma and
  the bottleneck by KERNEL_BOUND, u by GRAD_BOUND (relative L2); a second
  run bit-identical."""
  worst = {}
  for n in REDESIGNED_ROWS:
    x = [t[:n] for t in xs]
    with torch.no_grad():
      got = flatten(fused_mlp.trunk_kernel(x, pack, fold))
      again = flatten(fused_mlp.trunk_kernel(x, pack, fold))
      want = flatten(fused_mlp.trunk_reference(
          x, ws, bs, compute_dtype=cdt, density_grad=fold is not None,
          fold=fold, **kw))
    torch.cuda.synchronize()
    worst[n] = max(r[3] for r in errors(got, want, cdt, 2))
    if not worst[n] <= 1.0 or not all(
        torch.equal(a, b) for a, b in zip(got, again)):
      raise AssertionError(f'phase {phase}: {which} {cdt} at {n} rows: '
                           f'{worst[n]:.3f} of its bound, or a rerun differs')
  log(f'phase {phase}: {which} {cdt} at {len(worst)} row counts within its '
      f'bound, reruns bit-identical: ' + ', '.join(
          f'{n} {w:.3f}' for n, w in worst.items()))


def redesigned_rows(fused_mlp, which, pack, xs, ws, bs, kw, cots, fold,
                    phase=25):
  """Phase 25 (a): an f32 K4 row of REDESIGNED (trunk_wide_bwd_tf32.cu;
  phase 19 (a): the f32 proposal trunk's first-order K4 on its head-0
  instance) against its plain version at each of REDESIGNED_ROWS rows,
  every gradient within GRAD_BOUND by relative L2, a second run
  bit-identical."""
  fold = fold if cots[3] is not None else None
  worst = {}
  for n in REDESIGNED_ROWS:
    c = tuple(None if t is None else t[:n] for t in cots)
    x = [t[:n] for t in xs]
    with torch.no_grad():
      got = flatten(fused_mlp.trunk_backward_kernel(x, pack, c, fold))
      again = flatten(fused_mlp.trunk_backward_kernel(x, pack, c, fold))
      want = flatten(fused_mlp.trunk_backward_reference(
          x, ws, bs, c, compute_dtype='float32', fold=fold, **kw))
    torch.cuda.synchronize()
    worst[n] = max(r[3] for r in errors(got, want, 'float32', 0))
    if not worst[n] <= 1.0 or not all(
        torch.equal(a, b) for a, b in zip(got, again)):
      raise AssertionError(f'phase {phase}: {which} float32 at {n} rows: '
                           f'{worst[n]:.3f} of its bound, or a rerun differs')
  log(f'phase {phase}: {which} float32 at {len(worst)} row counts within its '
      f'bound, reruns bit-identical: ' + ', '.join(
          f'{n} {w:.3f}' for n, w in worst.items()))


def check_redesigned(fused_mlp, dev):
  """Phase 25's REDESIGNED rows alone (`check_defaults_kernels` with
  `only`), the bf16 backward's REFNERF_TS_REBUILD build made here: for
  tools/ab_trees.py --checks check_redesigned."""
  from refnerf_tpu_torch.ops import cuda_build
  was_bwd = concurrent.futures.ThreadPoolExecutor(1).submit(
      cuda_build.variant, 'trunk_bwd_tma', 'REFNERF_TS_REBUILD')
  return check_defaults_kernels(fused_mlp, dev, faults=False, was_bwd=was_bwd,
                                only=REDESIGNED)


def check_redesigned_forwards(fused_mlp, dev):
  """Phase 25's REDESIGNED forward rows alone (f32 K3 and K1 on
  trunk_wide_tf32.cu, bf16 K3 on trunk_wide_bf16.cu: `check_defaults_kernels`
  with `only`), each against its plain version at 524,288 rows and at
  REDESIGNED_ROWS and in turns with the design it replaced: for
  tools/ab_trees.py --checks check_redesigned_forwards."""
  return check_defaults_kernels(
      fused_mlp, dev, faults=False,
      only=tuple(r for r in REDESIGNED if r[0].startswith(('K1', 'K3'))))


def check_defaults_kernels(fused_mlp, dev, ns=(N_SAMPLES,), faults=True,
                           was_bwd=None, only=None):
  """Phase 25 (a): the defaults' spatial trunk against its plain versions
  at each of `ns` rows, bf16 and f32, on the wide-input instances (the
  routes asserted): with the 256-wide head K1 (sigma and the head by
  KERNEL_BOUND), K3 (u by GRAD_BOUND), first-order K4 and K4 with u's
  cotangent (every gradient by GRAD_BOUND); with the 128-wide head K1 and
  first-order K4; each run twice more bit-identical, timed at the largest
  n against its bound and, without the density gradient, the PyTorch chain
  (`w1024_chain`); the bf16 128-wide head's pair also on the design it ran
  on before, trunk_fwd.cu and trunk_bwd.cu, the routes forced ('was_ms');
  the planted faults of the chunked contract (`defaults_faults`); the two
  instances of REDESIGNED in turns with the parent's (`redesigned_in_turns`;
  was_bwd: the future of the bf16 backward's REFNERF_TS_REBUILD build), the
  f32 K4 rows also at REDESIGNED_ROWS (`redesigned_rows`). f32 K3 with the
  256-wide head runs on trunk_wide_tf32.cu and its f32 K4 on
  trunk_wide_bwd_tf32.cu, their bounds three TF32 products' (the FMA
  pipes' beside them). `only`: the (name, cdt) rows to run,
  all by default. Returns ({(name, cdt): compare()'s dict at max(ns)}, {cdt:
  fault reads})."""
  gen = torch.Generator().manual_seed(SEED + 25)
  results, fault_reads = {}, {}
  n_max = max(ns)
  for hc in (256,) if only else (256, 128):
    segs, ws, bs, kw, fold, cots = defaults_case(fused_mlp, gen, dev, n_max,
                                                 hc)
    sbar, cbar, ubar = cots
    flops = lambda n, **k: trunk_flops(ws, n, 1 + hc, **k)
    for cdt in ('bfloat16', 'float32'):
      dt = fused_mlp.DTYPES[cdt]
      cs = [s.to(dt) for s in segs]
      pack = fused_mlp.pack_trunk(ws, bs, (252, 252), compute_dtype=cdt, **kw)
      tf32 = cdt == 'float32' and hc == 256
      for f in (None, fold):
        want = (fused_mlp.WIDE_TF32_LIBRARY if tf32 else
                fused_mlp.WIDE_BF16_LIBRARY if hc == 256 and f is not None
                else fused_mlp.FWD_LIBRARY[cdt],
                fused_mlp.WIDE_TF32_BWD_LIBRARY if tf32 else
                fused_mlp.BWD_LIBRARY[cdt])
        got = (fused_mlp.forward_library(pack, fold=f),
               fused_mlp.backward_library(pack, fold=f))
        if (got != want or not fused_mlp.wide_input(pack, fold=f) or
            fused_mlp.missing_instance(pack, hc, f) is not None):
          raise AssertionError(f'phase 25: the {cdt} defaults trunk (head '
                               f'{hc}) routed to {got}')
      tag = f'wide hc{hc}'
      for n in ns:
        xs = [c[:n] for c in cs]
        c1 = (sbar[:n], None, cbar[:n].to(dt), None)
        c2 = c1[:3] + (ubar[:n],)
        ins = xs + pack_tensors(pack)
        rows = [
            (f'K1 {tag}', 2, lambda: fused_mlp.trunk_kernel(xs, pack),
             lambda: fused_mlp.trunk_reference(xs, ws, bs, compute_dtype=cdt,
                                               **kw),
             ins, flops(n), lambda: w1024_chain(fused_mlp, xs, ws, bs, kw,
                                                cdt)),
            (f'K4 {tag} 1st', 0,
             lambda: fused_mlp.trunk_backward_kernel(xs, pack, c1),
             lambda: fused_mlp.trunk_backward_reference(
                 xs, ws, bs, c1, compute_dtype=cdt, **kw),
             ins + [c1[0], c1[2]], flops(n, backward=True),
             lambda: w1024_chain(fused_mlp, xs, ws, bs, kw, cdt,
                                 (c1[0], None, c1[2])))]
        if hc == 256:
          rows[1:1] = [
              (f'K3 {tag}', 2, lambda: fused_mlp.trunk_kernel(xs, pack, fold),
               lambda: fused_mlp.trunk_reference(
                   xs, ws, bs, compute_dtype=cdt, density_grad=True,
                   fold=fold, **kw),
               ins + [fold], flops(n, density_grad=True), None)]
          rows.append(
              (f'K4 {tag} ubar', 0,
               lambda: fused_mlp.trunk_backward_kernel(xs, pack, c2, fold),
               lambda: fused_mlp.trunk_backward_reference(
                   xs, ws, bs, c2, compute_dtype=cdt, fold=fold, **kw),
               ins + [c2[0], c2[2], c2[3], fold],
               flops(n, backward=True, density_grad=True), None))
        for which, nv, kernel, plain, inputs, fl, lib in rows:
          if only is not None and (which, cdt) not in only:
            continue
          r = compare(which, cdt, kernel, plain, n_values=nv, iters=2,
                      phase=25, inputs=inputs, flops=fl, n=n,
                      library=lib() if lib is not None and n == n_max
                      else None,
                      tf32_passes=3 if tf32 and which.startswith(
                          ('K1', 'K3', 'K4')) else 0)
          deterministic(which, kernel, phase=25, cdt=cdt)
          if (which, cdt) in REDESIGNED and which.startswith(('K1', 'K3')) and (
              n == n_max):
            redesigned_fwd_rows(fused_mlp, which, cdt, pack, xs, ws, bs, kw,
                                fold if which.startswith('K3') else None)
          if (which, cdt) in REDESIGNED and which.startswith('K4') and (
              cdt == 'float32') and n == n_max:
            redesigned_rows(fused_mlp, which, pack, xs, ws, bs, kw,
                            c2 if which.endswith('ubar') else c1, fold)
          if n == n_max:
            results[which, cdt] = r
            if (which, cdt) in REDESIGNED:
              r['in_turns'] = redesigned_in_turns(fused_mlp, which, cdt,
                                                  kernel, was_bwd)
            if hc == 128 and cdt == 'bfloat16':
              # The design the bf16 128-wide head ran on before (trunk_fwd.cu,
              # trunk_bwd.cu: kin past the TMA instances), the routes forced.
              fwd, bwd = fused_mlp.forward_library, fused_mlp.backward_library
              fused_mlp.forward_library = lambda *a, **k: 'trunk_fwd'
              fused_mlp.backward_library = lambda *a, **k: 'trunk_bwd'
              try:
                r['was_ms'] = compare(
                    f'{which} on trunk_{"fwd" if nv else "bwd"}.cu (was)',
                    cdt, kernel, plain, n_values=nv, iters=2, phase=25,
                    inputs=inputs, flops=fl, n=n)['ms']
              finally:
                fused_mlp.forward_library, fused_mlp.backward_library = (
                    fwd, bwd)
        del xs, rows
      if faults and hc == 256:
        m = min(DEFAULTS_FAULT_ROWS, n_max)
        fault_reads[cdt] = defaults_faults(
            fused_mlp, cdt, [c[:m] for c in cs], ws, bs, kw, fold,
            (sbar[:m], cbar[:m].to(dt), ubar[:m]))
      del pack, cs
      torch.cuda.empty_cache()
    del segs, ws, bs, kw, cots
    torch.cuda.empty_cache()
  return results, fault_reads


def defaults_setup(dev, dtype, bindings=(), mode='on'):
  """The defaults (+ `bindings`) at full width, trunks in `dtype` (both
  MLPs), weights from Config.seed, under fused_trunk `mode`; a batch of
  Config.batch_size random rays and pixels, a fresh train state and the
  step."""
  from refnerf_tpu_torch import configs
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.models import construct
  from refnerf_tpu_torch.testing.mlp_defaults import DEFAULTS
  from refnerf_tpu_torch.train import step as step_lib
  config, gin = configs.parse([], [
      *DEFAULTS, *bindings, f'Config.seed = {SEED}',
      f"NerfMLP.compute_dtype = '{dtype}'",
      f"PropMLP.compute_dtype = '{dtype}'",
      f"NerfMLP.fused_trunk = '{mode}'", f"PropMLP.fused_trunk = '{mode}'"])
  model = construct.construct_model(config, gin, dev)
  n = config.batch_size
  rng = np.random.RandomState(25)
  rays = rays_from(rays_lib, rng.randn(n, 3).astype(np.float32) * 0.1,
                   rng.randn(n, 3).astype(np.float32),
                   np.full((n, 1), 0.001, np.float32), config, dev)
  rays.lossmult = torch.ones(n, 1, device=dev)
  rgb = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32)).to(dev)
  return dict(model=model, config=config, cameras=None,
              batch=rays_lib.Batch(rays=rays, rgb=rgb),
              state=step_lib.create_train_state(config, model),
              train_step=step_lib.make_train_step(model, config))


def defaults_train(fused_mlp, run, what, steps, per_step, terms):
  """Phase 25 (b): one warm step, then `steps` steps timed one by one, each
  kernel launched steps x its `per_step` count (launch_keys' counts), the
  loss terms `terms`, finite; the peak memory allocated over the timed
  steps. Returns (launches, median ms, peak GiB, libraries, last stats)."""
  step_fn, batch = run['train_step'], run['batch']
  seen, restore = _routes(fused_mlp)
  try:
    run['state'], _ = step_fn(run['state'], batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in fused_mlp.launches:
      fused_mlp.launches[k] = 0
    times, all_stats = [], []
    for _ in range(steps):
      t0 = time.perf_counter()
      run['state'], stats = step_fn(run['state'], batch)
      torch.cuda.synchronize()
      times.append(time.perf_counter() - t0)
      all_stats.append(stats)
    launches = dict(fused_mlp.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
  finally:
    restore()
  want = {k: steps * per_step.get(k, 0) for k in launches}
  if launches != want:
    raise AssertionError(f'phase 25: {what} launches {launches}, expected '
                         f'{want}')
  for stats in all_stats:
    got = stats['losses']
    if not (set(got) == set(terms) and
            all(torch.isfinite(v).all() for v in got.values())):
      raise AssertionError(f'phase 25: {what}: loss terms {got}')
  ms = float(np.median(times)) * 1e3
  last = all_stats[-1]
  bsz = run['config'].batch_size
  log(f'phase 25: {what}: {steps} steps after 1 warm-up at batch {bsz}: '
      f'median {ms:.2f} ms a step (' + ', '.join(f'{t * 1e3:.2f}'
                                                 for t in times) +
      f'), {bsz / ms * 1e3:.0f} train rays/s, peak {peak:.2f} GiB '
      f'allocated; loss {last["loss"].item():.6g} (' + ', '.join(
          f'{k} {v.item():.6g}' for k, v in last['losses'].items()) +
      f'); launches {launches}; libraries '
      f'{json.dumps({k: sorted(v) for k, v in seen.items()})}')
  return launches, ms, peak, seen, last


def defaults_against_plain(fused_mlp, run, what):
  """Phase 25 (b): one step against fused_trunk='off' (`cascade_against_
  plain`: the loss within TRAIN_LOSS_BOUND, the gradient norm within
  TRAIN_GNORM_BOUND) on the first rays of the batch, at the largest of
  DEFAULTS_BATCH, its half, ... that the plain path's double backward holds
  in memory. Returns the summary with the batch it ran at."""
  from refnerf_tpu_torch.cameras import rays as rays_lib
  batch = run['batch']
  n = batch.rgb.shape[0]
  floor = min(n, 256)
  while n >= floor:
    sub = rays_lib.Batch(
        rays=type(batch.rays)(**{k: None if v is None else v[:n] for k, v in
                                 vars(batch.rays).items()}),
        rgb=batch.rgb[:n])
    try:
      out = cascade_against_plain(fused_mlp, run, sub, f'{what} at batch {n}',
                                  phase=25)
      return dict(out, batch=n)
    except torch.cuda.OutOfMemoryError:
      pass
    del sub
    torch.cuda.empty_cache()
    log(f"phase 25: {what}: fused_trunk='off' does not fit at batch {n}")
    n //= 2
  raise AssertionError(f"phase 25: {what}: fused_trunk='off' fits no batch")


def defaults_request(fused_mlp, dev, run, what, per_request):
  """Phase 25 (c): a 4096-ray request (eval, one chunk) through the kernels,
  timed after a warm one, its launches counted (`per_request`), against
  fused_trunk='off' (timed too): rgb and acc by spread_l2 within
  DEFAULTS_SERVE_BOUND; a planted fault of the served model (every spatial
  pack without the skip layer's input columns, `drop_skip_columns`) must
  read above it; one request profiled. Returns a summary."""
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.models import mlp as mlp_lib
  from refnerf_tpu_torch.models import renderer
  model, config = run['model'], run['config']
  cdt = model.nerf_mlp.cfg.compute_dtype
  rays = random_rays(rays_lib, DEFAULTS_REQUEST, config, 25, dev)
  chunk = DEFAULTS_REQUEST

  def timed():
    renderer.render_rays(model, rays, chunk)  # warm-up (packs the weights)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = renderer.render_rays(model, rays, chunk)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3
  for k in fused_mlp.launches:
    fused_mlp.launches[k] = 0
  out, ms = timed()
  launches = {k: v // 2 for k, v in fused_mlp.launches.items() if v}
  if launches != per_request:
    raise AssertionError(f'phase 25: {what} request launches {launches}')
  ranges = check_rendering(out, (DEFAULTS_REQUEST,), config,
                           model.nerf_mlp.cfg.rgb_padding)
  set_mode(model, fused_trunk='off')
  try:
    before = dict(fused_mlp.launches)
    plain, plain_ms = timed()
    if fused_mlp.launches != before:
      raise AssertionError("phase 25: fused_trunk='off' launched a kernel")
  finally:
    set_mode(model, fused_trunk='on')
  host = lambda t: t.detach().double().reshape(t.shape[0], -1).cpu().numpy()
  spread = lambda got: {k: spread_l2(host(got[k]), host(plain[k]))
                        for k in ('rgb', 'acc')}
  reads = spread(out)
  with planted_pack(drop_skip_columns) as planted, mlp_lib.frozen_packs(
      model):
    fault = spread(renderer.render_rays(model, rays, chunk))
  if not planted:
    raise AssertionError(f'phase 25: {what}: the skip fault went into no '
                         'pack')
  bound = DEFAULTS_SERVE_BOUND[cdt]
  log(f'phase 25: {what}: a {DEFAULTS_REQUEST}-ray request {ms:.1f} ms '
      f'under "on", {plain_ms:.1f} ms under "off"; {ranges}; launches '
      f"{launches}; vs fused_trunk='off' by spread_l2: " + ', '.join(
          f'{k} {v:.3e} ({v / bound:.3f} of the bound)'
          for k, v in reads.items()) + f' (bound {bound}); the skip input '
      'dropped from the served packs would read ' + ', '.join(
          f'{k} {v:.3e} ({v / bound:.1f} times the bound)'
          for k, v in fault.items()))
  if not max(reads.values()) <= bound:
    raise AssertionError(f'phase 25: {what}: the request disagrees with '
                         'the plain path')
  if not max(fault.values()) > bound:
    raise AssertionError(f'phase 25: {what}: the bound does not see the '
                         f'skip input dropped from the served packs: {fault}')
  prof = profile(lambda: renderer.render_rays(model, rays, chunk),
                 f'{what} request', 1, phase=25)
  busy = None if prof is None else {
      'wall_ms': prof['wall_ms'], 'busy_ms': prof['busy_ms'],
      'top': dict(sorted(prof['kernels'].items(), key=lambda kv: -kv[1])[:6])}
  return dict(ms=ms, off_ms=plain_ms, launches=launches, spread_l2=reads,
              fault_spread_l2=fault, profile=busy)


def variant_run(fused_mlp, dev, dtype, name):
  """Phase 25 (b): DEFAULTS_VARIANTS[name] under 'on': one step counted
  (VARIANT_PER_STEP, the routes asserted; DEFAULTS_FIRST's also against
  'off', `defaults_against_plain`) and one 4096-ray request counted
  (DEFAULTS_PER_REQUEST). Returns ({'step': launches, 'request':
  launches, 'vs_plain': the comparison or None}, step ms)."""
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.models import renderer
  run = defaults_setup(dev, dtype, DEFAULTS_VARIANTS[name])
  what = f'{name} {dtype}'
  step, ms, _, seen, _ = defaults_train(fused_mlp, run, what, 1,
                                        VARIANT_PER_STEP, DEFAULTS_TERMS)
  # The spatial trunks on the wide-input pair (the f32 backward with the
  # 256-wide head on trunk_wide_bwd_tf32.cu); the directional trunk on
  # trunk_dir1.cu, or at a 128-wide bottleneck (155 columns) on the same
  # pair's width-128 instances.
  tf32 = dtype == 'float32' and name == 'DEFAULTS_FIRST'
  bwd = (fused_mlp.WIDE_TF32_BWD_LIBRARY if tf32
         else fused_mlp.BWD_LIBRARY[dtype])
  fwd = fused_mlp.WIDE_TF32_LIBRARY if tf32 else fused_mlp.FWD_LIBRARY[dtype]
  for way, lib in (('forward', fwd), ('backward', bwd)):
    if lib not in seen[way] or seen[way] - {lib, fused_mlp.DIR1_LIBRARY}:
      raise AssertionError(f'phase 25: {what} routed to {seen}')
  # Without density normals the 256-wide head's first-order backward: one
  # step against 'off' too.
  vs_plain = (defaults_against_plain(fused_mlp, run, what)
              if name == 'DEFAULTS_FIRST' else None)
  rays = random_rays(rays_lib, DEFAULTS_REQUEST, run['config'], 25, dev)
  for k in fused_mlp.launches:
    fused_mlp.launches[k] = 0
  with torch.no_grad():
    out = renderer.render_rays(run['model'], rays, DEFAULTS_REQUEST)
  request = {k: v for k, v in fused_mlp.launches.items() if v}
  check_rendering(out, (DEFAULTS_REQUEST,), run['config'],
                  run['model'].nerf_mlp.cfg.rgb_padding)
  if request != DEFAULTS_PER_REQUEST:
    raise AssertionError(f'phase 25: {what} request launches {request}')
  return dict(step=step, request=request, vs_plain=vs_plain), ms


def defaults_stage(fused_mlp, dev, steps=DEFAULTS_STEPS):
  """Phase 25 (b)-(c): the defaults at full width in bf16 and in f32 under
  'on' (raising on any trunk without an instance): `steps` steps at batch
  16,384 (`defaults_train`, the routes asserted: the spatial trunks on the
  wide-input pair, f32 K3 on trunk_wide_tf32.cu, bf16 K3 on
  trunk_wide_bf16.cu, the directional ones on trunk_dir1.cu), one step
  against 'off' (`defaults_against_plain`), a step profiled, a 4096-ray
  request (`defaults_request`); DEFAULTS_NORMALS
  likewise trained (the orientation term in the loss) and against 'off';
  DEFAULTS_VARIANTS (`variant_run`). Returns ({dtype:
  launches}, {dtype: {variant: launches}}, summary)."""
  from refnerf_tpu_torch.testing.mlp_defaults import DEFAULTS_NORMALS
  out, paths, variants = {}, {}, {}
  for dtype in ('bfloat16', 'float32'):
    # Training runs K3 and K4: on trunk_wide_tf32.cu and
    # trunk_wide_bwd_tf32.cu in f32, K3 on trunk_wide_bf16.cu in bf16.
    wide = {fused_mlp.WIDE_TF32_LIBRARY if dtype == 'float32' else
            fused_mlp.WIDE_BF16_LIBRARY, fused_mlp.DIR1_LIBRARY}
    bwide = {fused_mlp.WIDE_TF32_BWD_LIBRARY if dtype == 'float32' else
             fused_mlp.BWD_LIBRARY[dtype], fused_mlp.DIR1_LIBRARY}
    res = {}
    for name, bindings, terms in (
        ('DEFAULTS', (), DEFAULTS_TERMS),
        ('DEFAULTS_NORMALS', DEFAULTS_NORMALS,
         DEFAULTS_TERMS + ('orientation',))):
      run = defaults_setup(dev, dtype, bindings)
      mlp = run['model'].nerf_mlp
      if (mlp.cfg.net_width != 256 or mlp.spatial_0.in_features != 504 or
          mlp.bottleneck.out_features != 256 or
          mlp.cfg.disable_density_normals or
          run['config'].batch_size != DEFAULTS_BATCH):
        raise AssertionError('phase 25: the configuration is not the '
                             'defaults')
      what = f'{name} {dtype}'
      launches, ms, peak, seen, last = defaults_train(
          fused_mlp, run, what, steps, DEFAULTS_PER_STEP, terms)
      if seen != {'forward': wide, 'backward': bwide}:
        raise AssertionError(f'phase 25: {what} routed to {seen}')
      r = dict(step_ms=ms, rays_s=DEFAULTS_BATCH / ms * 1e3, peak_gib=peak,
               loss=last['loss'].item(), launches=launches)
      r['vs_plain'] = defaults_against_plain(fused_mlp, run, what)
      if name == 'DEFAULTS':
        paths[dtype] = launches
        box = {'state': run['state']}

        def step():
          box['state'], _ = run['train_step'](box['state'], run['batch'])
        prof = profile(step, f'{what} train step', 1, phase=25)
        if prof is not None:
          r['profile'] = {k: prof[k] for k in ('wall_ms', 'busy_ms')}
          r['profile']['top'] = dict(sorted(
              prof['kernels'].items(), key=lambda kv: -kv[1])[:6])
        r['request'] = defaults_request(fused_mlp, dev, run, what,
                                        DEFAULTS_PER_REQUEST)
        del box
      res[name] = r
      del run, mlp
      torch.cuda.empty_cache()
    variants[dtype] = {}
    for name in DEFAULTS_VARIANTS:
      variants[dtype][name], res[name + '_step_ms'] = variant_run(
          fused_mlp, dev, dtype, name)
      torch.cuda.empty_cache()
    out[dtype] = res
    log(f'phase 25: the defaults in {dtype} [{CARD}]: {json.dumps(res)}')
  return paths, variants, out


def main():
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device (torch.cuda.is_available() is false)',
          file=sys.stderr)
    return 2
  dev = torch.device('cuda')
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True,
      timeout=60).stdout.strip().splitlines()[0]
  global CARD
  CARD = smi
  log(f'phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, '
      f'{torch.cuda.get_device_name(0)}')
  log(smi)

  from refnerf_tpu_torch.ops import cuda_build
  from refnerf_tpu_torch.ops import fused_mlp
  secs = {}  # each phase's seconds, printed before the last two lines

  def phase(number, fn, *args):
    t = time.perf_counter()
    out = fn(*args)
    secs[number] = secs.get(number, 0.0) + time.perf_counter() - t
    return out

  t0 = time.perf_counter()
  # The bf16 backward as the parent built it (the skip layer's tangent made
  # again: REFNERF_TS_REBUILD), for phase 25's turns; nvcc beside the rest.
  was_bwd = concurrent.futures.ThreadPoolExecutor(1).submit(
      cuda_build.variant, 'trunk_bwd_tma', 'REFNERF_TS_REBUILD')
  libs = cuda_build.build()
  for name in libs:
    cuda_build.library(name)
  log(f'phase 2: built {", ".join(p.name for p in libs.values())} in '
      f'{time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)')
  for path in libs.values():
    for line in path.with_suffix('.log').read_text().splitlines():
      if ('Used' in line or 'spill' in line or 'Compiling' in line) and (
          'C75' not in line):
        log(f'phase 2: ptxas {line.strip()}')
  sass = sass_of([libs[name] for name in (
      'trunk_fwd_tma', 'trunk_bwd_tma', 'trunk_fwd_f32', 'trunk_bwd_f32',
      fused_mlp.W1024_LIBRARY, fused_mlp.DIR1_LIBRARY,
      fused_mlp.WIDE_TF32_LIBRARY, fused_mlp.WIDE_TF32_BWD_LIBRARY,
      fused_mlp.WIDE_BF16_LIBRARY)])
  check_sass(sass[libs['trunk_fwd_tma']])
  check_sass(sass[libs['trunk_bwd_tma']])
  # The f32 forward's TF32 products on wgmma, fed by TMA (K3, K1 and the
  # proposal trunk's K1 at the density head alone).
  check_wgmma_sass(sass[libs[fused_mlp.WIDE_TF32_LIBRARY]],
                   r'trunk_fwd_tf32_kernel', 3, 'trunk_wide_tf32')
  # The bf16 density gradient's products and its fold likewise.
  check_wgmma_sass(sass[libs[fused_mlp.WIDE_BF16_LIBRARY]],
                   r'trunk_fwd_bf16_kernel', 1, 'trunk_wide_bf16')
  # The f32 backward's (first order, with u's cotangent, and the proposal
  # trunk's first order at the density head alone) likewise.
  check_wgmma_sass(sass[libs[fused_mlp.WIDE_TF32_BWD_LIBRARY]],
                   r'trunk_bwd_tf32_kernel', 3, 'trunk_wide_bwd_tf32')
  for name in ('trunk_fwd_f32', 'trunk_bwd_f32'):
    check_sass(sass[libs[name]], need=('FFMA', 'UTMALDG'),
               refuse=('HMMA', 'HGMMA'))
  check_w1024_sass(sass[libs[fused_mlp.W1024_LIBRARY]])
  check_wgmma_sass(sass[libs[fused_mlp.DIR1_LIBRARY]],
                   r'dir1_(bf16|f32)_kernel', 4, 'trunk_dir1')
  secs[2] = time.perf_counter() - t0

  kernels = phase(3, check_kernels, fused_mlp, dev)
  launches, _ = phase(4, serve, fused_mlp, dev)
  kernels.update(phase(5, check_train_kernels, fused_mlp, dev))
  train_launches, step_s, _ = phase(6, train, fused_mlp, dev)
  kernels.update(phase(7, check_dir_kernels, fused_mlp, dev))
  dir_serve, dir_train, dir_step_s, ab = phase(8, fused_stage, fused_mlp, dev)
  kernels.update(phase(9, check_spa_kernels, fused_mlp, dev))
  spa_serve, spa_train, spa_step_s, ab6 = phase(10, spatial_stage, fused_mlp,
                                                dev)
  kernels.update(phase(11, check_mip_kernels, fused_mlp, dev))
  mip = phase(12, mip_stage, fused_mlp, dev)
  (mip_serve, mip_train, _, _), (y_serve, y_train, _, _) = (
      mip['shipped'], mip['no viewdirs'])
  f32_train, f32_step_s = phase(13, f32_stage, fused_mlp, dev)
  f32_serve, f32_request = phase(14, f32_serve_stage, fused_mlp, dev)
  (mip_f32_train, mip_f32_step_s, mip_f32_prof, mip_f32_serve,
   mip_f32_request) = phase(15, mip_f32_stage, fused_mlp, dev)
  data_path, data = phase(16, data_stage, fused_mlp, dev)
  cli_path, cli = phase(17, cli_stage, fused_mlp, dev)
  geo_path, geo_bf16_path, geo = phase(18, geometry_stage, fused_mlp, dev)
  kernels.update(phase(19, check_prop_kernels, fused_mlp, dev))
  cascade_path, cascade_bf16_path, cascade = phase(19, cascade_stage,
                                                   fused_mlp, dev)
  mesh_path, mesh = phase(20, mesh_stage, fused_mlp, dev)
  art_path, art = phase(21, serving_stage, fused_mlp, dev)
  dp_steps, dp = phase(22, data_parallel_stage, fused_mlp, dev)
  dp_path = {k: sum(step[k] for step in dp_steps) for k in dp_steps[0]}
  remat_path, remat = phase(23, remat_stage, fused_mlp, dev)
  w1024, w1024_faults_read = phase(24, check_w1024_kernels, fused_mlp, dev)
  kernels.update(w1024)
  m360_path, m360 = phase(24, m360_stage, fused_mlp, dev)
  defaults_k, defaults_faults_read = phase(25, check_defaults_kernels,
                                           fused_mlp, dev, (N_SAMPLES,), True,
                                           was_bwd)
  kernels.update(defaults_k)
  defaults_path, variant_path, defaults = phase(25, defaults_stage, fused_mlp,
                                                dev)

  fwd_src = 'refnerf_tpu_torch/csrc/trunk_fwd.cu'
  bwd_src = 'refnerf_tpu_torch/csrc/trunk_bwd.cu'
  # bf16 at width 256: the wgmma/TMA forward and backward.
  ftma_src = 'refnerf_tpu_torch/csrc/trunk_fwd_tma.cu'
  tma_src = 'refnerf_tpu_torch/csrc/trunk_bwd_tma.cu'
  # f32 at width 256: the FMA/TMA forward and backward.
  f32fwd_src = 'refnerf_tpu_torch/csrc/trunk_fwd_f32.cu'
  f32_src = 'refnerf_tpu_torch/csrc/trunk_bwd_f32.cu'
  # f32 K3 and K1 of the defaults' trunk: three TF32 passes of wgmma.
  tf32_src = 'refnerf_tpu_torch/csrc/trunk_wide_tf32.cu'
  # bf16 K3 of the defaults' trunk: one bf16 pass of wgmma, 128-row tiles.
  wbf16_src = 'refnerf_tpu_torch/csrc/trunk_wide_bf16.cu'
  # f32 K4 of the defaults' trunk: three TF32 passes of wgmma.
  tf32_bwd_src = 'refnerf_tpu_torch/csrc/trunk_wide_bwd_tf32.cu'
  pallas = 'refnerf_tpu/ops/pallas/fused_mlp.py'
  # name: (description, source, line of the TPU kernel, launches on the
  # main path: phase 4's requests, phase 6's steps, or both of phase 8 or
  # of phase 10), each with its phase-3/5/7/9 case. K6-K10's source is
  # their forward's (the backward's is `bwd_source`).
  names = {
      'K1': ('spatial trunk (fused_encoded_trunk)', ftma_src, 612,
             launches['K1']),
      'K2': ('directional trunk (fused_trunk)', ftma_src, 612,
             launches['K2']),
      'K3': ('spatial trunk with the density gradient', ftma_src, 589,
             train_launches['K3']),
      'K4': ('spatial trunk backward', tma_src, 668, train_launches['K4']),
      'K5': ('directional trunk backward with dx', tma_src, 668,
             train_launches['K5']),
      'K6': ('in-kernel compositing weights (K3 fwd; K1, K4)', ftma_src,
             498, spa_serve['K6'] + spa_train['K6']),
      'K7': ('in-kernel IPE (K1 fwd; K3, K4)', ftma_src, 550,
             spa_serve['K7'] + spa_train['K7']),
      'K8': ('in-kernel IDE in the directional trunk, fwd and bwd', ftma_src,
             402, dir_serve['K8'] + dir_train['K8']),
      'K9': ('in-kernel direction geometry (with K8), fwd and bwd', ftma_src,
             355, dir_serve['K9'] + dir_train['K9']),
      'K10': ('in-kernel colour epilogue, fwd and bwd', ftma_src, 283,
              dir_serve['K10'] + dir_train['K10']),
      # Phase 12's: mip-NeRF as shipped, and without view directions (K11).
      'K11': ('trunk features y out (K1), their cotangent in (K4)', ftma_src,
              629, y_serve['K11'] + y_train['K11']),
      'K2 W128': ('directional trunk at width 128 (mip-NeRF)', ftma_src, 612,
                  mip_serve['K2'] + mip_train['K2']),
      'K5 W128': ('directional trunk backward at width 128, dx', tma_src,
                  668, mip_train['K5']),
      'K1 hf=0': ('spatial trunk with the bottleneck head alone', ftma_src,
                  612, mip_serve['K1'] + mip_train['K1']),
      'K4 first-order': ('spatial trunk backward without the cotangent of '
                         'u', tma_src, 668, mip_train['K4']),
      # Phase 13's: the shipped gin's own float32 step, all six flags.
      'K4 f32': ('spatial trunk backward with K6/K7 in float32', f32_src,
                 668, f32_train['K4']),
      'K5 f32': ('directional trunk backward with K8-K10 in float32',
                 f32_src, 668, f32_train['K5']),
      # Phase 15's: mip-NeRF's own float32 step.
      'K5 W128 f32': ('directional trunk backward at width 128, dx, in '
                      'float32', f32_src, 668, mip_f32_train['K5'])}
  line = []
  # K6 and K7 stand for their phase-9 cases; each entry also lists the
  # others it runs in.
  main_case = {'K6': 'K6+K3', 'K7': 'K7', 'K4 f32': 'K6+K7+K4',
               'K5 f32': 'K8+K9+K10 backward', 'K5 W128 f32': 'K5 W128'}
  # The mip-NeRF kernels' launches in phase 15's float32 step.
  mip_f32 = {'K1 hf=0': 'K1', 'K2 W128': 'K2', 'K4 first-order': 'K4',
             'K5 W128': 'K5'}
  mip6 = ('mip K6+K7', 'mip K6+K7+K4 first-order')
  more_cases = {'K6': ('K6+K7', 'K6+K7+K3', 'K6+K7+K4') + mip6,
                'K7': ('K7+K3', 'K6+K7', 'K6+K7+K3', 'K6+K7+K4') + mip6}
  for which, (desc, src, at, count) in names.items():
    case = main_case.get(which, which)
    b16, f32 = kernels[case, 'bfloat16'], kernels[case, 'float32']
    if src == f32_src:
      line.append({
          'name': f'{which} {desc}', 'route': 'cuda', 'source': src,
          'replaces': f'{pallas}:{at}', 'launches': count,
          'max_abs_err': f32['max_abs_err'], 'ms': f32['ms'],
          'plain_ms': f32['plain_ms'], 'bound_ms': f32['bound_ms'],
          'bound_by': f32['bound_by'], 'library_ms': None,
          'dtype': 'float32', 'n_samples': N_SAMPLES, 'case': case})
      continue
    entry = {
        'name': f'{which} {desc}', 'route': 'cuda', 'source': src,
        'replaces': f'{pallas}:{at}', 'launches': count,
        'max_abs_err': b16['max_abs_err'], 'ms': b16['ms'],
        'plain_ms': b16['plain_ms'], 'bound_ms': b16['bound_ms'],
        'bound_by': b16['bound_by'], 'library_ms': None,
        'dtype': 'bfloat16', 'n_samples': N_SAMPLES,
        'f32_max_abs_err': f32['max_abs_err'], 'f32_ms': f32['ms'],
        'f32_plain_ms': f32['plain_ms'], 'f32_bound_ms': f32['bound_ms']}
    if src == tma_src:
      entry['f32_source'] = f32_src
    if src == ftma_src:
      # f32 K11 stays on trunk_fwd.cu.
      entry['f32_source'] = fwd_src if which == 'K11' else f32fwd_src
    if which in ('K6', 'K7', 'K8', 'K9', 'K10'):
      entry['bwd_source'] = tma_src
    if which in ('K6', 'K7', 'K8', 'K9', 'K10', 'K11'):
      entry['f32_bwd_source'] = f32_src
    if f32_train.get(which):
      entry['f32_train_launches'] = f32_train[which]
    if which in mip_f32:
      entry['f32_train_launches'] = mip_f32_train[mip_f32[which]]
      if mip_f32_serve.get(mip_f32[which]):
        entry['f32_serve_launches'] = mip_f32_serve[mip_f32[which]]
    if f32_serve.get(which):
      entry['f32_serve_launches'] = f32_serve[which]
    if which in ('K8', 'K9', 'K10', 'K11'):
      entry['serve_launches'] = (y_serve if which == 'K11'
                                 else dir_serve)[which]
      entry['train_launches'] = (y_train if which == 'K11'
                                 else dir_train)[which]
      for cdt, pre in (('bfloat16', 'bwd_'), ('float32', 'f32_bwd_')):
        bw = kernels[which + ' backward', cdt]
        entry.update({pre + 'ms': bw['ms'], pre + 'plain_ms': bw['plain_ms'],
                      pre + 'bound_ms': bw['bound_ms'],
                      pre + 'max_abs_err': bw['max_abs_err']})
    if which == 'K2':
      entry['train_launches'] = train_launches['K2']
    if data_path.get(which):
      # Phase 16: trained (K2-K10) and evaluated (K1) from a scene on disk.
      entry['data_path_launches'] = data_path[which]
    if cli_path.get(which):
      # Phase 17: the train CLI on the shipped gin (f32): K2-K5 in the
      # steps, K1 and K2 in the validation views, on the FMA/TMA libraries.
      entry['cli_launches'] = cli_path[which]
      entry['cli_source'] = f32fwd_src if which in ('K1', 'K2', 'K3') \
          else f32_src
    if geo_path.get(which):
      # Phase 18 (b): the geometry gin as shipped (f32): K2-K5 in the main
      # and the noisy forward, on the FMA/TMA libraries.
      entry['geometry_launches'] = geo_path[which]
      entry['geometry_source'] = f32fwd_src if which in ('K2', 'K3') \
          else f32_src
    if geo_bf16_path.get(which):
      # Phase 18 (c): the same in bf16 with the six fuse flags (K2-K9).
      entry['geometry_bf16_launches'] = geo_bf16_path[which]
    if which == 'K1':
      # Phase 20: the density grid and the vertex colours (bf16, f32).
      entry['mesh_launches'] = mesh_path['bfloat16']
      entry['mesh_f32_launches'] = mesh_path['float32']
    if which in art_path['flagship']:
      # Phase 21: a request of the loaded bf16 six-flag artifact.
      entry['artifact_launches'] = art_path['flagship'][which]
    if which in ('K1 hf=0', 'K2 W128'):
      # Phase 21: a request of the loaded mip-NeRF artifact (float32).
      entry['artifact_f32_launches'] = art_path['mipnerf'][which.split()[0]]
    if dp_path.get(which):
      # Phase 22: one rank's launches in the flagship's DP_STEPS steps on
      # two ranks (the other rank's are the same).
      entry['dp_rank_launches'] = dp_path[which]
    if remat_path.get(which):
      # Phase 23: the flagship's REMAT_STEPS steps under Model.remat.
      entry['remat_launches'] = remat_path[which]
    if which in main_case:
      entry['case'] = case
      entry['serve_launches'] = spa_serve[which]
      entry['train_launches'] = spa_train[which]
      keys = ('ms', 'plain_ms', 'bound_ms', 'max_abs_err')
      entry['more'] = {c: {**{k: kernels[c, 'bfloat16'][k] for k in keys},
                           **{'f32_' + k: kernels[c, 'float32'][k]
                              for k in keys}}
                       for c in more_cases[which]}
    line.append(entry)
  # Phase 19's: the PropMLP over 504 IPE columns, launched by (b)'s f32
  # steps (on the TF32 libraries' head-0 instances, in turns with the FMA
  # instances they replaced: 'in_turns'; the bound three TF32 products',
  # the FMA pipes' beside it) and (c)'s bf16 steps (the wide-input
  # instances; the times of the design they replaced, trunk_fwd.cu /
  # trunk_bwd.cu, measured in this run: 'was'), the depth-8 trunk's beside
  # them; the PyTorch chain's time as library_ms.
  for which, desc, src, at, fma_src, b16_src, was_src in (
      ('K1 wide', 'spatial trunk forward on 504 input columns, the density '
       'head alone (the PropMLP)', tf32_src, 612, f32fwd_src, ftma_src,
       fwd_src),
      ('K4 wide', 'spatial trunk backward on 504 input columns, the density '
       'head alone (the PropMLP)', tf32_bwd_src, 668, f32_src, tma_src,
       bwd_src)):
    f32, b16 = kernels[which, 'float32'], kernels[which, 'bfloat16']
    d8, b16_d8 = (kernels[which + ' depth 8', cdt]
                  for cdt in ('float32', 'bfloat16'))
    line.append({
        'name': f'{which} {desc}', 'route': 'cuda', 'source': src,
        'replaces': f'{pallas}:{at}', 'launches': cascade_path[which],
        'max_abs_err': f32['max_abs_err'], 'ms': f32['ms'],
        'plain_ms': f32['plain_ms'], 'bound_ms': f32['bound_ms'],
        'bound_by': f32['bound_by'], 'library_ms': f32['library_ms'],
        'dtype': 'float32', 'n_samples': N_SAMPLES, 'case': 'depth 4',
        'fma_bound_ms': f32['fma_bound_ms'],
        'f32_route': 'three TF32 passes on wgmma', 'was_source': fma_src,
        'in_turns': f32['in_turns'],
        **({'faults': f32['faults']} if 'faults' in f32 else {}),
        'depth8': {k: d8[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                      'max_abs_err', 'in_turns')},
        'bf16_source': b16_src, 'bf16_ms': b16['ms'],
        'bf16_plain_ms': b16['plain_ms'], 'bf16_bound_ms': b16['bound_ms'],
        'bf16_max_abs_err': b16['max_abs_err'],
        'bf16_library_ms': b16['library_ms'],
        'bf16_was_source': was_src, 'bf16_was_ms': b16['was_ms'],
        'bf16_depth8': {k: b16_d8[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                               'max_abs_err')},
        'bf16_train_launches': cascade_bf16_path[which],
        # Phase 23: the bf16 cascade's REMAT_STEPS steps under Model.remat.
        'remat_launches': remat['cascade']['remat_launches'][which]})
  # Phase 24's: the width-1024 pair (mip-NeRF 360's NeRF MLP), launched by
  # the bf16 steps (and the f32 steps and both requests), timed at a step's
  # N_SAMPLES rows (at a request's 131,072 under 'request_*'); the
  # directional pair of the same model (trunk_dir1.cu on 283 columns; its
  # weight gradient on trunk_w1024.cu's product).
  dir1_src = 'refnerf_tpu_torch/csrc/trunk_dir1.cu'
  w1024_src = {'K1 W1024 hc256': 'refnerf_tpu_torch/csrc/trunk_w1024.cu',
               'K4 1st W1024': 'refnerf_tpu_torch/csrc/trunk_w1024.cu',
               'K2 m360': dir1_src, 'K5 m360': dir1_src}
  for which, desc, at, key in (
      ('K1 W1024 hc256', 'spatial trunk forward at width 1024, the density '
       'head and the 256-wide bottleneck (mip-NeRF 360)', 612, 'K1 w1024'),
      ('K4 1st W1024', 'spatial trunk first-order backward at width 1024 '
       '(mip-NeRF 360)', 668, 'K4 w1024'),
      ('K2 m360', 'directional trunk 1 x 128 on 283 columns (mip-NeRF 360)',
       612, 'K2'),
      ('K5 m360', 'directional trunk backward on 283 columns, dx', 668,
       'K5')):
    b16, f32 = kernels[which, 'bfloat16'], kernels[which, 'float32']
    keys = ('max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'library_ms')
    entry = {
        'name': f'{which} {desc}', 'route': 'cuda', 'source': w1024_src[which],
        'replaces': f'{pallas}:{at}', 'launches': m360_path['bfloat16'][key],
        'max_abs_err': b16['max_abs_err'], 'ms': b16['ms'],
        'plain_ms': b16['plain_ms'], 'bound_ms': b16['bound_ms'],
        'bound_by': b16['bound_by'], 'library_ms': b16.get('library_ms'),
        'dtype': 'bfloat16', 'n_samples': N_SAMPLES,
        **{'f32_' + k: f32[k] for k in keys},
        'f32_train_launches': m360_path['float32'][key],
        'request_launches': m360['bfloat16']['request']['launches'].get(key,
                                                                         0)}
    for k in keys:
      if 'request_' + k in b16:
        entry['request_' + k] = b16['request_' + k]
        entry['f32_request_' + k] = f32['request_' + k]
    if 'fma_bound_ms' in f32:  # f32 bound as three TF32 products; the FMA's
      entry['f32_fma_bound_ms'] = f32['fma_bound_ms']
      entry['f32_route'] = 'three TF32 passes on wgmma'
    line.append(entry)
  # Phase 25's: the defaults' spatial trunk (8 x 256 on 504 columns, the
  # density head, the 256-wide bottleneck) on the wide-input instances,
  # launched by the defaults' bf16 steps (K3, K4 with u's cotangent) and
  # request (K1), the variants' (the first-order K4 without density normals,
  # the 128-wide head's pair); the f32 counts beside them.
  def launched(dtype, key, step, request, variants):
    count = defaults_path[dtype].get(key, 0) if step else 0
    if request:
      count += defaults[dtype]['DEFAULTS']['request']['launches'].get(key, 0)
    for v in variants:
      count += sum(variant_path[dtype][v][k].get(key, 0)
                   for k in ('step', 'request'))
    return count
  # (name, description, line of the TPU kernel, launches key, counted in the
  # defaults' step, in their request, in the variants').
  for which, desc, at, key, step, request, variants in (
      ('K1 wide hc256', 'spatial trunk forward on 504 input columns with the '
       '256-wide bottleneck (the defaults)', 612, 'K1 wide', False, True,
       ('DEFAULTS_FIRST',)),
      ('K3 wide hc256', 'the same with the density gradient, u folded chunk '
       'by chunk (f32: three TF32 passes of wgmma)', 589, 'K3 wide', True,
       False, ()),
      ('K4 wide hc256 1st', 'spatial trunk first-order backward on 504 input '
       'columns with the 256-wide bottleneck', 668, 'K4 wide', False, False,
       ('DEFAULTS_FIRST',)),
      ('K4 wide hc256 ubar', 'the same with the cotangent of u (the '
       'second-order pass, the tangent made chunk by chunk at layer 0 and '
       'read back at the skip layer)', 668, 'K4 wide', True, False, ()),
      ('K1 wide hc128', 'spatial trunk forward on 504 input columns with a '
       '128-wide head', 612, 'K1 wide', False, False, ('DEFAULTS_HC128',)),
      ('K4 wide hc128 1st', 'spatial trunk first-order backward on 504 input '
       'columns with a 128-wide head', 668, 'K4 wide', False, False,
       ('DEFAULTS_HC128',))):
    count = {d: launched(d, key, step, request, variants)
             for d in ('bfloat16', 'float32')}
    b16, f32 = kernels[which, 'bfloat16'], kernels[which, 'float32']
    fwd = which.startswith(('K1', 'K3'))
    if not count['bfloat16'] > 0:
      raise AssertionError(f'phase 25: {which} was launched no time')
    keys = ('max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'library_ms')
    entry = {
        'name': f'{which} {desc}', 'route': 'cuda',
        'source': ftma_src if fwd else tma_src,
        'replaces': f'{pallas}:{at}', 'launches': count['bfloat16'],
        'max_abs_err': b16['max_abs_err'], 'ms': b16['ms'],
        'plain_ms': b16['plain_ms'], 'bound_ms': b16['bound_ms'],
        'bound_by': b16['bound_by'], 'library_ms': b16.get('library_ms'),
        'dtype': 'bfloat16', 'n_samples': N_SAMPLES,
        'f32_source': f32fwd_src if fwd else f32_src,
        **{'f32_' + k: f32[k] for k in keys},
        'f32_launches': count['float32']}
    # The redesigned instances, in turns with the designs they replaced.
    if which in ('K1 wide hc256', 'K3 wide hc256'):
      entry.update(f32_source=tf32_src, f32_was_source=f32fwd_src,
                   f32_fma_bound_ms=f32['fma_bound_ms'],
                   f32_route='three TF32 passes on wgmma',
                   f32_in_turns=f32['in_turns'])
    if which == 'K3 wide hc256':
      entry.update(source=wbf16_src, was_source=ftma_src,
                   bf16_route='one bf16 pass of wgmma on 128-row tiles, the '
                   'fold three TF32 passes', in_turns=b16['in_turns'])
    if which == 'K4 wide hc256 ubar':
      entry.update(was_source=f'{tma_src} (REFNERF_TS_REBUILD)',
                   in_turns=b16['in_turns'])
    if which in ('K4 wide hc256 1st', 'K4 wide hc256 ubar'):
      entry.update(f32_source=tf32_bwd_src, f32_was_source=f32_src,
                   f32_fma_bound_ms=f32['fma_bound_ms'],
                   f32_route='three TF32 passes on wgmma',
                   f32_in_turns=f32['in_turns'])
    line.append(entry)
    if which in ('K1 wide hc256', 'K3 wide hc256', 'K4 wide hc256 1st',
                 'K4 wide hc256 ubar'):
      # The f32 instance's library of its own, as an entry of its own.
      if not count['float32'] > 0:
        raise AssertionError(f'phase 25: {which} f32 was launched no time')
      line.append({
          'name': f'{which} f32 {desc}', 'route': 'cuda',
          'source': tf32_src if fwd else tf32_bwd_src,
          'replaces': f'{pallas}:{at}', 'launches': count['float32'],
          **{k: f32[k] for k in keys}, 'bound_by': f32['bound_by'],
          'fma_bound_ms': f32['fma_bound_ms'], 'dtype': 'float32',
          'n_samples': N_SAMPLES, 'was_source': f32fwd_src if fwd else f32_src,
          'f32_route': 'three TF32 passes on wgmma',
          'in_turns': f32['in_turns']})
  log(f'phase 6: train step {step_s * 1e3:.2f} ms, '
      f'{TRAIN_BATCH / step_s:.0f} train rays/s; phase 8 (fused directional '
      f'stage): {dir_step_s * 1e3:.2f} ms, {TRAIN_BATCH / dir_step_s:.0f} '
      f'train rays/s; in turns {json.dumps(ab)}; phase 10 (all six): '
      f'{spa_step_s * 1e3:.2f} ms, {TRAIN_BATCH / spa_step_s:.0f} train '
      f'rays/s; in turns {json.dumps(ab6)}; phase 12 (mip-NeRF): ' + '; '.join(
          f'{run} {r[2] * 1e3:.2f} ms a step, {TRAIN_BATCH / r[2]:.0f} train '
          f'rays/s, requests ' + ', '.join(f'{k} {v:.1f} ms'
                                           for k, v in r[3].items())
          for run, r in mip.items()) + f'; phase 13 (float32, all six): '
      f'{f32_step_s * 1e3:.2f} ms, {TRAIN_BATCH / f32_step_s:.0f} train '
      f'rays/s; phase 14 (float32, all six, 4096-ray requests): '
      f'{json.dumps(f32_request)}; phase 15 (mip-NeRF, float32): '
      f'{mip_f32_step_s * 1e3:.2f} ms, {TRAIN_BATCH / mip_f32_step_s:.0f} '
      f'train rays/s, device busy {mip_f32_prof["busy_ms"]:.2f} ms a step, '
      f'4096-ray requests {json.dumps(mip_f32_request)}; phase 16 (from '
      f'disk): {json.dumps(data)}; phase 17 (the CLIs): {json.dumps(cli)}; '
      f'phase 18 (the LLFF geometry gins): {json.dumps(geo)}; phase 19 (the '
      f'proposal cascade): {json.dumps(cascade)}; phase 20 (the mesh tools '
      f'and interop): {json.dumps(mesh)}; phase 21 (serving from '
      f'artifacts): {json.dumps(art)}; phase 22 (data parallel, two ranks '
      f'sharing one card: no scaling figure): {json.dumps(dp)}; phase 23 '
      f'(Model.remat): {json.dumps(remat)}; phase 24 (mip-NeRF 360 at full '
      f'width): {json.dumps(m360)}; phase 25 (the defaults): '
      f'{json.dumps(defaults)}; planted faults '
      f'{json.dumps(w1024_faults_read)}, the chunked contract\'s '
      f'{json.dumps(defaults_faults_read)}')
  log('phase seconds: ' + json.dumps(
      {str(k): round(v, 1) for k, v in sorted(secs.items())}) +
      f'; in all {time.perf_counter() - START:.1f} s')
  print(json.dumps({'kernels': line}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
