#!/usr/bin/env python3
"""Smoke run of the PyTorch port (aonerf_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:
  1. device  - a CUDA card is required; prints its name and power limit, and
               turns TF32 off so the plain versions run in full fp32.
  2. build   - compiles every CUDA source of the port with nvcc, at the
               default encoded widths (63 / 27) and at phase 27's (75 / 39,
               51 / 15), every nvcc at once.
  3. kernels - the fused level kernel against its plain PyTorch version at
               the serving path's shapes (4096 rays, S = 65 and 193, both
               backgrounds) and the ray tile its wrapper chooses (printed);
               on 512 of the rays, its error and the fp32
               plain version's against the plain version in fp64, which
               catches products that lost fp32 accuracy (plain TF32); times
               and the bounds (3xTF32 on the tensor cores, and fp32).
  4. serving - a full-width NeRF from a seed renders two 320x240 test views of
               the analytic laptop scene through the image renderer; PSNR and
               SSIM against the ray-traced targets, rays/s, the kernel's launch
               count, and one view again through the plain version.
  5. spill   - the training forward K1s at the train step's shapes (2048
               rays, S = 65 and 193, both backgrounds; the ray tile printed):
               its four outputs equal
               to K1's bit for bit, its saved activations and raw sigma/rgb
               against the plain version's, a repeat call's bits, and K1s and
               K1 timed in turns with the bound of each; then the same checks
               at S = 7, where each block's weight stream ends mid-ring in a
               partial chunk.
  6. backward - the level weight-gradient kernel (K2) against its plain
               version at the same shapes (random cotangents), through the
               composition K1s + the backward from what it saved; the
               backward from saved and its plain version timed in turns, its
               passes (integrator backward, B1, B2, reduce) by the profiler
               with the bound of each; B2 alone against the fp64 products of
               the operands it read (B2_FP32_TOL) and an fp32 torch.mm a
               product; and one two-level loss backward through the kernels
               against the same computation through the plain versions.
  7. training - the train CLI on a SAPIEN-layout laptop scene (8 train views,
               1 val view, 320x240) at the published width: 50 steps with a
               validation and a checkpoint, then a resume for 10 more; loss,
               launch counts of K1 (validation only), K1s and K2, train rays/s
               and the peak device memory of a step.
  8. test    - the train CLI's --run_eval on the same scene's 4 test views:
               it restores the step-60 checkpoint, renders every view through
               K1 and writes results.json and the render directory; K1's
               launch count (K1s and K2 none) and ray tiles, PSNR/SSIM/object PSNR finite
               and LPIPS NaN, every output file; view 0 rendered again
               through K1 gives test()'s depth bit for bit and through the
               plain version its rgb within TOL_RENDER_RGB; seconds per view
               for test() and for the render alone, with K1's share by the
               profiler.
  9. autodecoder - the train CLI on the articulated auto-decoder
               (config/autodecoder.json as published: batch 4096, 64+128
               samples, 8x256 trunk, 4x128 deformation and view branches,
               128/128/32 codes, latent_dense, chunk 3840; lr 1e-3 with no
               delay) on a sapien_multi laptop scene (2 instances x 10
               articulations x 4 views at 320x240, plus a held-out val split
               of the 9 midpoint degrees x 1 view): 50 steps with a
               validation and a checkpoint, then a resume for 10 more; the
               loss falling, K1, K1s and K2 launched 0 times (no fused
               kernel computes this field); ms per step and train rays/s,
               peak device memory of a step, the profiler's top device ops
               and idle share; on 256 rays, the card's two-level render of
               the seed's random field against the same weights on the CPU
               in fp64.
 10. articulated test - --run_eval on that checkpoint: the 19-pose
               interpolated-articulation sweep at 320x240, every output file,
               PSNR/SSIM/object PSNR finite, seconds per view for test() and
               for the render alone; then --run_optimize for 50 steps at
               batch 1024, its psnr1 history finite.
 11. autoencoder - the train CLI on the articulated auto-encoder
               (config/ae_art.json as published: batch 4096, 64+128 samples,
               a 320x240 source view encoded by the multi-head ResNet34 each
               step, 8x256 trunk, 4x128 deformation and view branches,
               128/128/32 codes, latent_dense, chunk 3840, lr 2.5e-4 but no
               delay) on phase 9's scene, with cuDNN TF32 on as PyTorch
               defaults it: 50 steps with a validation on a held-out degree
               and a checkpoint, then a resume for 10 more; the loss falling,
               loss_state and opacity_loss, K1, K1s and K2 launched 0 times,
               ms per step and rays/s, peak memory, the profiler's top ops,
               idle share and the encoder's convolution share, the encoder's
               forward + backward alone; val psnr, object psnr and both
               joint-state errors finite; on 256 rays, the seed's random AE
               forward on the card with the TF32 flags on against the CPU in
               fp64.
 12. ae test  - --run_eval on that checkpoint: the 19-pose sweep, each pose
               conditioned on the latents and the angle predicted from its
               source view; every output file, PSNR/SSIM/object PSNR finite,
               seconds per view for test() and for the render alone.
 13. bf16 kernels - K1, K1s and K2 in bf16 mode (the TPU kernels' dot_bf16)
               against the bf16 rule (TOL_BF16_*: the plain bf16 version
               summed in fp64 as reference, the limit from the spread of
               six fp32 summation orders of the plain bf16 version), which
               the fp32 kernel must miss: K1 at phase 3's 4096 rays, K1s' saved layers and K2's 26
               gradients at phase 5's 2048, S = 65 and 193, both
               backgrounds; K1s' outputs equal to K1's bits, repeat calls'
               bits, the backward from saved equal to the composition; K1s on
               encoded inputs at exact bf16 ties (ties to even); each kernel
               timed in turns with its fp32 mode, with its plain bf16 version
               and its bounds at the bf16 and the TF32 peak; then at the fast
               preset's shapes, at the ray tile the wrappers choose (2): K1
               at its chunk of 256 rays and K1s at its batch of 224 against
               the bf16 rule, K1 bf16's outputs equal to K1s bf16's, and
               both kernels' outputs in both modes equal to their bits at 16
               rays a block; each timed in turns with the 16-ray launch,
               with its bounds and plain version; the host time of a K1
               launch; K2 bf16 from K1s' saved at 224 rays at the tile its
               wrapper chooses (2) and at 16 rays a block, both against the
               bf16 rule, B2's weight products equal at both, B1 timed in
               turns by the profiler with its bound, B2 beside its bound and
               bf16 torch.mm on the same slices, the host time of a K2 call;
               at 2048 rays B1 bf16 alone: its deltas and head gradients
               against the fp64 products of the operands it read (B1_TOL),
               its ten bias sums against their fp64 sums (B1_BIAS_TOL), and
               its plain version on them, timed in turns with it; and B2 bf16
               alone against the fp64 products of the bf16 scratches it read
               (B2_TOL), timed in turns with the fp32 B2 and its plain
               share, beside bf16 torch.mm on the same slices. In bf16 mode
               K1s' saved and B1's deltas are bf16; phase 14 prints the
               bf16 step's peak memory beside the fp32 step's.
 14. bf16 training - the train CLI at config/vanilla_tpu_fast.json's settings
               (bf16, batch 224, inner_steps 183, grad_clip 1.0, chunk 256) on
               phase 7's scene, cut as phase 7 cuts config/vanilla.json: 2
               multi-steps with a validation and a checkpoint; the loss
               falling, launch counts of K1 (validation), K1s and K2 in bf16
               mode and none in fp32, the ray tiles the wrappers chose, the
               checkpoint's tensors fp32, ms per
               step; --run_eval in bf16 (K1 bf16 only) and test view 0 in bf16
               against the same checkpoint rendered in fp32, and view 0 of the
               run's initial, random field in bf16 against fp32, each within
               a band stated in advance (TOL_BF16_VIEW_*); the train step at
               config/vanilla.json's batch 2048 in fp32 and in bf16, in turns.
 15. articulated bf16 rule - the articulated bf16 rule (PERF.md section 2;
               tests/test_torch_bf16_articulated_rule.py) on the card: the
               seed's latent_dense field with random biases on 256 rays of a
               phase 9 train view and two codes, in bf16 on the card, against
               the CPU's forms (the fp64-summed form as reference; the form
               in fp32, in reversed fp32 and the port's bf16 on the CPU as
               the legitimate evaluations), end to end (each level's share of
               rows off the reference's raw outputs, comp_rgb's rms against
               fp64) and layer by layer (the card's bf16 Dense and latent
               Dense from the fp64 form's inputs); the card's fp32 field must
               miss it; then the seed's auto-encoder on a val view's source
               image (codes, state, comp_rgb).
 16. bf16 presets - config/autodecoder_tpu_fast.json on phase 9's scene and
               config/ae_art_tpu_quality.json and ae_art_tpu_fast.json on
               phase 11's (the same), as published but for the lr delay
               (none): two dispatches through the CLI with a validation and a
               checkpoint, the loss falling, K1/K1s/K2 launched 0 times, the
               checkpoint fp32; --run_eval on 2 of the 19 sweep poses (the
               cut keeps the script within its limit; phases 10 and 12 render
               all 19 in fp32) and, for the auto-decoder, --run_optimize 50
               steps at batch 1024; the step's host ms, the card's busy ms,
               idle share, peak memory and the profiler's top ops, over
               dispatches of 5 steps.
 17. articulated turns - the auto-decoder's and the auto-encoder's step at
               batch 4096 (config/autodecoder.json, config/ae_art.json) in
               fp32 and bf16 in turns, with each mode's peak memory.
 18. optimizers - config/vanilla.json (fp32, batch 2048) on phase 7's scene,
               20 steps through Trainer.fit under each of the reference's
               recipes: sgd + steplr + warmup, adam (AdamW, weight decay 1e-4)
               + cosine, radam + poly, ranger + poly with a checkpoint at step
               10 and a resume from it whose slow weights equal the saved
               ones; then config/autodecoder.json with latent_lr 1e-3 on phase
               9's scene, 20 steps. Per run: the loss falling, the lr at steps
               0, 10 and 19, K1s and K2 launched on every vanilla run.
 19. encode reuse - config/ae_art.json with ae_encode_reuse 4 and inner_steps
               8 on phase 9's scene, two dispatches: on every field-only step
               the encoder, state decoder and degree embedding and their Adam
               moments bit for bit unchanged on the card, the count advanced,
               the field-only loss falling; then the step's host ms beside
               ae_encode_reuse 1 in turns (reuse 4, 1, 1, 4) and each one's
               busy ms on the card (torch.profiler).
 20. ragged dataset - phase 9's scene with one instance's 10-degree views
               removed, through Trainer.fit on the host-batched step behind
               the prefetcher: 20 steps, the loss, host ms a step, the card's
               busy ms and idle share (fit's closing checkpoint left out of
               both); then --run_eval on 2 sweep poses.
 21. noise kernels - K1s with sigma noise (noise_std 1.0 from a seed) at
               2048 rays, S = 65 and 193, in fp32 and bf16: raw sigma the
               noiseless raw sigma plus the noise bit for bit, saved and raw
               rgb the noiseless bits, a zero noise the noiseless bits; the
               outputs against the plain version with the same noise (fp32
               within TOL, bf16 by the bf16 rule); K2 from the noisy saved and
               raw against its plain version (fp32 the per-gradient rule, bf16
               the bf16 rule); K1s with and without noise in turns.
 22. noise training - config/vanilla.json with noise_std 1.0 on phase 7's
               scene, 20 steps through Trainer.fit: the loss falling, K1s
               and K2 launched 40 times each, 40 noise draws.
 23. settings  - on phase 7's scene at inner_steps 5: is_optimize with
               profile_steps 5 (checkpoints every steps_per_epoch = 5 steps,
               all kept; the trace's device_op_table naming K1s and K2's
               kernels, its top rows printed); debug_nans raising
               FloatingPointError at the first step's level outputs on a NaN
               planted in a weight (the kernels keep it), and training
               without it.
 24. lpips test - --run_eval on phase 7's checkpoint with
               AONERF_LPIPS_WEIGHTS naming random weights at VGG16's widths
               written from a seed: results.json's lpips finite, view 0's
               LPIPS on the card within 1e-4 relative of the CPU's on the
               same images, test()'s seconds a view with and without LPIPS.
 25. nan kernels - K1 at 4096 rays, K1s and K2 at 2048, S = 65 and 193, in
               fp32 and bf16 mode, with one NaN planted in a trunk weight,
               then in a view-branch weight, in one sample's encoded input
               (0x7fffffff, as the card's sin gives it for a NaN point), and
               (K2) in one ray's acc cotangent: every output and gradient NaN exactly where its
               plain version's is (the reference's masks: a NaN through the
               forward's ReLU and clamps, none through a closed backward
               mask), the finite entries within TOL / K2's per-gradient rule
               (fp32) or the bf16 rule.
 26. geometry  - export_voxels --resolution 128 --mesh on the card for the
               checkpoints of phases 7, 9 and 11; a 32^3 density grid from
               the same restored parameters on the card and on the CPU
               within GEO_GRID_TOL (in the default box, widened while the
               card's grid is constant there; phase 7's vanilla density is 0
               in every box, so its mesh check takes the raw density); at a
               level in the widest gap of the
               card's grid, a non-empty marching-tetrahedra mesh with the
               CPU grid's mesh's faces and its vertices within the bound the
               grids' difference allows; the seconds of a 128^3 grid and of
               its mesh.
 27. degrees   - the vanilla NeRF at other encoding degrees: K1, K1s and K2 at
               2048 rays, S = 65 and 193, at encoded widths 75 / 39 and
               51 / 15, in fp32 and bf16 mode, against their plain versions
               under the rules of the default widths (TOL, K2's per-gradient
               rule, the bf16 rule), with their times, plain versions' and
               bounds; then config/vanilla.json at full width (batch 2048,
               64+128 samples, 8x256) through the train CLI on phase 7's
               scene, 20 steps in fp32 at max_deg_point 12, deg_view 6 and
               20 in bf16 at 8 / 2: the loss falling, K1 (validation), K1s
               and K2 launched in the run's mode; --run_eval of one test
               view and a 32^3 grid through export_voxels from the fp32
               run's checkpoint; the phase's seconds.
 28. data parallel - torch.distributed on the one card: one rank under NCCL,
               config/vanilla.json at full width (batch 2048, 64+128 samples,
               8x256) on phase 7's scene for 10 steps, its parameters the
               non-distributed Trainer's bit for bit; then two spawned ranks
               sharing the card under gloo (NCCL takes one rank a card): the
               first vanilla step of the seed's weights, each rank's K2
               launches held by K2's per-gradient fp32 rule against the fp64
               backward of its own K1s saved, the all-reduced gradient within
               DP_ULPS fp32 ulps of the fp64 sum of the ranks' row-weighted
               shares, its largest difference from the one-rank gradient of
               the same global batch printed; Trainer.fit for 30 steps, the
               parameters equal on both ranks after every step, the loss
               falling, each rank's K1 (validation), K1s and K2 launches;
               test() of its checkpoint on 2 ranks, the gathered images equal
               bit for bit to one device's test() of it; the auto-decoder
               (config/autodecoder.json) on phase 9's scene with
               shard_scene_buffers, each rank holding half the views, 20
               steps with the loss falling; each run's ms a step beside the
               card's name and power limit (two ranks on one card measure the
               mechanism, not a speed-up).
 29. data path - the datagen CLI (python -m aonerf_torch.data.datagen.generate)
               writes a 320x240 single scene (100 train, 2 val, 2 test views
               with depth) and a multi scene (2 instances x 10 degrees x 4
               views) in two processes at once, then a replay of the single
               scene's test poses, its rgb and depth equal to the test views';
               the native loader built and loaded; each scene loaded
               LOAD_REPEATS times natively and as many with
               AONERF_NO_NATIVE=1, in turns, the median host seconds of each,
               rays_o equal, rays_d and rgb within TOL_LOAD_*, the multi
               scene's views equal; config/vanilla.json at full width (batch
               2048, 64+128 samples, 8x256) through the train CLI on the
               single scene for 10 steps, its train buffers by the native
               loader, K1 (validation), K1s and K2 launched, the loss
               finite; test() of one view (K1 only), results.json finite,
               its depth PNGs; check_poses on the train poses (radius 4 +-
               0.5) and conventions.load_sapien's c2ws the dataset's.
The line before the last is a JSON object with one entry per kernel and mode
(K1, K1s, K2 in fp32, then in bf16; K1 and K1s in bf16 at the fast preset's
shapes; B2 and B1 in bf16; B2 in fp32; K1, K1s and K2 at phase 27's widths,
fp32 at 75 / 39 and bf16 at 51 / 15); the last line is {"ok": true,
"device": {...}}.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet), for the bound of each kernel.
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3
# Multiply-adds per sample of the fused level: 63x256 + 4x256x256 + 256x256
# + 63x256 + 2x256x256 + 256x1 + 256x256 + 256x128 + 128x3. All but the
# density and rgb heads run on the tensor cores (3xTF32) in K1 and K1s; the
# heads and the per-ray view term (27x128 a ray) on the fp32 cores.
MACS_PER_SAMPLE = 589952
FWD_FP32_MACS = 256 + 128 * 3
FWD_TC_MACS = MACS_PER_SAMPLE - FWD_FP32_MACS
R = 4096  # rays per tile of the serving path
H, W = 240, 320
SEED = 0
# Tolerances of the kernel against its plain version: both fp32, different
# summation order and FMA placement.
TOL = {"comp": 1e-4, "acc": 1e-4, "weights": 1e-4, "depth": 1e-3, "saved": 1e-4, "raw": 1e-4}
# A whole view rendered through the kernel vs through the plain version: the
# kernel's 1e-4 on coarse weights moves fine t-values through the inverse CDF.
TOL_RENDER_RGB = 1e-3
# K1 against the plain version in fp64 on FP64_RAYS rays: each output's max
# abs error / max |fp64| at most max(1e-6, 4 x the fp32 plain version's own
# error on that output). 3xTF32 keeps fp32's accuracy and passes; one TF32
# product (operands rounded to 2^-11) misses it ~300x on the CPU emulation
# (tests/test_torch_tf32_fwd.py).
TOL_FWD, TOL_FWD_FACTOR, FP64_RAYS = 1e-6, 4.0, 512
# K1s' saved activations against the plain version in fp64, layer by layer
# (h0..h7, bottleneck, view): each layer's rms error at most
# SAVED_RMS_FACTOR x the fp32 plain version's rms error on that layer. The
# outputs above hide a longer run of tensor-core accumulation (it truncates
# as it adds); the saved layers show it (tools/torch_fwd_accuracy.py).
SAVED_LAYERS = tuple(f"h{i}" for i in range(8)) + ("bottleneck", "view")
SAVED_RMS_FACTOR = 1.5
# Multiply-adds per sample of the level backward from the saved activations:
# the weight products h^T.delta (as many as the forward) and the input
# products delta.W^T (none for w0 and w5i); plus 27x128 per ray (dWvb).
BWD_MACS_PER_SAMPLE = 2 * MACS_PER_SAMPLE - 2 * 63 * 256
# Operations per sample of the integrator backward, counted from the source
# (each exp, log, division and shuffle-add as one): ~90.
INTEGRATOR_FLOPS_PER_SAMPLE = 90
N_WEIGHTS = 595844  # floats in the 26 weights of one level
PEAK_TF32_FLOPS = 495e12  # TF32 tensor cores, dense; 3xTF32 does 3 TF32 products per product
# K2's passes (csrc/fused_train.cu): multiply-adds per sample on the tensor
# cores (3xTF32) and on the fp32 cores. B1: every delta . W^T but the narrow
# heads' (wr 384, rank-1 wd 256); its fp32 part is those and the head
# gradients wr (384) and wd (256). B2: every dW but wd and wr.
B1_TC_MACS, B1_FP32_MACS = 557696 - 640, 640 + 640
B2_TC_MACS = MACS_PER_SAMPLE - 640
SAVED_FLOATS = 2432  # saved activations (and deltas) per sample
# The saved columns B1 reads: h0..h7 and the view hidden layer, whose ReLU
# masks its deltas; not the bottleneck's 256, which has no mask.
B1_SAVED_FLOATS = SAVED_FLOATS - 256
K2_PASSES = {  # kernel name in csrc/fused_train.cu -> pass
    "level_bwd_integrator_kernel": "integrator", "level_bwd_delta_kernel": "B1",
    "level_bwd_dw_kernel": "B2", "level_bwd_reduce_kernel": "reduce",
}
# In bf16 mode B2 is a kernel of its own; B1 is level_bwd_delta_kernel<true>.
K2_PASSES_BF16 = {**{k: v for k, v in K2_PASSES.items() if v != "B2"}, "level_bwd_dw_bf16_kernel": "B2"}
# Pass B2's products (csrc/fused_train.cu, AONERF_DW_PRODUCTS): weight
# gradient -> (H's columns in saved, None for xenc; Delta's columns in B1's
# delta scratch), and its biases -> Delta's columns. wva's and bv's Delta is
# 128 wide, every other 256.
B2_PRODUCTS = {"w0": (None, 0), **{f"w{i}": ((i - 1) * 256, i * 256) for i in (1, 2, 3, 4, 6, 7)},
               "w5x": (4 * 256, 5 * 256), "w5i": (None, 5 * 256), "wb": (7 * 256, 8 * 256),
               "wva": (8 * 256, 9 * 256)}
B2_BIASES = {**{f"b{i}": i * 256 for i in range(8)}, "bb": 8 * 256, "bv": 9 * 256}
# B2 in bf16 against the products of the operands it read (K1s' saved, B1's
# deltas, both bf16 scratches; xenc rounded to bf16) summed in fp64: its own
# fp32 sums (32-row tensor-core runs, then the range, then 16 ranges) within
# B2_TOL of each gradient's largest entry. In bf16 mode B2 computes the 11
# weight products; the ten biases are B1's (B1_BIAS_TOL).
B2_TOL = 1e-5
# B2 in fp32 (level_bwd_dw_kernel) the same way, on the fp32 operands it
# read: its 3xTF32 products (each ~2^-22 of itself off the exact product),
# 64-row tensor-core runs, the range and the 16 ranges within B2_FP32_TOL
# of each gradient's largest entry.
B2_FP32_TOL = 1e-5
# B1 in bf16 the same way: each delta it wrote against the product, summed
# in fp64, of the bf16-rounded operands it multiplied (the delta of the layer
# above from its own scratch, the rounded weight; g_raw from the integrator
# backward's scratch), masked by the saved activation, and each head
# gradient it summed (wd, bd, wr, br) against its operands' fp64 sum: its
# own fp32 sums (tensor-core runs of 32 columns, its per-block and per-chunk
# head sums) within B1_TOL of each one's largest entry. It writes each delta
# rounded to bf16 (to nearest), up to half a bf16 ulp (2^-8 of the value)
# from its fp32 sum, so a delta's error beyond 2^-8 of its fp64 product is
# what B1_TOL holds (b1_delta_error).
B1_TOL = 1e-5
# B1's ten bias sums in bf16 mode (b0..b7, bb, bv: the unrounded fp32 deltas
# of each chunk's rows, a fixed shuffle tree, the chunks and then the blocks
# in order) against the fp64 sums of the fp64 products of its operands (the
# deltas as b1_products forms them): each within B1_BIAS_TOL of its largest
# entry. Stated before the first run on the card: a plain emulation on the
# CPU (fp32 products of the same bf16 operands, fp32 sums) is 2.1e-7 / 2.7e-7
# off at 64 / 256 rays x 65 samples; the card's 392,000-row sums add the
# tensor cores' truncation, which scales with each delta and so largely
# with the sum, and a longer fp32 chain (49 chunks, 128 blocks).
B1_BIAS_TOL = 1e-5
K2_RANGES = 16  # pass B2's row ranges
NARROW_FLOATS = 4104  # a B1 block's narrow set: wd, bd, wr, br, wvb, each padded to 4 floats
R_TRAIN = 2048  # rays per train step (config/vanilla.json)
# K2 against its plain version. A gradient is a sum over R*S rows through
# eight ReLU masks and the integrator's 1/max(1 - alpha + 1e-10, 1e-10),
# where alpha = 1 - exp(-sigma dist) rounds in fp32: a hidden unit whose
# pre-activation lies within rounding of 0 is on in one summation order and
# off in another, and near an opaque sample one ulp of exp moves v by a large
# fraction of itself. Both move trunk gradients by up to ~1e-3 of their
# largest entry with random cotangents (measured on the H100: the plain
# version in fp32 against itself in fp64, 7.9e-4 on w0 at 256 rays x 193
# samples), and by ~1e-2 under the small MSE cotangents of the two-level loss
# (1.9e-2 on coarse pts_3 at 32 rays on the CPU). So the kernel and the fp32
# plain version are both held against the plain version in fp64: the kernel
# passes when each gradient's error there (max abs err / max |fp64|) is at
# most max(1e-4, 4 x the fp32 plain version's error on that same gradient).
# So a gradient that fp32 computes well (the heads, ~1e-6) is held to 1e-4.
TOL_GRAD, TOL_GRAD_FACTOR = 1e-4, 4.0
TOL_LOSS = 1e-5  # relative, two-level loss through the kernels vs the plain versions
TRAIN_STEPS, RESUME_STEPS = 50, 10
N_TEST = 4  # test views of the training scene, scored by phase 8
AD_RAYS = 256  # rays of phase 9's fp64 check
# The articulated render on the card against the same weights on the CPU in
# fp64: each output's max abs error at most max(1e-5, 4 x the CPU fp32
# render's own error). On the CPU at 256 rays of a random field the fp32
# render is 3.4e-7 (rgb) and 1.6e-6 (depth) off fp64, and one TF32 product
# per layer (operands rounded to 10 mantissa bits) 1.5e-4 and 8.0e-4.
TOL_AD, TOL_AD_FACTOR = 1e-5, 4.0
OPTIMIZE_STEPS, OPTIMIZE_BATCH = 50, 1024
AE_RAYS = 256  # rays of phase 11's fp64 check
# The auto-encoder's forward on the card against the same weights on the CPU
# in fp64, each output (every head's code, the predicted state, each level's
# rgb, acc and depth) within max(1e-5, 4 x the CPU fp32 forward's error), run
# with cuDNN's process-wide TF32 flag ON, PyTorch's default: the encoder must
# keep its convolutions in fp32 whatever the flag says. (The matmul flag
# stays at PyTorch's default, off: under it the field's F.linear, as the
# auto-decoder's, would run TF32.)
TOL_AE, TOL_AE_FACTOR = 1e-5, 4.0
# bf16 mode (phases 13-14; the TPU kernels' dot_bf16): every product of the
# level takes bf16-rounded operands and sums in fp32. The bf16 rule:
# reference, the plain version in bf16 mode with every operand rounded as
# the kernels round it and every product and sum in fp64; each output of K1
# (comp, acc, depth, weights), each saved layer of K1s (h0..h7, bottleneck,
# view) and each of K2's 26 gradients is held, by max abs err / max
# |reference|, to max(TOL_BF16_FWD forward or TOL_BF16_GRAD gradients,
# TOL_BF16_SPREAD x the spread of the plain bf16 version over the six fp32
# summation orders of BF16_ORDERS around the reference on that output: the
# largest distance of the six from it, by the same measure). A bf16 operand
# rounds to one neighbour or the other where an fp32 sum lies within its
# rounding error of a tie, so every fp32 order lands its own distance from
# the reference, and a max error over sparse flips is noisy. (A first rule,
# 4x the cuBLAS order's own error, failed the reversed-K order on 4 of 48
# seed x level cases of tools/torch_bf16_accuracy.py, up to 4.5x its limit
# on bd; a second, 2x the farthest of three orders (cuBLAS, reversed K, K in
# halves), failed the witness order K in quarters and the kernel on 1 of 48,
# seed 4 S=193 K2, up to 1.068x; PERF.md section 6.) The fp32 kernel must
# miss the rule on at least one output a level, which shows that it tells
# the modes apart.
TOL_BF16_FWD, TOL_BF16_GRAD, TOL_BF16_SPREAD = 1e-6, 1e-4, 2.0
PEAK_BF16_FLOPS = 989e12  # bf16 tensor cores, dense
OUTPUTS = ("comp", "acc", "depth", "weights")
# K1s in bf16 on encoded inputs placed exactly halfway between two bf16
# values: the share of its saved h0 that differs from the plain version's
# (torch rounds to nearest, ties to even) stays below TIE_SHARE. Rounding
# ties away from zero moves half of the inputs by a bf16 ulp and h0 with them
# (~5% of h0 on the CPU emulation, tests/test_torch_bf16_kernels.py); other
# summation orders alone move ~0.01%.
TIE_SHARE = 5e-3
# The fast preset (config/vanilla_tpu_fast.json: batch 224, inner_steps 183,
# grad_clip 1.0, bf16, chunk 256) trains FAST_MULTI_STEPS multi-steps on
# phase 7's scene. Stated before its first run on the card: its test view 0
# rendered in bf16 against the same checkpoint rendered in fp32, max abs rgb
# difference at most TOL_BF16_VIEW_MAX and mean at most TOL_BF16_VIEW_MEAN;
# the trained field renders the white background alone, so the same band
# holds view 0 of the run's initial, random field too.
FAST_MULTI_STEPS = 2
CHUNK_FAST = 256  # config/vanilla_tpu_fast.json's chunk: K1's rays a launch on that path
BATCH_FAST = 224  # its batch: K1s' and K2's rays a launch on that path
TOL_BF16_VIEW_MAX, TOL_BF16_VIEW_MEAN = 0.05, 2e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, warmup: int, iters: int) -> float:
    """Mean milliseconds of fn() on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    print(smi_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, cuda {torch.version.cuda}; TF32 off "
        f"(matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32})"
    )


def phase_build() -> None:
    from aonerf_torch.ops.kernels import build

    names = build.all_sources()
    # the default encoded widths' libraries and phase 27's, every nvcc at once
    targets = [*names, *((n, build.width_defines(*_run_widths(deg))) for _, deg in DEGREE_RUNS for n in names)]
    t0 = time.perf_counter()
    paths = build.build(targets)
    print(f"build: {[build.label(t) for t in targets]} in {time.perf_counter() - t0:.1f} s -> "
          f"{[p.name for p in paths.values()]}")
    for name, log in build.ptxas_log.items():
        kernel = ""
        for line in log.splitlines():
            entry = re.search(r"entry function '(\w+)'", line)
            if entry:
                kernel = _kernel_name(entry.group(1))
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name} {kernel}: {line.strip()}")


def _kernel_name(mangled: str) -> str:
    """A kernel's name in its mangled one (_ZN, then each nested name after
    its length in digits), then fp32 or bf16 for a <false> or <true>
    instantiation."""
    pos = mangled.find("_ZN") + 3
    while pos > 2:
        digits = re.match(r"\d+", mangled[pos:])
        if not digits:
            break
        pos += digits.end()
        name, pos = mangled[pos: pos + int(digits.group())], pos + int(digits.group())
        if name.endswith("_kernel"):
            rest = mangled[pos:]
            return name + (" fp32" if rest.startswith("ILb0E") else " bf16" if rest.startswith("ILb1E") else "")
    return mangled


def _view(rng, boxes, focal):
    """Rays and white-composited target of one random test view."""
    from aonerf_torch.data.camera import get_ray_directions_np, get_rays_np
    from aonerf_torch.data.synthetic import random_pose_on_sphere, render_scene

    c2w = random_pose_on_sphere(rng)
    rgb, alpha, _ = render_scene(boxes, c2w, H, W, focal)
    target = rgb * alpha[..., None] + (1.0 - alpha[..., None])
    rays_o, viewdirs, rays_d, _ = get_rays_np(get_ray_directions_np(H, W, focal), c2w[:3, :4])
    rays = {"rays_o": rays_o, "rays_d": rays_d, "viewdirs": viewdirs}
    return rays, target.astype(np.float32), alpha


def _macs(P: int = 63) -> int:
    """Multiply-adds a sample of the level at encoded sample width P: w0's
    and w5i's products take P x 256 each."""
    return MACS_PER_SAMPLE + 2 * 256 * (P - 63)


def _n_weights(P: int = 63, V: int = 27) -> int:
    """Floats in the 26 weights of a level at encoded widths P / V."""
    return N_WEIGHTS + 2 * 256 * (P - 63) + 128 * (V - 27)


def _fwd_bounds(S: int, R: int = R, spill: bool = False, saved_bytes: int = 4, P: int = 63, V: int = 27) -> dict:
    """The forward level's bounds, each (ms, what bounds it): "3xtf32" with
    the arithmetic K1 and K1s do (the products in 3xTF32 on the tensor cores,
    the heads and the view term on the fp32 cores), "fp32" with every product
    on the fp32 cores, "bf16" and "tf32" with the products at the bf16 peak
    and at the TF32 peak the bf16 mode's one mma can reach; against the bytes
    of the inputs read once and the outputs written once (with spill, K1s'
    raw and its saved activations too, at saved_bytes a value: 2 for the
    bf16 mode's, which are bf16 values); at encoded widths P / V."""
    rows = R * S
    n_bytes = 4.0 * (rows + R * 3 + R * V + rows * P + _n_weights(P, V)  # inputs
                     + R * 3 + R + R + rows)  # outputs
    if spill:
        n_bytes += rows * (saved_bytes * SAVED_FLOATS + 4.0 * 4)
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    fp32_narrow = 2.0 * (rows * FWD_FP32_MACS + R * V * 128) / PEAK_FP32_FLOPS * 1e3
    tc = 2.0 * rows * (_macs(P) - FWD_FP32_MACS) * 1e3  # the tensor-core products' operations, over a peak
    all_fp32 = 2.0 * (rows * _macs(P) + R * V * 128) / PEAK_FP32_FLOPS * 1e3
    return {"3xtf32": _bound(3 * tc / PEAK_TF32_FLOPS + fp32_narrow, t_bytes), "fp32": _bound(all_fp32, t_bytes),
            "bf16": _bound(tc / PEAK_BF16_FLOPS + fp32_narrow, t_bytes),
            "tf32": _bound(tc / PEAK_TF32_FLOPS + fp32_narrow, t_bytes)}


def _fwd_errors(got, want64) -> dict:
    """Per output of the level: max |got - want64| / max |want64|."""
    return {n: ((g.double() - w).abs().max() / w.abs().max().clamp_min(1e-300)).item()
            for n, g, w in zip(("comp", "acc", "depth", "weights"), got, want64)}


def fp64_check(kp, t, o, d, venc, xenc, white: bool, got) -> float:
    """K1's outputs `got` on the first FP64_RAYS rays against the plain
    version in fp64, each held to max(TOL_FWD, TOL_FWD_FACTOR x the fp32
    plain version's error); returns the largest ratio of error to limit."""
    from aonerf_torch.ops.kernels import fused_render as fr

    n = FP64_RAYS
    sub = (t[:n], o[:n], d[:n], venc[:n], xenc[:n])
    p64 = fr.fused_render_level_ref({k: v.double() for k, v in kp.items()}, *(a.double() for a in sub), white)
    e_k = _fwd_errors([g[:n] for g in got], p64)
    e_p = _fwd_errors(fr.fused_render_level_ref(kp, *sub, white), p64)
    tol = {k: max(TOL_FWD, TOL_FWD_FACTOR * e_p[k]) for k in e_k}
    ratio = {k: e_k[k] / tol[k] for k in e_k}
    S = t.shape[1]
    print(f"  S={S} white={white}: vs fp64 plain on {n} rays, kernel (fp32 plain; limit) "
          + ", ".join(f"{k} {e_k[k]:.3e} ({e_p[k]:.3e}; {tol[k]:.3e})" for k in e_k))
    bad = [k for k in e_k if not ratio[k] <= 1.0]
    if bad:
        fail(f"kernel S={S} white={white}: off the fp64 plain version beyond the fp32 limit on {bad}")
    return max(ratio.values())


def saved_fp64_check(args, saved, saved_plain) -> float:
    """K1s' saved activations against the plain version in fp64, each layer
    held to SAVED_RMS_FACTOR x the fp32 plain version's rms error; returns
    the largest ratio of the kernel's rms error to fp32 plain's."""
    from aonerf_torch.ops.kernels import fused_train as ft

    kp, *rest = args
    s64 = ft.fused_level_fwd_spill_ref({k: v.double() for k, v in kp.items()}, *(a.double() for a in rest), True)[4]
    ratio = {}
    for i, name in enumerate(SAVED_LAYERS):
        cols = slice(256 * i, 256 * i + (128 if name == "view" else 256))
        ref = s64[:, cols]
        e_k, e_p = ((x[:, cols].double() - ref).pow(2).mean().sqrt().item() for x in (saved, saved_plain))
        ratio[name] = e_k / max(e_p, 1e-300)
    del s64
    S = rest[0].shape[1]
    print(f"  S={S}: saved vs fp64 plain, rms error over fp32 plain's (limit {SAVED_RMS_FACTOR:g}): "
          + ", ".join(f"{n} {r:.3f}" for n, r in ratio.items()))
    bad = [n for n, r in ratio.items() if not r <= SAVED_RMS_FACTOR]
    if bad:
        fail(f"K1s S={S}: saved layers off the fp64 plain version beyond {SAVED_RMS_FACTOR:g} x fp32's error on {bad}")
    return max(ratio.values())


def phase_kernels(nerf, boxes, focal) -> dict:
    from aonerf_torch.ops import encoding, sampling
    from aonerf_torch.ops.kernels import fused_render as fr

    dev = torch.device("cuda")
    rays, _, _ = _view(np.random.default_rng(SEED + 100), boxes, focal)
    pick = np.random.default_rng(SEED + 101).choice(H * W, R, replace=False)
    o, d = (torch.from_numpy(rays[k][pick]).to(dev) for k in ("rays_o", "rays_d"))
    venc = encoding.pos_enc(d, 0, 4)
    t_c, pts = sampling.sample_along_rays(o, d, 64, 2.0, 6.0, False, False)
    t_c = t_c.contiguous()
    kp_c, kp_f = fr.kernel_params(nerf.coarse_mlp), fr.kernel_params(nerf.fine_mlp)
    xenc_c = encoding.pos_enc(pts, 0, 10)
    _, _, _, w_c = fr.fused_render_level(kp_c, t_c, o, d, venc, xenc_c, True)
    t_f, pts_f = sampling.sample_pdf(
        0.5 * (t_c[:, 1:] + t_c[:, :-1]), w_c[:, 1:-1], o, d, t_c, 128, False
    )
    t_f = t_f.contiguous()
    xenc_f = encoding.pos_enc(pts_f, 0, 10)

    levels = []
    for kp, t, xenc in ((kp_c, t_c, xenc_c), (kp_f, t_f, xenc_f)):
        S = t.shape[1]
        args = (kp, t, o, d, venc, xenc)
        errs, fp64_ratio = {}, 0.0
        for white in (True, False):
            got = fr.fused_render_level(*args, white)
            torch.cuda.synchronize()
            want = fr.fused_render_level_ref(*args, white)
            for name, g, w in zip(("comp", "acc", "depth", "weights"), got, want):
                if not torch.isfinite(g).all():
                    fail(f"kernel S={S} white={white}: non-finite {name}")
                err = (g - w).abs().max().item()
                errs[name] = max(errs.get(name, 0.0), err)
            fp64_ratio = max(fp64_ratio, fp64_check(*args, white, got))
        tile = fr.launch_tiles[(R, S, False)]
        print(
            f"kernel fused_render_level S={S} at {R} rays, ray tile {tile}: max abs err "
            + ", ".join(f"{k} {v:.3e} (tol {TOL[k]:g})" for k, v in errs.items())
            + f"; vs fp64, at most {fp64_ratio:.3f} of the limit"
        )
        bad = [k for k, v in errs.items() if not v <= TOL[k]]
        if bad:
            fail(f"kernel S={S} disagrees with its plain version on {bad}")
        ms = cuda_ms(lambda: fr.fused_render_level(*args, True), warmup=3, iters=20 if S > 100 else 40)
        plain_ms = cuda_ms(lambda: fr.fused_render_level_ref(*args, True), warmup=1, iters=5)
        bounds = _fwd_bounds(S)
        (bound, bound_by), bound32 = bounds["3xtf32"], bounds["fp32"][0]
        print(
            f"  S={S}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.3f} ms ({bound_by}; "
            f"{2 * MACS_PER_SAMPLE * R * S / 1e12:.4f} TFLOP, the products 3xTF32 at 495 TFLOP/s), "
            f"{bound32:.3f} ms in fp32 at 67 TFLOP/s; {2 * MACS_PER_SAMPLE * R * S / ms / 1e9:.2f} TFLOP/s achieved"
        )
        levels.append({
            "S": S, "ray_tile": tile, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "bound_ms_fp32": bound32,
            "max_abs_err": max(errs["comp"], errs["acc"], errs["weights"]),
            "depth_max_abs_err": errs["depth"], "fp64_err_over_limit": fp64_ratio,
        })
    return {"levels": levels}


def _plain_render_level(kernel_params, t_vals, rays_o, rays_d, viewdirs_enc, samples_enc, white_bkgd,
                        ray_tile=None, dot_bf16=False):
    """K1's plain version in K1's signature, to render through it in place of
    the kernel."""
    from aonerf_torch.ops.kernels import fused_render as fr

    return fr.fused_render_level_ref(kernel_params, t_vals, rays_o, rays_d, viewdirs_enc, samples_enc, white_bkgd,
                                     dot_bf16=dot_bf16)


def phase_serving(nerf, boxes, focal) -> dict:
    from aonerf_torch.eval.metrics import masked_psnr, psnr_image, ssim_image
    from aonerf_torch.eval.render import make_image_renderer
    from aonerf_torch.models import nerf as nerf_mod
    from aonerf_torch.ops.kernels import fused_render as fr

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    views = [_view(rng, boxes, focal) for _ in range(2)]
    views = [({k: torch.from_numpy(v).to(dev) for k, v in rays.items()}, tgt, alpha)
             for rays, tgt, alpha in views]
    render = make_image_renderer(nerf, True, 2.0, 6.0, chunk=R)
    n_tiles = -(-H * W // R)

    torch.cuda.synchronize()
    fr.launches = 0
    t0 = time.perf_counter()
    outs = [render(rays) for rays, _, _ in views]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fr.launches

    expected = 2 * n_tiles * len(views)
    print(f"serving: {len(views)} views of {W}x{H} in {seconds:.3f} s = "
          f"{len(views) * H * W / seconds:.1f} rays/s; fused_render_level launches {launches} "
          f"(expected 2 levels x {n_tiles} tiles x {len(views)} views = {expected})")
    if launches != expected:
        fail(f"fused_render_level launched {launches} times on the serving path, expected {expected}")
    for i, ((rgb, acc, depth), (_, target, alpha)) in enumerate(zip(outs, views)):
        if rgb.shape != (H * W, 3) or acc.shape != (H * W,) or depth.shape != (H * W,):
            fail(f"view {i}: output shapes {rgb.shape}, {acc.shape}, {depth.shape}")
        if not (torch.isfinite(rgb).all() and torch.isfinite(acc).all() and torch.isfinite(depth).all()):
            fail(f"view {i}: non-finite render")
        img = rgb.reshape(H, W, 3)
        tgt = torch.from_numpy(target).to(dev)
        psnr = psnr_image(img, tgt).item()
        ssim = ssim_image(img, tgt).item()
        obj = masked_psnr(img, tgt, torch.from_numpy(alpha).to(dev)).item()
        print(f"  view {i}: psnr {psnr:.4f} dB, ssim {ssim:.5f}, object psnr {obj:.4f} dB "
              "(random init: finite is what counts)")
        if not all(np.isfinite(v) for v in (psnr, ssim, obj)):
            fail(f"view {i}: non-finite metric")

    with mock.patch.object(nerf_mod, "fused_render_level", _plain_render_level):
        rgb_plain, _, _ = render(views[0][0])
    diff = (outs[0][0] - rgb_plain).abs().max().item()
    print(f"  view 0 through the plain version: max rgb diff {diff:.3e} (tol {TOL_RENDER_RGB:g})")
    if not diff <= TOL_RENDER_RGB:
        fail("the kernel's render disagrees with the plain version's")
    return {"launches": launches, "seconds_per_view": seconds / len(views)}


def _bwd_bytes(R: int, S: int, saved_bytes: int = 4, P: int = 63, V: int = 27) -> float:
    """Bytes of the backward from saved: its inputs (the level's, the
    cotangents, saved at saved_bytes a value and raw) read once, the
    gradients written once; at encoded widths P / V."""
    return (4.0 * (R * S + R * 3 + R * V + R * S * P + _n_weights(P, V)  # level inputs
                   + R * 3 + R + R + R * S  # cotangents
                   + R * S * 4  # raw
                   + _n_weights(P, V))  # gradients
            + saved_bytes * R * S * SAVED_FLOATS)


def _bwd_bound_ms(R: int, S: int) -> tuple:
    """The backward's bound with every product at the fp32 peak of the CUDA
    cores."""
    flops = 2.0 * (R * S * BWD_MACS_PER_SAMPLE + R * 27 * 128) + R * S * INTEGRATOR_FLOPS_PER_SAMPLE
    return _bound(flops / PEAK_FP32_FLOPS * 1e3, _bwd_bytes(R, S) / PEAK_BYTES * 1e3)


def _bound(t_ops: float, t_bytes: float) -> tuple:
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bwd_pass_bounds(R: int, S: int) -> dict:
    """Each pass of K2 as its own function (its scratch counted as its
    inputs and outputs): (bound ms, what bounds it), the products at the
    peak of the unit that runs them: B1's and B2's products in 3xTF32 (3
    TF32 products each) on the tensor cores, the integrator and the narrow
    head products on the fp32 cores."""
    rows = R * S
    ms = 1e3
    fp32 = lambda macs: 2.0 * macs / PEAK_FP32_FLOPS * ms  # noqa: E731
    tc = lambda macs: 3 * 2.0 * macs / PEAK_TF32_FLOPS * ms  # noqa: E731
    hbm = lambda floats: 4.0 * floats / PEAK_BYTES * ms  # noqa: E731
    return {
        "integrator": _bound(rows * INTEGRATOR_FLOPS_PER_SAMPLE / PEAK_FP32_FLOPS * ms,
                             hbm(rows * 4 + rows + R * 3 + R * 5 + rows + rows * 4)),
        "B1": _bound(tc(rows * B1_TC_MACS) + fp32(rows * B1_FP32_MACS + R * 27 * 128),
                     hbm(rows * (B1_SAVED_FLOATS + SAVED_FLOATS + 4) + R * 27 + N_WEIGHTS + (R // 16) * NARROW_FLOATS)),
        "B2": _bound(tc(rows * B2_TC_MACS),
                     hbm(rows * (SAVED_FLOATS - 128 + 63 + SAVED_FLOATS) + K2_RANGES * N_WEIGHTS)),
        "reduce": _bound(0.0, hbm(K2_RANGES * N_WEIGHTS + (R // 16) * NARROW_FLOATS + N_WEIGHTS)),
    }


def _bwd_bound_3xtf32_ms(R: int, S: int, P: int = 63, V: int = 27) -> tuple:
    """The backward's bound with the arithmetic it does: B1 and B2 in 3xTF32
    on the tensor cores, the integrator and the narrow products on the fp32
    cores, against the bytes of the function's own inputs and outputs; at
    encoded widths P / V."""
    t_ops = ((2.0 * (R * S * B1_FP32_MACS + R * V * 128) + R * S * INTEGRATOR_FLOPS_PER_SAMPLE) / PEAK_FP32_FLOPS
             + 3 * 2.0 * R * S * (B1_TC_MACS + B2_TC_MACS + _macs(P) - MACS_PER_SAMPLE) / PEAK_TF32_FLOPS) * 1e3
    return _bound(t_ops, _bwd_bytes(R, S, P=P, V=V) / PEAK_BYTES * 1e3)


def _kernel_ms(fn, iters: int) -> dict:
    """Device ms per call of fn() by kernel name (torch.profiler), after one
    untimed call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: _dev_us(e) / 1e3 / iters for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and _dev_us(e) > 0}


def _dev_us(event) -> float:
    """A profiler event's own device time, in microseconds."""
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)


def _bwd_pass_ms(fn, iters: int, passes: dict = K2_PASSES) -> dict:
    """Device ms per call of each of K2's passes."""
    by_name = _kernel_ms(fn, iters)
    out = {}
    for kernel, name in passes.items():
        hits = [v for k, v in by_name.items() if kernel in k]
        if not hits:
            fail(f"K2 pass {name} ({kernel}) not in the profile: {sorted(by_name)}")
        out[name] = sum(hits)
    return out


class _FixedDraws:
    """Draws that hand out given arrays, in the order the step asks."""

    def __init__(self, uniform, exponential):
        self._u, self._e = uniform, exponential

    def uniform(self, shape):
        assert tuple(shape) == tuple(self._u.shape)
        return self._u

    def exponential(self, shape):
        assert tuple(shape) == tuple(self._e.shape)
        return self._e


def _grad_errors(got, want64, names):
    """Per gradient: max |got - want64| / max |want64|."""
    return {n: ((got[n].double() - want64[n]).abs().max() / want64[n].abs().max().clamp_min(1e-300)).item()
            for n in names}


def _check_grads(what, k64, p32):
    """The stated K2 criterion, one limit per gradient; returns the largest
    ratio of a gradient's error to its limit."""
    tol = {n: max(TOL_GRAD, TOL_GRAD_FACTOR * p32[n]) for n in k64}
    ratio = {n: k64[n] / tol[n] for n in k64}
    worst = max(ratio, key=ratio.get)
    print(f"  {what}: kernel vs fp64 plain, closest to its limit: {worst} {k64[worst]:.3e} of {tol[worst]:.3e} "
          f"(fp32 plain {p32[worst]:.3e}); limits from {min(tol.values()):.1e} to {max(tol.values()):.1e}")
    bad = {n: (k64[n], tol[n]) for n in k64 if not ratio[n] <= 1.0}
    if bad:
        fail(f"{what}: K2 gradients off their fp64 plain version beyond their limits (err, limit): {bad}")
    return ratio[worst]


def _train_levels(nerf, boxes, focal, R=R_TRAIN, seed=SEED + 200, dot_bf16=False):
    """The train step's level inputs at R rays of one view: (o, d,
    [(kernel params, t, venc, xenc)] for the coarse (S=65) and the fine
    (S=193) level), the fine t-values from the coarse weights (K1 in the mode
    dot_bf16 says), encoded at the NeRF's degrees."""
    from aonerf_torch.ops import encoding, sampling
    from aonerf_torch.ops.kernels import fused_render as fr

    dev = torch.device("cuda")
    rays, _, _ = _view(np.random.default_rng(seed), boxes, focal)
    pick = np.random.default_rng(seed + 1).choice(H * W, R, replace=False)
    o, d = (torch.from_numpy(rays[k][pick]).to(dev) for k in ("rays_o", "rays_d"))
    mlp = nerf.coarse_mlp
    venc = encoding.pos_enc(d, 0, mlp.deg_view)
    with torch.no_grad():
        kp_c, kp_f = fr.kernel_params(nerf.coarse_mlp), fr.kernel_params(nerf.fine_mlp)
    t_c, pts = sampling.sample_along_rays(o, d, 64, 2.0, 6.0, False, False)
    t_c = t_c.contiguous()
    xenc_c = encoding.pos_enc(pts, mlp.min_deg_point, mlp.max_deg_point)
    _, _, _, w_c = fr.fused_render_level(kp_c, t_c, o, d, venc, xenc_c, True, dot_bf16=dot_bf16)
    t_f, pts_f = sampling.sample_pdf(0.5 * (t_c[:, 1:] + t_c[:, :-1]), w_c[:, 1:-1], o, d, t_c, 128, False)
    t_f = t_f.contiguous()
    xenc_f = encoding.pos_enc(pts_f, mlp.min_deg_point, mlp.max_deg_point)
    return o, d, [(kp_c, t_c, venc, xenc_c), (kp_f, t_f, venc, xenc_f)]


def phase_spill(nerf, boxes, focal) -> dict:
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    R = R_TRAIN
    o, d, lvls = _train_levels(nerf, boxes, focal)
    levels = []
    for kp, t, venc, xenc in lvls:
        S = t.shape[1]
        args = (kp, t, o, d, venc, xenc)
        errs, saved_ratio = {}, None
        for white in (True, False):
            k1 = fr.fused_render_level(*args, white)
            got = ft.fused_level_fwd_spill(*args, white)
            again = ft.fused_level_fwd_spill(*args, white)
            torch.cuda.synchronize()
            for name, g, w in zip(("comp", "acc", "depth", "weights"), got, k1):
                if not torch.equal(g, w):
                    fail(f"K1s S={S} white={white}: {name} differs from K1's, max abs "
                         f"{(g - w).abs().max().item():.3e}")
            for name, g, a in zip(("comp", "acc", "depth", "weights", "saved", "raw"), got, again):
                if not torch.equal(g, a):
                    fail(f"K1s S={S} white={white}: a repeat call gave other bits on {name}")
            del k1, again
            want = ft.fused_level_fwd_spill_ref(*args, white)
            for name, g, w in zip(("saved", "raw"), got[4:], want[4:]):
                if not torch.isfinite(g).all():
                    fail(f"K1s S={S} white={white}: non-finite {name}")
                errs[name] = max(errs.get(name, 0.0), (g - w).abs().max().item())
            if saved_ratio is None:  # the MLP's activations do not depend on the background
                saved_ratio = saved_fp64_check(args, got[4], want[4])
            del got, want
        tile = ft.fwd_tiles[(R, S, False)]
        print(f"kernel fused_level_fwd_spill S={S} at {R} rays, ray tile {tile} "
              f"(K1's {fr.launch_tiles[(R, S, False)]}): "
              "comp/acc/depth/weights equal to K1's bit for bit, both "
              "backgrounds; a repeat call gives the same bits; max abs err against the plain version "
              + ", ".join(f"{k} {v:.3e} (tol {TOL[k]:g})" for k, v in errs.items()))
        bad = [k for k, v in errs.items() if not v <= TOL[k]]
        if bad:
            fail(f"K1s S={S} disagrees with its plain version on {bad}")
        k1s = lambda: ft.fused_level_fwd_spill(*args, True)  # noqa: E731
        k1 = lambda: fr.fused_render_level(*args, True)  # noqa: E731
        iters = 10 if S > 100 else 20
        k1_ms = cuda_ms(k1, warmup=2, iters=iters)
        ms = cuda_ms(k1s, warmup=2, iters=iters)
        ms_again = cuda_ms(k1s, warmup=0, iters=iters)
        k1_again = cuda_ms(k1, warmup=0, iters=iters)
        plain_ms = cuda_ms(lambda: ft.fused_level_fwd_spill_ref(*args, True), warmup=1, iters=3)
        bounds = _fwd_bounds(S, R, spill=True)
        (bound, bound_by), bound32 = bounds["3xtf32"], bounds["fp32"][0]
        print(f"  S={S}: K1s {ms:.3f} / {ms_again:.3f} ms, K1 {k1_ms:.3f} / {k1_again:.3f} ms (in turns: K1, "
              f"K1s, K1s, K1); plain {plain_ms:.3f} ms; K1s bound {bound:.3f} ms ({bound_by}; K1's "
              f"operations, the products 3xTF32; {4.0 * R * S * (SAVED_FLOATS + 4) / 1e9:.3f} GB of spill at "
              f"3.35 TB/s {4e3 * R * S * (SAVED_FLOATS + 4) / PEAK_BYTES:.3f} ms), {bound32:.3f} ms in fp32; "
              f"K1 bound {_fwd_bounds(S, R)['3xtf32'][0]:.3f} ms, {_fwd_bounds(S, R)['fp32'][0]:.3f} in fp32")
        levels.append({"S": S, "ray_tile": tile, "ms": ms, "ms_again": ms_again, "k1_ms": k1_ms,
                       "k1_ms_again": k1_again,
                       "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, "bound_ms_fp32": bound32,
                       "max_abs_err": max(errs.values()), "errs": errs, "saved_rms_err_over_fp32": saved_ratio})
    kp, _, venc, _ = lvls[0]
    wrap_check(kp, o, d, venc)
    return {"levels": levels}


def wrap_check(kp, o, d, venc) -> None:
    """K1s and K1 at S = 7 on the coarse level's rays: a block's 112 rows are
    two chunks, the last of 48 rows, and its weight stream of 2 x 152 slices
    ends mid-ring (5 stages). K1s' outputs equal to K1's bit for bit, both
    within TOL of the plain version, a repeat call's bits."""
    from aonerf_torch.ops import encoding, sampling
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    t, pts = sampling.sample_along_rays(o, d, 6, 2.0, 6.0, False, False)
    args = (kp, t.contiguous(), o, d, venc, encoding.pos_enc(pts, 0, 10))
    S = args[1].shape[1]
    errs = {}
    for white in (True, False):
        k1 = fr.fused_render_level(*args, white)
        got = ft.fused_level_fwd_spill(*args, white)
        again = ft.fused_level_fwd_spill(*args, white)
        torch.cuda.synchronize()
        want = ft.fused_level_fwd_spill_ref(*args, white)
        for i, name in enumerate(("comp", "acc", "depth", "weights", "saved", "raw")):
            if not torch.isfinite(got[i]).all():
                fail(f"K1s S={S} white={white}: non-finite {name}")
            if i < 4 and not torch.equal(got[i], k1[i]):
                fail(f"K1s S={S} white={white}: {name} differs from K1's")
            if not torch.equal(got[i], again[i]):
                fail(f"K1s S={S} white={white}: a repeat call gave other bits on {name}")
            errs[name] = max(errs.get(name, 0.0), (got[i] - want[i]).abs().max().item())
    print(f"kernel fused_level_fwd_spill S={S} (the weight stream ends mid-ring): equal to K1's bit for bit, both "
          "backgrounds; a repeat call gives the same bits; max abs err against the plain version "
          + ", ".join(f"{k} {v:.3e} (tol {TOL[k]:g})" for k, v in errs.items()))
    bad = [k for k, v in errs.items() if not v <= TOL[k]]
    if bad:
        fail(f"K1s S={S} disagrees with its plain version on {bad}")


def phase_backward(nerf, boxes, focal) -> dict:
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    dev = torch.device("cuda")
    R = R_TRAIN
    o, d, lvls = _train_levels(nerf, boxes, focal)
    names = fr.WEIGHT_NAMES
    levels = []
    for kp, t, venc, xenc in lvls:
        S = t.shape[1]
        rng = np.random.default_rng(SEED + 300 + S)
        cot = tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            rng.standard_normal((R, 3)), rng.standard_normal(R), 0.1 * rng.standard_normal(R),
            rng.standard_normal((R, S))))
        args = (kp, t, o, d, venc, xenc)
        kp64 = {n: v.double() for n, v in kp.items()}
        args64 = (kp64, *(a.double() for a in (t, o, d, venc, xenc)))
        worst_abs, worst_ratio = 0.0, 0.0
        for white in (True, False):
            got = ft.fused_level_bwd(*args, *cot, white)
            *_, saved, raw = ft.fused_level_fwd_spill(*args, white)
            split = ft.fused_level_bwd_saved(*args, saved, raw, *cot, white)
            torch.cuda.synchronize()
            del saved, raw
            for n in names:
                if not torch.isfinite(got[n]).all():
                    fail(f"K2 S={S} white={white}: non-finite gradient {n}")
                if not torch.equal(split[n], got[n]):
                    fail(f"K2 S={S} white={white}: the backward from K1s' saved differs from the composition on {n}")
            del split
            p32 = ft.fused_level_bwd_ref(*args, *cot, white)
            p64 = ft.fused_level_bwd_ref(*args64, *(c.double() for c in cot), white)
            e_k, e_p = _grad_errors(got, p64, names), _grad_errors(p32, p64, names)
            e_kp = _grad_errors(got, {n: v.double() for n, v in p32.items()}, names)
            worst_abs = max(worst_abs, max((got[n] - p32[n]).abs().max().item() for n in names))
            print(f"kernel fused_level_bwd S={S} white={white}: kernel vs fp32 plain, max abs err / max |plain| "
                  + ", ".join(f"{n} {e_kp[n]:.1e}" for n in names))
            worst_ratio = max(worst_ratio, _check_grads(f"S={S} white={white}", e_k, e_p))
            del p32, p64
        again = ft.fused_level_bwd(*args, *cot, True)
        if not all(torch.equal(again[n], ft.fused_level_bwd(*args, *cot, True)[n]) for n in names):
            fail(f"K2 S={S}: a repeat call gave other bits")
        del again
        *_, saved, raw = ft.fused_level_fwd_spill(*args, True)
        k2 = lambda: ft.fused_level_bwd_saved(*args, saved, raw, *cot, True)  # noqa: E731
        plain = lambda: ft.fused_level_bwd_saved_ref(*args, saved, raw, *cot, True)  # noqa: E731
        plain_ms = cuda_ms(plain, warmup=1, iters=3)
        ms = cuda_ms(k2, warmup=2, iters=5 if S > 100 else 10)
        ms_again = cuda_ms(k2, warmup=0, iters=5 if S > 100 else 10)
        plain_again = cuda_ms(plain, warmup=0, iters=3)
        parts = _bwd_pass_ms(k2, iters=3)
        got, delta = backward_with_deltas(args, saved, raw, cot, True, False)
        b2_ops = b2_operands(saved, xenc.reshape(-1, xenc.shape[-1]), delta)
        b2_rel, b2_err = b2_errors(got, b2_ops, delta, False)
        del got
        if not b2_rel <= B2_FP32_TOL:
            fail(f"B2 fp32 S={S}: off the fp64 product of its own operands by {b2_rel:.3e} (limit {B2_FP32_TOL:g})")
        b2_library, b2_library_kind = b2_library_ms(b2_ops, False)
        b2_plain_ms = cuda_ms(lambda: b2_plain(b2_ops, delta, False), warmup=1, iters=3)
        del saved, raw, delta, b2_ops
        bound32, _ = _bwd_bound_ms(R, S)
        bound, bound_by = _bwd_bound_3xtf32_ms(R, S)
        pass_bounds = _bwd_pass_bounds(R, S)
        tflop = 2.0 * (R * S * BWD_MACS_PER_SAMPLE + R * 27 * 128) / 1e12
        print(f"  S={S}: K2 (the backward from saved) {ms:.3f} / {ms_again:.3f} ms, plain {plain_ms:.3f} / "
              f"{plain_again:.3f} ms (in turns: plain, K2, K2, plain); bound {bound:.3f} ms ({bound_by}; B1/B2 "
              f"3xTF32, the rest fp32), {bound32:.3f} ms with every product at 67 TFLOP/s fp32 ({tflop:.4f} TFLOP)")
        print(f"  S={S}: K2 by pass (torch.profiler, device ms per call; bound, what bounds it): "
              + ", ".join(f"{n} {parts[n]:.3f} ({pass_bounds[n][0]:.3f}, {pass_bounds[n][1]})" for n in parts)
              + f"; B1 + B2 + reduce {parts['B1'] + parts['B2'] + parts['reduce']:.3f} ms, bound "
              f"{sum(pass_bounds[n][0] for n in ('B1', 'B2', 'reduce')):.3f} ms in 3xTF32, "
              f"{2.0 * R * S * (B1_TC_MACS + B1_FP32_MACS + B2_TC_MACS) / PEAK_FP32_FLOPS * 1e3:.3f} ms in fp32")
        print(f"  S={S}: B2's products as one {b2_library_kind} each (TF32 off), summed, {b2_library:.3f} ms; B2's "
              f"share of the plain version {b2_plain_ms:.3f} ms; B2 (level_bwd_dw_kernel) against the fp64 products "
              f"of its operands {b2_rel:.3e} of the largest entry (limit {B2_FP32_TOL:g}), max abs err against the "
              f"plain share {b2_err:.3e}")
        levels.append({"S": S, "ms": ms, "ms_again": ms_again, "plain_ms": plain_ms, "plain_ms_again": plain_again,
                       "b2_library_ms": b2_library, "b2_plain_ms": b2_plain_ms, "b2_fp64_rel_err": b2_rel,
                       "b2_max_abs_err": b2_err,
                       "bound_ms": bound, "bound_by": bound_by, "bound_ms_fp32": bound32,
                       "passes": {n: {"ms": parts[n], "bound_ms": pass_bounds[n][0], "bound_by": pass_bounds[n][1]}
                                  for n in parts},
                       "max_abs_err": worst_abs, "err_over_limit": worst_ratio})
    two_level_check(nerf, o, d)
    return {"levels": levels}


class _PlainLevel(torch.autograd.Function):
    """One level through the plain versions: K1's forward, K2's backward."""

    @staticmethod
    def forward(ctx, t, o, d, venc, xenc, white, dot_bf16, *weights):
        from aonerf_torch.ops.kernels import fused_render as fr

        ctx.save_for_backward(t, o, d, venc, xenc, *weights)
        ctx.white, ctx.dot_bf16 = white, dot_bf16
        return fr.fused_render_level_ref(dict(zip(fr.WEIGHT_NAMES, weights)), t, o, d, venc, xenc, white,
                                         dot_bf16=dot_bf16)

    @staticmethod
    def backward(ctx, gc, ga, gd, gw):
        from aonerf_torch.ops.kernels import fused_render as fr
        from aonerf_torch.ops.kernels import fused_train as ft

        t, o, d, venc, xenc, *weights = ctx.saved_tensors
        g = ft.fused_level_bwd_ref(dict(zip(fr.WEIGHT_NAMES, weights)), t, o, d, venc, xenc,
                                   gc, ga, gd, gw, ctx.white, dot_bf16=ctx.dot_bf16)
        return (None,) * 7 + tuple(g[n] for n in fr.WEIGHT_NAMES)


def _plain_level(kp, t, o, d, venc, xenc, white, dot_bf16=False):
    from aonerf_torch.ops.kernels import fused_render as fr

    return _PlainLevel.apply(t, o, d, venc, xenc, white, dot_bf16, *[kp[n] for n in fr.WEIGHT_NAMES])


def two_level_check(nerf, o, d) -> None:
    """MSE(coarse) + MSE(fine) backward, randomized, through the kernels
    against the same through the plain versions (fp32 and fp64)."""
    import copy

    from aonerf_torch.ops.kernels import fused_train as ft
    from aonerf_torch.utils.bridge import nerf_flax_tree

    R = o.shape[0]
    rng = np.random.default_rng(SEED + 400)
    u = torch.from_numpy(rng.uniform(size=(R, 65)).astype(np.float32)).cuda()
    e = torch.from_numpy(rng.exponential(size=(R, 129)).astype(np.float32)).cuda()
    target = torch.from_numpy(rng.uniform(size=(R, 3)).astype(np.float32)).cuda()
    rays = {"rays_o": o, "rays_d": d, "viewdirs": d}

    def run(model, level, dtype):
        model.zero_grad(set_to_none=True)
        r = {k: v.to(dtype) for k, v in rays.items()}
        out = ft.fused_nerf_forward(model.coarse_mlp, model.fine_mlp, r, True, True, 2.0, 6.0, 64, 128,
                                    draws=_FixedDraws(u.to(dtype), e.to(dtype)), level=level)
        loss = sum(torch.mean((lvl[0] - target.to(dtype)) ** 2) for lvl in out)
        loss.backward()
        tree = nerf_flax_tree(model, grads=True)["params"]
        flat = {f"{m}/{layer}/{a}": torch.from_numpy(tree[m][layer][a]) for m in tree for layer in tree[m]
                for a in tree[m][layer]}
        return loss.item(), flat

    nerf.train()
    loss_k, g_k = run(nerf, ft.fused_level, torch.float32)
    loss_p, g_p = run(nerf, _plain_level, torch.float32)
    nerf64 = copy.deepcopy(nerf).double()
    loss_64, g_64 = run(nerf64, _plain_level, torch.float64)
    nerf.zero_grad(set_to_none=True)
    del nerf64
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"two-level loss backward at {R} rays, randomized: loss kernels {loss_k:.8f}, plain {loss_p:.8f} "
          f"(rel diff {rel:.2e}, tol {TOL_LOSS:g}), plain fp64 {loss_64:.8f}")
    if not rel <= TOL_LOSS:
        fail("two-level loss through the kernels disagrees with the plain versions'")
    names = list(g_64)
    _check_grads("two-level grads", _grad_errors(g_k, g_64, names), _grad_errors(g_p, g_64, names))


def _train_config(root: str, out: str) -> str:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", "vanilla.json")) as f:
        cfg = json.load(f)
    cfg.update({
        "root_dir": root, "output_path": out, "exp_name": "smoke", "img_wh": [W, H],
        "lr_init": 1e-3, "lr_delay_steps": 0, "val_every_steps": TRAIN_STEPS,
        "ckpt_every_steps": TRAIN_STEPS, "limit_val_batches": 1, "seed": SEED,
    })
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "train.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def profile_train_steps(trainer, buffers, seed):
    """Device time by kernel over one multi-step, from torch.profiler;
    returns (device busy ms a step, the profile)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.state, _ = trainer.step_fn(trainer.state, buffers, seed)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    n = trainer._inner_steps
    dev_us = _dev_us
    # kernels only: an op that launches through ctypes (FusedLevel) is also
    # credited with its kernel's time, which would count it twice
    kernels = (e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    events = sorted((e for e in kernels if dev_us(e) > 0), key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    print(f"  profile of {n} steps (torch.profiler): kernels busy {busy_ms / n:.3f} ms of {wall_ms / n:.3f} ms "
          f"a step ({100 * busy_ms / wall_ms:.1f}%; the wall time includes the profiler's overhead); "
          f"{len(events)} kernels, by device time:")
    for e in events[:12]:
        print(f"    {dev_us(e) / 1e3 / n:9.3f} ms/step {100 * dev_us(e) / 1e3 / busy_ms:5.1f}%  "
              f"x{e.count / n:g}/step  {e.key[:90]}")
    return busy_ms / n, prof


def print_top_ops(prof, n_steps: int, step_ms: float, busy_ms: float) -> None:
    """The profile's device time by the torch op that launched it (each
    op's own kernels), and the device's idle share of an unprofiled step."""
    ops = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU and _dev_us(e) > 0]
    ops.sort(key=_dev_us, reverse=True)
    print(f"  device busy {busy_ms:.3f} ms of the unprofiled {step_ms:.3f} ms step: idle "
          f"{100 * max(0.0, 1 - busy_ms / step_ms):.1f}%; device time by op (torch.profiler, own kernels):")
    for e in ops[:12]:
        print(f"    {_dev_us(e) / 1e3 / n_steps:9.3f} ms/step {100 * _dev_us(e) / 1e3 / n_steps / busy_ms:5.1f}%  "
              f"x{e.count / n_steps:g}/step  {e.key[:60]}")


def phase_training(tmp: str) -> dict:
    from aonerf_torch.cli import train as cli
    from aonerf_torch.data.synthetic import generate_single_scene
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft
    from aonerf_torch.train import step as step_mod
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    root = generate_single_scene(os.path.join(tmp, "scene"), img_wh=(W, H), n_train=8, n_val=1, n_test=N_TEST,
                                 seed=SEED)
    cfg_path = _train_config(root, os.path.join(tmp, "out"))
    cfg = load_config(cfg_path)
    n_val_tiles = -(-W * H // cfg.chunk)
    losses = []
    real = step_mod.vanilla_loss_and_grads

    def recorded(*args, **kwargs):  # observes each step's loss, changes nothing
        out = real(*args, **kwargs)
        losses.append(out[0])
        return out

    runs = []
    for max_steps in (TRAIN_STEPS, TRAIN_STEPS + RESUME_STEPS):
        start = len(losses)
        torch.cuda.synchronize()
        fr.launches = ft.fwd_launches = ft.launches = 0
        t0 = time.perf_counter()
        with mock.patch.object(step_mod, "vanilla_loss_and_grads", recorded):
            metrics = cli.main(["--config", cfg_path, "--max_steps", str(max_steps)])
        torch.cuda.synchronize()
        runs.append({"seconds": time.perf_counter() - t0, "k1": fr.launches, "k1s": ft.fwd_launches,
                     "k2": ft.launches,
                     "steps": len(losses) - start, "metrics": metrics})
    run_dir = os.path.join(cfg.output_path, cfg.exp_name)
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    ckpts = sorted(n for n in os.listdir(os.path.join(run_dir, "ckpts")) if n.endswith(".pt"))
    grids = sorted(os.listdir(os.path.join(run_dir, "val_vis")))

    trainer = Trainer(cfg)  # restores the latest checkpoint
    resumed_at = trainer.state.step
    buffers = trainer.train_buffers()
    trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)  # first multi-step untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_timed = 2
    for _ in range(n_timed):
        trainer.state, m = trainer.step_fn(trainer.state, buffers, cfg.seed)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (n_timed * trainer._inner_steps)
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)
    torch.cuda.synchronize()
    peak_bytes = torch.cuda.max_memory_allocated()
    profile_train_steps(trainer, buffers, cfg.seed)
    trainer.close()

    loss = torch.stack(losses).cpu().numpy()
    first, run2 = runs
    print(f"training: {first['steps']} steps + resume {run2['steps']} steps at batch {cfg.batch_size}, "
          f"{cfg.num_coarse_samples}+{cfg.num_fine_samples} samples; loss first 5 {loss[:5].mean():.5f}, "
          f"last 5 {loss[TRAIN_STEPS - 5:TRAIN_STEPS].mean():.5f}; val psnr {first['metrics'].get('val_psnr')}")
    print(f"  launches, run 1: K1 {first['k1']} (expected 2 levels x {n_val_tiles} val tiles = {2 * n_val_tiles}), "
          f"K1s {first['k1s']} and K2 {first['k2']} (expected 2 levels x {TRAIN_STEPS} steps = {2 * TRAIN_STEPS} "
          f"each); resume: K1 {run2['k1']} (expected 0), K1s {run2['k1s']} and K2 {run2['k2']} (expected "
          f"{2 * RESUME_STEPS} each)")
    print(f"  checkpoints {ckpts}, val grids {grids}, metrics rows {len(rows)}; resumed at step {resumed_at}")
    print(f"  train step: {step_s * 1e3:.3f} ms = {cfg.batch_size / step_s:.1f} rays/s "
          f"(host clock over {n_timed * trainer._inner_steps} steps after the first {trainer._inner_steps}, "
          f"torch.cuda.synchronize at both ends); run 1 took {first['seconds']:.1f} s")
    print(f"  peak device memory over {trainer._inner_steps} steps (torch.cuda.max_memory_allocated): "
          f"{peak_bytes / 1e9:.3f} GB, of which {base_bytes / 1e9:.3f} GB held before the steps")
    if not np.isfinite(loss).all():
        fail("non-finite train loss")
    if not loss[TRAIN_STEPS - 5:TRAIN_STEPS].mean() < loss[:5].mean():
        fail("train loss did not fall over the first run")
    if first["steps"] != TRAIN_STEPS or run2["steps"] != RESUME_STEPS:
        fail(f"steps taken {first['steps']} and {run2['steps']}, expected {TRAIN_STEPS} and {RESUME_STEPS}")
    if (first["k1"], first["k1s"], first["k2"]) != (2 * n_val_tiles, 2 * TRAIN_STEPS, 2 * TRAIN_STEPS):
        fail("the training run did not launch K1, K1s and K2 as expected")
    if (run2["k1"], run2["k1s"], run2["k2"]) != (0, 2 * RESUME_STEPS, 2 * RESUME_STEPS):
        fail("the resumed run did not launch K1, K1s and K2 as expected")
    if ckpts[-2:] != [f"ckpt_{TRAIN_STEPS:08d}.pt", f"ckpt_{TRAIN_STEPS + RESUME_STEPS:08d}.pt"]:
        fail(f"checkpoints {ckpts}")
    resume_rows = [r for r in rows if r["step"] > TRAIN_STEPS]
    if not resume_rows or resume_rows[0]["step"] != TRAIN_STEPS + RESUME_STEPS or resumed_at != TRAIN_STEPS + RESUME_STEPS:
        fail("the resumed run did not continue from the saved step")
    if not grids:
        fail("no val grid written")
    return {"k1": first["k1"], "k1s": first["k1s"], "k2": first["k2"], "step_ms": step_s * 1e3,
            "rays_per_s": cfg.batch_size / step_s, "peak_gb": peak_bytes / 1e9, "cfg_path": cfg_path,
            "val_psnr": first["metrics"].get("val_psnr"), "root": root}


def phase_test(cfg_path: str, val_psnr: float) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from aonerf_torch.cli import train as cli
    from aonerf_torch.models import nerf as nerf_mod
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft
    from aonerf_torch.train import loop as loop_mod
    from aonerf_torch.utils.config import load_config

    os.environ.pop("AONERF_LPIPS_WEIGHTS", None)  # test() refuses LPIPS weights: LPIPS is not ported
    cfg = load_config(cfg_path, {"run_eval": True})
    n_tiles = -(-W * H // cfg.chunk)
    test_s, render_s = [], []
    real_test, real_factory = loop_mod.Trainer.test, loop_mod.make_image_renderer

    def timed_test(self):  # observes test() and each view's render, changes nothing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_test(self)
        torch.cuda.synchronize()
        test_s.append(time.perf_counter() - t0)
        return out

    def timed_factory(*args, **kwargs):
        render = real_factory(*args, **kwargs)

        def timed(rays):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render(rays)
            torch.cuda.synchronize()
            render_s.append(time.perf_counter() - t0)
            return out

        return timed

    with mock.patch.object(loop_mod.Trainer, "test", timed_test), \
            mock.patch.object(loop_mod, "make_image_renderer", timed_factory):
        torch.cuda.synchronize()
        fr.launches = ft.fwd_launches = ft.launches = 0
        fr.launch_tiles.clear()
        stats = cli.main(["--config", cfg_path, "--run_eval"])
        torch.cuda.synchronize()
        k1, k1s, k2 = fr.launches, ft.fwd_launches, ft.launches
        tiles = dict(fr.launch_tiles)

    run_dir = os.path.join(cfg.output_path, cfg.exp_name)
    render_dir = os.path.join(run_dir, cfg.render_name)
    with open(os.path.join(run_dir, "results.json")) as f:
        results = json.load(f)
    files = set(os.listdir(render_dir))
    expected = {f"{stem}{i:03d}.{ext}" for i in range(N_TEST)
                for stem, ext in (("image", "jpg"), ("depth", "png"), ("depth", "npy"), ("depth_raw", "png"),
                                  ("opacity", "png"))} | {"depth_raw.npz"}
    videos = files & {"video.gif", "video.mp4"}

    trainer = loop_mod.Trainer(cfg)  # restores the same checkpoint
    restored_at = trainer.state.step
    rays = trainer._view_rays(trainer.dataset.get_image(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rgb, acc, depth = trainer._renderer(rays)
        torch.cuda.synchronize()
    k1_us = sum(_dev_us(e) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and "fused_render_level_kernel" in e.key)
    same_depth = np.array_equal(depth.reshape(H, W).cpu().numpy(), np.load(os.path.join(render_dir, "depth000.npy")))
    with mock.patch.object(nerf_mod, "fused_render_level", _plain_render_level):
        rgb_plain, acc_plain, depth_plain = trainer._renderer(rays)
    diff = (rgb - rgb_plain).abs().max().item()
    # for information: an rgb that saturates at the white background agrees
    # bit for bit whatever the weights, acc and depth do not
    acc_diff, depth_diff = ((a - b).abs().max().item() for a, b in ((acc, acc_plain), (depth, depth_plain)))
    trainer.close()

    n_views = len(render_s)
    per_test, per_render = sum(test_s) / N_TEST, sum(render_s) / max(n_views, 1)
    k1_ms = k1_us / 1e3
    print(f"test: --run_eval restored step {restored_at}, {n_views} test views of {W}x{H} at chunk {cfg.chunk}; "
          f"K1 launches {k1} (expected 2 levels x {n_tiles} tiles x {N_TEST} views = {2 * n_tiles * N_TEST}), "
          f"K1s {k1s}, K2 {k2} (expected 0); K1's ray tiles (rays, samples) -> tile: "
          + ", ".join(f"({r}, {s_}) -> {t_}" for (r, s_, _), t_ in sorted(tiles.items())))
    print(f"  test psnr {results['psnr']['test']:.4f} dB, ssim {results['ssim']['test']:.5f}, object psnr "
          f"{results['psnr_obj']['test']:.4f} dB, lpips {results['lpips']['test']} (phase 7's val psnr at step "
          f"{TRAIN_STEPS}: {val_psnr})")
    print(f"  seconds per test view: test() {per_test:.4f} s ({sum(test_s):.3f} s for {N_TEST} views: render, "
          f"metrics, writers), render alone {per_render:.4f} s (views {', '.join(f'{x:.4f}' for x in render_s)}); "
          f"K1 {k1_ms:.3f} ms of device time a view (torch.profiler, view 0) = {100 * k1_ms / 1e3 / per_render:.1f}% "
          f"of the render, {100 * k1_ms / 1e3 / per_test:.1f}% of test()")
    print(f"  files under {cfg.render_name}/: {len(files)} ({sorted(videos)}); view 0 again through K1: depth "
          f"{'equal' if same_depth else 'NOT equal'} to depth000.npy bit for bit; through the plain version: max "
          f"rgb diff {diff:.3e} (tol {TOL_RENDER_RGB:g}), acc {acc_diff:.3e}, depth {depth_diff:.3e}, "
          f"mean acc {acc.mean().item():.4f}")
    if (k1, k1s, k2) != (2 * n_tiles * N_TEST, 0, 0):
        fail("the test run did not launch K1, K1s and K2 as expected")
    if restored_at != TRAIN_STEPS + RESUME_STEPS or n_views != N_TEST or len(test_s) != 1:
        fail(f"the test run restored step {restored_at} and rendered {n_views} views")
    for name in ("psnr", "ssim", "psnr_obj"):
        if list(results[name]) != ["test"] or not np.isfinite(results[name]["test"]):
            fail(f"results.json {name}: {results[name]}")
    if list(results["lpips"]) != ["test"] or not np.isnan(results["lpips"]["test"]):
        fail(f"results.json lpips: {results['lpips']}")
    if results != json.loads(json.dumps(stats)):
        fail("results.json differs from what test() returned")
    if not expected <= files or len(videos) != 1:
        fail(f"render directory: missing {sorted(expected - files)}, videos {sorted(videos)}")
    if not same_depth:
        fail("test() did not write the depth the kernel renders")
    if not diff <= TOL_RENDER_RGB:
        fail("the kernel's test render disagrees with the plain version's")
    if not k1_us > 0:
        fail("the profiler saw no K1 device time")
    return {"k1": k1, "seconds_per_view": per_test, "render_seconds_per_view": per_render, "k1_ms": k1_ms,
            "ray_tiles": {f"{r}x{s_}": t_ for (r, s_, _), t_ in tiles.items()}}


def _autodecoder_config(root: str, out: str) -> str:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", "autodecoder.json")) as f:
        cfg = json.load(f)
    cfg.update({
        "root_dir": root, "output_path": out, "exp_name": "smoke_ad", "img_wh": [W, H],
        "lr_init": 1e-3, "lr_delay_steps": 0, "val_every_steps": TRAIN_STEPS,
        "ckpt_every_steps": TRAIN_STEPS, "limit_val_batches": 1, "seed": SEED,
    })
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "autodecoder.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _fused_launches() -> tuple:
    """Launches of K1, K1s and K2, fp32 and bf16 mode together."""
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    return (fr.launches + fr.bf16_launches, ft.fwd_launches + ft.bf16_fwd_launches,
            ft.launches + ft.bf16_launches)


def _reset_fused_launches() -> None:
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    fr.launches = ft.fwd_launches = ft.launches = 0
    fr.bf16_launches = ft.bf16_fwd_launches = ft.bf16_launches = 0


def articulated_fp64_check(trainer) -> float:
    """The articulated field's deterministic two-level render of AD_RAYS
    rays of a train view, on the card against the same weights and codes on
    the CPU in fp64, each output held to max(TOL_AD, TOL_AD_FACTOR x the CPU
    fp32 render's error); returns the largest ratio of error to limit. The
    field has the seed's random weights and codes (the trained one is still
    nearly empty after 60 steps, and a white render hides the products)."""
    import copy

    from aonerf_torch.models.articulated import ArticulatedNeRF

    cfg = trainer.cfg
    g = torch.Generator().manual_seed(SEED)
    model = ArticulatedNeRF(num_coarse_samples=cfg.num_coarse_samples, num_fine_samples=cfg.num_fine_samples,
                            latent_dense=cfg.latent_dense, generator=g, device=trainer.device)
    dims = (("density", cfg.obj_code_dim), ("color", cfg.obj_code_dim), ("articulation", cfg.art_code_dim))
    latents = {k: 0.1 * torch.randn((1, c), generator=g) for k, c in dims}
    img = trainer.dataset.get_image(0, 0, 0)
    pix = np.random.default_rng(SEED).choice(W * H, AD_RAYS, replace=False)
    rays = {k: torch.from_numpy(img[k][pix]) for k in ("rays_o", "rays_d", "viewdirs")}
    near, far, white = trainer.near, trainer.far, cfg.white_back
    cpu32 = copy.deepcopy(model).cpu()
    with torch.no_grad():
        dev = trainer.device
        card = model({k: v.to(dev) for k, v in rays.items()}, False, white, near, far,
                     {k: v.to(dev) for k, v in latents.items()})[-1]
        got32 = cpu32(rays, False, white, near, far, latents)[-1]
        cpu64 = cpu32.double()
        want = cpu64({k: v.double() for k, v in rays.items()}, False, white, near, far,
                     {k: v.double() for k, v in latents.items()})[-1]
    ratios, parts = {}, []
    for name, c, p, w in zip(("rgb", "acc", "depth"), card, got32, want):
        e_card, e_cpu = ((x.cpu().double() - w).abs().max().item() for x in (c, p))
        limit = max(TOL_AD, TOL_AD_FACTOR * e_cpu)
        ratios[name] = e_card / limit
        parts.append(f"{name} {e_card:.3e} (CPU fp32 {e_cpu:.3e}; limit {limit:.3e})")
    print(f"  fp64 check on {AD_RAYS} rays of the seed's random field, card vs CPU fp64: " + ", ".join(parts)
          + f"; mean acc {want[1].mean().item():.4f}")
    bad = [n for n, r in ratios.items() if not r <= 1.0]
    if bad or not all(torch.isfinite(x).all() for x in card):
        fail(f"the articulated render on the card is off the CPU fp64 render beyond the fp32 limit on {bad}")
    return max(ratios.values())


def phase_autodecoder(tmp: str) -> dict:
    from aonerf_torch.cli import train as cli
    from aonerf_torch.data.sapien_multi import DEFAULT_VAL_DEGREES
    from aonerf_torch.data.synthetic import generate_multi_scene
    from aonerf_torch.train import step as step_mod
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    t0 = time.perf_counter()
    root = generate_multi_scene(os.path.join(tmp, "multi"), img_wh=(W, H), n_instances=2, n_images=4, seed=SEED,
                                val_degrees=DEFAULT_VAL_DEGREES, n_val_images=1)
    gen_s = time.perf_counter() - t0
    cfg_path = _autodecoder_config(root, os.path.join(tmp, "out"))
    cfg = load_config(cfg_path)
    losses = []
    real = step_mod.autodecoder_loss_and_grads

    def recorded(*args, **kwargs):  # observes each step's loss, changes nothing
        out = real(*args, **kwargs)
        losses.append(out[0])
        return out

    runs = []
    for max_steps in (TRAIN_STEPS, TRAIN_STEPS + RESUME_STEPS):
        start = len(losses)
        torch.cuda.synchronize()
        _reset_fused_launches()
        t0 = time.perf_counter()
        with mock.patch.object(step_mod, "autodecoder_loss_and_grads", recorded):
            metrics = cli.main(["--config", cfg_path, "--max_steps", str(max_steps)])
        torch.cuda.synchronize()
        runs.append({"seconds": time.perf_counter() - t0, "fused": _fused_launches(), "steps": len(losses) - start,
                     "metrics": metrics})
    run_dir = os.path.join(cfg.output_path, cfg.exp_name)
    ckpts = sorted(n for n in os.listdir(os.path.join(run_dir, "ckpts")) if n.endswith(".pt"))
    grids = sorted(os.listdir(os.path.join(run_dir, "val_vis")))

    trainer = Trainer(cfg)  # restores the latest checkpoint
    resumed_at = trainer.state.step
    held_out = trainer.val_dataset.uses_val_split
    buffers = trainer.train_buffers()
    buffer_gb = sum(v.numel() * v.element_size() for v in buffers.values()) / 1e9
    trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)  # first multi-step untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_timed = 2
    for _ in range(n_timed):
        trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (n_timed * trainer._inner_steps)
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)
    torch.cuda.synchronize()
    peak_bytes = torch.cuda.max_memory_allocated()
    busy_ms, prof = profile_train_steps(trainer, buffers, cfg.seed)
    print_top_ops(prof, trainer._inner_steps, step_s * 1e3, busy_ms)
    ratio = articulated_fp64_check(trainer)
    trainer.close()

    loss = torch.stack(losses).cpu().numpy()
    first, run2 = runs
    print(f"autodecoder: {first['steps']} steps + resume {run2['steps']} steps at batch {cfg.batch_size}, "
          f"{cfg.num_coarse_samples}+{cfg.num_fine_samples} samples, latent_dense {cfg.latent_dense}; scene of "
          f"{buffers['rgb'].shape[:3]} (instance, articulation, view) written in {gen_s:.1f} s, "
          f"{buffer_gb:.3f} GB on the card")
    print(f"  loss first 5 {loss[:5].mean():.5f}, last 5 {loss[TRAIN_STEPS - 5:TRAIN_STEPS].mean():.5f}; "
          f"val ({'held-out degrees' if held_out else 'train views'}) psnr {first['metrics'].get('val_psnr')}, "
          f"object psnr {first['metrics'].get('val_psnr_obj')}; K1, K1s, K2 launches {first['fused']} and "
          f"{run2['fused']} (expected 0)")
    print(f"  checkpoints {ckpts}, val grids {grids}; resumed at step {resumed_at}")
    print(f"  train step: {step_s * 1e3:.3f} ms = {cfg.batch_size / step_s:.1f} rays/s (host clock over "
          f"{n_timed * trainer._inner_steps} steps after the first {trainer._inner_steps}, torch.cuda.synchronize "
          f"at both ends); run 1 took {first['seconds']:.1f} s, the resume {run2['seconds']:.1f} s")
    print(f"  peak device memory over {trainer._inner_steps} steps (torch.cuda.max_memory_allocated): "
          f"{peak_bytes / 1e9:.3f} GB, of which {base_bytes / 1e9:.3f} GB held before the steps")
    if not np.isfinite(loss).all():
        fail("non-finite auto-decoder loss")
    if not loss[TRAIN_STEPS - 5:TRAIN_STEPS].mean() < loss[:5].mean():
        fail("the auto-decoder loss did not fall over the first run")
    if first["steps"] != TRAIN_STEPS or run2["steps"] != RESUME_STEPS:
        fail(f"steps taken {first['steps']} and {run2['steps']}, expected {TRAIN_STEPS} and {RESUME_STEPS}")
    if first["fused"] != (0, 0, 0) or run2["fused"] != (0, 0, 0):
        fail("the articulated path launched a fused level kernel")
    if ckpts[-2:] != [f"ckpt_{TRAIN_STEPS:08d}.pt", f"ckpt_{TRAIN_STEPS + RESUME_STEPS:08d}.pt"]:
        fail(f"checkpoints {ckpts}")
    if resumed_at != TRAIN_STEPS + RESUME_STEPS or not held_out or not grids:
        fail(f"resumed at {resumed_at}, held-out val {held_out}, val grids {grids}")
    if not all(np.isfinite(first["metrics"].get(k, np.nan)) for k in ("val_psnr", "val_psnr_obj")):
        fail(f"validation metrics {first['metrics']}")
    return {"cfg_path": cfg_path, "step_ms": step_s * 1e3, "rays_per_s": cfg.batch_size / step_s,
            "peak_gb": peak_bytes / 1e9, "fp64_ratio": ratio}


def phase_articulated_test(cfg_path: str) -> dict:
    from aonerf_torch.cli import train as cli
    from aonerf_torch.train import loop as loop_mod
    from aonerf_torch.utils.config import load_config

    os.environ.pop("AONERF_LPIPS_WEIGHTS", None)  # test() refuses LPIPS weights: LPIPS is not ported
    cfg = load_config(cfg_path, {"run_eval": True})
    n_views = cfg.test_sweep_poses
    test_s, render_s = [], []
    real_test, real_factory = loop_mod.Trainer.test, loop_mod.make_image_renderer

    def timed_test(self):  # observes test() and each view's render, changes nothing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_test(self)
        torch.cuda.synchronize()
        test_s.append(time.perf_counter() - t0)
        return out

    def timed_factory(*args, **kwargs):
        render = real_factory(*args, **kwargs)

        def timed(rays, *latents):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render(rays, *latents)
            torch.cuda.synchronize()
            render_s.append(time.perf_counter() - t0)
            return out

        return timed

    with mock.patch.object(loop_mod.Trainer, "test", timed_test), \
            mock.patch.object(loop_mod, "make_image_renderer", timed_factory):
        _reset_fused_launches()
        stats = cli.main(["--config", cfg_path, "--run_eval"])
        fused = _fused_launches()
    run_dir = os.path.join(cfg.output_path, cfg.exp_name)
    render_dir = os.path.join(run_dir, cfg.render_name)
    with open(os.path.join(run_dir, "results.json")) as f:
        results = json.load(f)
    files = set(os.listdir(render_dir))
    expected = {f"{stem}{i:03d}.{ext}" for i in range(n_views)
                for stem, ext in (("image", "jpg"), ("depth", "png"), ("depth", "npy"), ("depth_raw", "png"),
                                  ("opacity", "png"))} | {"depth_raw.npz"}
    videos = files & {"video.gif", "video.mp4"}
    per_test, per_render = sum(test_s) / n_views, sum(render_s) / max(len(render_s), 1)
    print(f"articulated test: --run_eval, {len(render_s)} poses of the interpolated sweep of instance "
          f"{cfg.render_instance} at {W}x{H}, chunk {cfg.chunk}; K1, K1s, K2 launches {fused} (expected 0)")
    print(f"  test psnr {results['psnr']['test']:.4f} dB, ssim {results['ssim']['test']:.5f}, object psnr "
          f"{results['psnr_obj']['test']:.4f} dB, lpips {results['lpips']['test']}")
    print(f"  seconds per view: test() {per_test:.4f} s ({sum(test_s):.3f} s for {n_views} views: render, metrics, "
          f"writers), render alone {per_render:.4f} s (views {min(render_s):.4f}-{max(render_s):.4f} s); files "
          f"under {cfg.render_name}/: {len(files)} ({sorted(videos)})")
    if fused != (0, 0, 0):
        fail("the articulated test launched a fused level kernel")
    if len(render_s) != n_views or len(test_s) != 1:
        fail(f"the articulated test rendered {len(render_s)} views, expected {n_views}")
    for name in ("psnr", "ssim", "psnr_obj"):
        if list(results[name]) != ["test"] or not np.isfinite(results[name]["test"]):
            fail(f"results.json {name}: {results[name]}")
    if results != json.loads(json.dumps(stats)):
        fail("results.json differs from what test() returned")
    if not expected <= files or len(videos) != 1:
        fail(f"render directory: missing {sorted(expected - files)}, videos {sorted(videos)}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cli.main(["--config", cfg_path, "--run_optimize", "--optimize_steps", str(OPTIMIZE_STEPS),
                    "--batch_size", str(OPTIMIZE_BATCH)])
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    history = out.get("psnr1", [])
    saved = os.path.join(run_dir, "optimized_codes.npz")
    print(f"  --run_optimize: {OPTIMIZE_STEPS} steps at batch {OPTIMIZE_BATCH} for instance {cfg.optimize_instance} "
          f"in {opt_s:.2f} s (the call, restore included); psnr1 history {history}")
    if len(history) != -(-OPTIMIZE_STEPS // 50) or not np.isfinite(history).all() or not os.path.exists(saved):
        fail(f"code optimization: psnr1 {history}, codes written {os.path.exists(saved)}")
    return {"seconds_per_view": per_test, "render_seconds_per_view": per_render, "optimize_s": opt_s}


def _ae_config(root: str, out: str) -> str:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", "ae_art.json")) as f:
        cfg = json.load(f)
    cfg.update({
        "root_dir": root, "output_path": out, "exp_name": "smoke_ae", "img_wh": [W, H],
        "lr_delay_steps": 0, "val_every_steps": TRAIN_STEPS, "ckpt_every_steps": TRAIN_STEPS,
        "limit_val_batches": 1, "seed": SEED,
    })
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "ae.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def ae_fp64_check(trainer) -> float:
    """The auto-encoder's deterministic forward (encode a val view, predict
    the state, embed the view's angle, both levels on AE_RAYS of its rays)
    from the seed's random weights, on the card with cuDNN's process-wide
    TF32 flag ON against the same weights on the CPU in fp64; each output held
    to max(TOL_AE, TOL_AE_FACTOR x the CPU fp32 forward's error). Returns the
    largest ratio of error to limit."""
    import copy

    from aonerf_torch.models.ae import AutoEncoderArticulatedNeRF

    cfg = trainer.cfg
    model = AutoEncoderArticulatedNeRF(
        num_coarse_samples=cfg.num_coarse_samples, num_fine_samples=cfg.num_fine_samples,
        latent_dense=cfg.latent_dense, generator=torch.Generator().manual_seed(SEED), device=trainer.device)
    img = trainer.val_dataset.get_image(0, 0, 0)
    pix = np.random.default_rng(SEED).choice(W * H, AE_RAYS, replace=False)
    rays = {k: torch.from_numpy(img[k][pix]) for k in ("rays_o", "rays_d", "viewdirs")}
    src, deg = torch.from_numpy(img["src_imgs"])[None], torch.tensor(img["deg"])
    near, far, white = trainer.near, trainer.far, cfg.white_back

    def outputs(m, rays, src, dtype, dev):
        levels, latents, state = m({k: v.to(dev, dtype) for k, v in rays.items()}, src.to(dev, dtype), deg.to(dev),
                                   False, white, near, far)
        out = {f"code {k}": v for k, v in latents.items()}
        out["pred_state"] = state
        for i, (rgb, acc, depth) in enumerate(levels):
            out.update({f"L{i} rgb": rgb, f"L{i} acc": acc, f"L{i} depth": depth})
        return {k: v.detach().cpu().double() for k, v in out.items()}

    cpu32 = copy.deepcopy(model).cpu()
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            card = outputs(model, rays, src, torch.float32, trainer.device)
            flags_after = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    with torch.no_grad():
        got32 = outputs(cpu32, rays, src, torch.float32, "cpu")
        want = outputs(cpu32.double(), rays, src, torch.float64, "cpu")
    ratios, parts = {}, []
    for name, w in want.items():
        e_card, e_cpu = ((x[name] - w).abs().max().item() for x in (card, got32))
        limit = max(TOL_AE, TOL_AE_FACTOR * e_cpu)
        ratios[name] = e_card / limit
        parts.append(f"{name} {e_card:.3e} (CPU fp32 {e_cpu:.3e})")
    print(f"  fp64 check on {AE_RAYS} rays of a val view, the seed's random AE on the card with cudnn.allow_tf32 "
          f"ON ((cudnn, matmul) flags {flags_after} after the forward) vs CPU fp64, max abs error: "
          + ", ".join(parts) + f"; largest error/limit {max(ratios.values()):.3f}; mean acc "
          f"{want['L1 acc'].mean().item():.4f}")
    bad = [n for n, r in ratios.items() if not r <= 1.0]
    if bad or not all(torch.isfinite(x).all() for x in card.values()) or flags_after != (True, False):
        fail(f"the AE forward on the card is off the CPU fp64 forward beyond the fp32 limit on {bad}")
    return max(ratios.values())


def encoder_step_ms(trainer, buffers) -> float:
    """Device ms of the encoder's forward and backward on one source image,
    by CUDA events (10 calls after 3)."""
    from aonerf_torch import full_fp32

    model = trainer.model
    src = buffers["rgb"][0, 0, 0].to(torch.float32).reshape(H, W, 3).permute(2, 0, 1)[None] / 127.5 - 1.0

    def fwd_bwd():
        out = model.encode(src)
        with full_fp32():
            torch.autograd.grad(sum(v.sum() for v in out.values()), list(model.encoder.parameters()))

    return cuda_ms(fwd_bwd, 3, 10)


def phase_autoencoder(tmp: str) -> dict:
    from aonerf_torch.cli import train as cli
    from aonerf_torch.data.sapien_multi import DEFAULT_VAL_DEGREES
    from aonerf_torch.data.synthetic import generate_multi_scene
    from aonerf_torch.train import step_ae
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    root = os.path.join(tmp, "multi")
    if not os.path.isdir(root):  # phase 9's scene
        generate_multi_scene(root, img_wh=(W, H), n_instances=2, n_images=4, seed=SEED,
                             val_degrees=DEFAULT_VAL_DEGREES, n_val_images=1)
    cfg_path = _ae_config(root, os.path.join(tmp, "out"))
    cfg = load_config(cfg_path)
    parts = []
    real = step_ae.ae_loss_and_grads

    def recorded(*args, **kwargs):  # observes each step's loss parts, changes nothing
        out = real(*args, **kwargs)
        parts.append(torch.stack([out[0], *out[1]]))
        return out

    # the CLI as a user runs it: PyTorch's default flags (cuDNN TF32 on)
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        runs = []
        for max_steps in (TRAIN_STEPS, TRAIN_STEPS + RESUME_STEPS):
            start = len(parts)
            torch.cuda.synchronize()
            _reset_fused_launches()
            t0 = time.perf_counter()
            with mock.patch.object(step_ae, "ae_loss_and_grads", recorded):
                metrics = cli.main(["--config", cfg_path, "--max_steps", str(max_steps)])
            torch.cuda.synchronize()
            runs.append({"seconds": time.perf_counter() - t0, "fused": _fused_launches(),
                         "steps": len(parts) - start, "metrics": metrics})
        run_dir = os.path.join(cfg.output_path, cfg.exp_name)
        ckpts = sorted(n for n in os.listdir(os.path.join(run_dir, "ckpts")) if n.endswith(".pt"))

        trainer = Trainer(cfg)  # restores the latest checkpoint
        resumed_at = trainer.state.step
        buffers = trainer.train_buffers()
        trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)  # first multi-step untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_timed = 2
        for _ in range(n_timed):
            trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / (n_timed * trainer._inner_steps)
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)
        torch.cuda.synchronize()
        peak_bytes = torch.cuda.max_memory_allocated()
        busy_ms, prof = profile_train_steps(trainer, buffers, cfg.seed)
        print_top_ops(prof, trainer._inner_steps, step_s * 1e3, busy_ms)
        if not busy_ms > 0:
            fail("the profiler saw no device time in the auto-encoder step")
        conv_ms = sum(_dev_us(e) for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU
                      and "conv" in e.key) / 1e3  # every convolution op's own kernels, forward and backward
        conv_ms /= trainer._inner_steps
        enc_ms = encoder_step_ms(trainer, buffers)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags

    p = torch.stack(parts).cpu().numpy()  # loss, loss0, loss1, loss_state, loss_op a step
    loss = p[:, 0]
    first, run2 = runs
    val = {k: first["metrics"].get(f"val_{k}") for k in ("psnr", "psnr_obj", "state_error_rad",
                                                          "abs_state_error_deg")}
    print(f"autoencoder: {first['steps']} steps + resume {run2['steps']} steps at batch {cfg.batch_size}, "
          f"{cfg.num_coarse_samples}+{cfg.num_fine_samples} samples, a {W}x{H} source view a step, latent_dense "
          f"{cfg.latent_dense}, lr {cfg.lr_init} with no delay; cudnn.allow_tf32 True (PyTorch's default)")
    print(f"  loss first 5 {loss[:5].mean():.5f}, last 5 {loss[TRAIN_STEPS - 5:TRAIN_STEPS].mean():.5f}; "
          f"loss_state {p[:5, 3].mean():.5f} -> {p[TRAIN_STEPS - 5:TRAIN_STEPS, 3].mean():.5f}, opacity_loss "
          f"{p[:5, 4].mean():.5f} -> {p[TRAIN_STEPS - 5:TRAIN_STEPS, 4].mean():.5f} (first vs last 5); K1, K1s, "
          f"K2 launches {first['fused']} and {run2['fused']} (expected 0)")
    print(f"  val (held-out degrees, ground-truth angle): {val}")
    print(f"  checkpoints {ckpts}; resumed at step {resumed_at}")
    print(f"  train step: {step_s * 1e3:.3f} ms = {cfg.batch_size / step_s:.1f} rays/s (host clock over "
          f"{n_timed * trainer._inner_steps} steps after the first {trainer._inner_steps}, torch.cuda.synchronize "
          f"at both ends); run 1 took {first['seconds']:.1f} s, the resume {run2['seconds']:.1f} s")
    print(f"  peak device memory over {trainer._inner_steps} steps (torch.cuda.max_memory_allocated): "
          f"{peak_bytes / 1e9:.3f} GB, of which {base_bytes / 1e9:.3f} GB held before the steps")
    print(f"  the encoder's convolutions (every op named *conv*, own kernels): {conv_ms:.3f} ms a "
          f"step = {100 * conv_ms / busy_ms:.1f}% of device time; the encoder's forward + backward alone on one "
          f"{W}x{H} view: {enc_ms:.3f} ms (CUDA events) = {100 * enc_ms / (step_s * 1e3):.1f}% of the step")
    ratio = ae_fp64_check(trainer)
    trainer.close()
    if not np.isfinite(p).all():
        fail("non-finite auto-encoder loss")
    if not loss[TRAIN_STEPS - 5:TRAIN_STEPS].mean() < loss[:5].mean():
        fail("the auto-encoder loss did not fall over the first run")
    if first["steps"] != TRAIN_STEPS or run2["steps"] != RESUME_STEPS:
        fail(f"steps taken {first['steps']} and {run2['steps']}, expected {TRAIN_STEPS} and {RESUME_STEPS}")
    if first["fused"] != (0, 0, 0) or run2["fused"] != (0, 0, 0):
        fail("the auto-encoder path launched a fused level kernel")
    if ckpts[-2:] != [f"ckpt_{TRAIN_STEPS:08d}.pt", f"ckpt_{TRAIN_STEPS + RESUME_STEPS:08d}.pt"]:
        fail(f"checkpoints {ckpts}")
    if resumed_at != TRAIN_STEPS + RESUME_STEPS:
        fail(f"resumed at {resumed_at}")
    if not all(v is not None and np.isfinite(v) for v in val.values()):
        fail(f"validation metrics {first['metrics']}")
    return {"cfg_path": cfg_path, "step_ms": step_s * 1e3, "peak_gb": peak_bytes / 1e9, "fp64_ratio": ratio,
            "fused": tuple(a + b for a, b in zip(first["fused"], run2["fused"]))}


def phase_ae_test(cfg_path: str) -> dict:
    from aonerf_torch.cli import train as cli
    from aonerf_torch.train import loop as loop_mod
    from aonerf_torch.utils.config import load_config

    os.environ.pop("AONERF_LPIPS_WEIGHTS", None)  # test() refuses LPIPS weights: LPIPS is not ported
    cfg = load_config(cfg_path, {"run_eval": True})
    n_views = cfg.test_sweep_poses
    test_s, render_s, states = [], [], []
    real_test, real_factory, real_setup = loop_mod.Trainer.test, loop_mod.make_image_renderer, \
        loop_mod.Trainer._render_setup

    def timed_test(self):  # observes test() and each view's render, changes nothing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_test(self)
        torch.cuda.synchronize()
        test_s.append(time.perf_counter() - t0)
        return out

    def timed_factory(*args, **kwargs):
        render = real_factory(*args, **kwargs)

        def timed(rays, *latents):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render(rays, *latents)
            torch.cuda.synchronize()
            render_s.append(time.perf_counter() - t0)
            return out

        return timed

    def recorded_setup(self, img, is_test=False):  # observes the predicted states, changes nothing
        out = real_setup(self, img, is_test)
        states.append((is_test, out[1]))
        return out

    with mock.patch.object(loop_mod.Trainer, "test", timed_test), \
            mock.patch.object(loop_mod, "make_image_renderer", timed_factory), \
            mock.patch.object(loop_mod.Trainer, "_render_setup", recorded_setup):
        _reset_fused_launches()
        stats = cli.main(["--config", cfg_path, "--run_eval"])
        fused = _fused_launches()
    run_dir = os.path.join(cfg.output_path, cfg.exp_name)
    render_dir = os.path.join(run_dir, cfg.render_name)
    with open(os.path.join(run_dir, "results.json")) as f:
        results = json.load(f)
    files = set(os.listdir(render_dir))
    expected = {f"{stem}{i:03d}.{ext}" for i in range(n_views)
                for stem, ext in (("image", "jpg"), ("depth", "png"), ("depth", "npy"), ("depth_raw", "png"),
                                  ("opacity", "png"))} | {"depth_raw.npz"}
    videos = files & {"video.gif", "video.mp4"}
    per_test, per_render = sum(test_s) / n_views, sum(render_s) / max(len(render_s), 1)
    pred_deg = [round(float(np.rad2deg(s)), 2) for _, s in states]
    print(f"ae test: --run_eval, {len(render_s)} poses of the sweep of instance {cfg.render_instance} at {W}x{H}, "
          f"chunk {cfg.chunk}, each conditioned on the angle predicted from its source view; K1, K1s, K2 launches "
          f"{fused} (expected 0)")
    print(f"  predicted angles (degrees): {pred_deg}")
    print(f"  test psnr {results['psnr']['test']:.4f} dB, ssim {results['ssim']['test']:.5f}, object psnr "
          f"{results['psnr_obj']['test']:.4f} dB, lpips {results['lpips']['test']}")
    print(f"  seconds per view: test() {per_test:.4f} s ({sum(test_s):.3f} s for {n_views} views: encode, render, "
          f"metrics, writers), render alone {per_render:.4f} s (views {min(render_s):.4f}-{max(render_s):.4f} s); "
          f"files under {cfg.render_name}/: {len(files)} ({sorted(videos)})")
    if fused != (0, 0, 0):
        fail("the auto-encoder test launched a fused level kernel")
    if len(render_s) != n_views or len(test_s) != 1:
        fail(f"the auto-encoder test rendered {len(render_s)} views, expected {n_views}")
    if len(states) != n_views or not all(t and s is not None and np.isfinite(s) for t, s in states):
        fail(f"the sweep was not conditioned on a finite predicted state: {states}")
    for name in ("psnr", "ssim", "psnr_obj"):
        if list(results[name]) != ["test"] or not np.isfinite(results[name]["test"]):
            fail(f"results.json {name}: {results[name]}")
    if results != json.loads(json.dumps(stats)):
        fail("results.json differs from what test() returned")
    if not expected <= files or len(videos) != 1:
        fail(f"render directory: missing {sorted(expected - files)}, videos {sorted(videos)}")
    return {"seconds_per_view": per_test, "render_seconds_per_view": per_render, "fused": fused}


# ------------------------------------------------------------------ bf16 mode


def _rel(x, ref64) -> float:
    """max |x - ref64| / max |ref64|."""
    return ((x.double() - ref64).abs().max() / ref64.abs().max().clamp_min(1e-300)).item()


def _k_in_parts(n: int):
    """The product summed over n consecutive parts of K, in K order (the last
    part takes the remainder)."""
    def mm(a, w):
        k = a.shape[1] // n
        return sum(a[:, i * k: (i + 1) * k if i < n - 1 else None] @ w[i * k: (i + 1) * k if i < n - 1 else None]
                   for i in range(n))
    return mm


def _halves_reversed(a, w):
    k = a.shape[1] // 2
    return a[:, :k].flip(-1) @ w[:k].flip(0) + a[:, k:].flip(-1) @ w[k:].flip(0)


# The fp32 summation orders of the plain bf16 version whose spread sets the
# bf16 rule's limits: the product of every mm of the plain version as cuBLAS
# sums it, with its K order reversed, as two, four and eight consecutive
# parts of K, and as two halves of K each reversed.
BF16_ORDERS = {
    "cuBLAS": torch.matmul,
    "reversed K": lambda a, w: a.flip(-1) @ w.flip(0),
    "K in halves": _k_in_parts(2),
    "K in quarters": _k_in_parts(4),
    "K in eighths": _k_in_parts(8),
    "halves reversed": _halves_reversed,
}


def bf16_limits(orders: dict, ref64: dict, floor: float) -> dict:
    """The bf16 rule's limit of each output: max(floor, TOL_BF16_SPREAD x the
    largest distance of the plain bf16 version's fp32 orders from the fp64
    reference), ``orders`` mapping each order's name to its outputs."""
    return {n: max(floor, TOL_BF16_SPREAD * max(_rel(run[n], ref) for run in orders.values()))
            for n, ref in ref64.items()}


def bf16_k1_plain(lv, white: bool, mm=torch.matmul) -> dict:
    """K1's plain version in bf16 mode with the products summed by mm."""
    from aonerf_torch.ops.kernels import fused_render as fr

    return dict(zip(OUTPUTS, fr.fused_render_level_ref(*lv, white, mm=mm, dot_bf16=True)))


def bf16_k2_plain(lv, cot, white: bool, mm=torch.matmul) -> dict:
    """K1s then K2, plain, in bf16 mode with every product summed by mm."""
    from aonerf_torch.ops.kernels import fused_train as ft

    saved, raw = ft.fused_level_fwd_spill_ref(*lv, white, mm=mm, dot_bf16=True)[4:]
    return ft.fused_level_bwd_saved_ref(*lv, saved, raw, *cot, white, mm=mm, dot_bf16=True)


def bf16_ratios(got: dict, ref64: dict, limits: dict) -> dict:
    """Each output's error against the fp64 reference over its limit."""
    return {n: _rel(got[n], ref64[n]) / limits[n] for n in limits}


def saved_layers(saved) -> dict:
    """K1s' saved activations by layer (h0..h7, bottleneck, view)."""
    return {name: saved[:, 256 * i: 256 * i + (128 if name == "view" else 256)]
            for i, name in enumerate(SAVED_LAYERS)}


def _bwd_bounds_bf16(R: int, S: int, P: int = 63, V: int = 27) -> dict:
    """The backward from saved in bf16 mode: B1's and B2's products at the
    bf16 (and the TF32) tensor-core peak, the rest at the fp32 peak; the
    saved activations, bf16 values, at 2 bytes each; at encoded widths P /
    V."""
    fp32 = ((2.0 * (R * S * B1_FP32_MACS + R * V * 128) + R * S * INTEGRATOR_FLOPS_PER_SAMPLE)
            / PEAK_FP32_FLOPS * 1e3)
    tc = 2.0 * R * S * (B1_TC_MACS + B2_TC_MACS + _macs(P) - MACS_PER_SAMPLE) * 1e3
    t_bytes = _bwd_bytes(R, S, saved_bytes=2, P=P, V=V) / PEAK_BYTES * 1e3
    return {"bf16": _bound(fp32 + tc / PEAK_BF16_FLOPS, t_bytes), "tf32": _bound(fp32 + tc / PEAK_TF32_FLOPS, t_bytes)}


def _check_rule(what, ratios: dict, fp32_ratios: dict) -> float:
    """Fails unless the bf16 kernel meets the bf16 rule on every output and
    the fp32 kernel misses it on one; returns the largest ratio."""
    worst = max(ratios, key=ratios.get)
    missed = sorted(n for n, r in fp32_ratios.items() if r > 1.0)
    print(f"  {what}: bf16 kernel at most {ratios[worst]:.3f} of its limit ({worst}); the fp32 kernel over its "
          f"limit on {len(missed)} of {len(fp32_ratios)} ({', '.join(missed[:6])}{'...' if len(missed) > 6 else ''})")
    bad = sorted(n for n, r in ratios.items() if not r <= 1.0)
    if bad:
        fail(f"{what}: the bf16 kernel is off its fp64 reference beyond the bf16 rule on {bad}")
    if not any(r > 1.0 for r in fp32_ratios.values()):
        fail(f"{what}: the fp32 kernel meets the bf16 rule too, so the rule does not tell the modes apart")
    return max(ratios.values())


def tie_check(kp, t, o, d, venc, xenc) -> float:
    """K1s in bf16 on encoded inputs exactly halfway between two bf16 values:
    the share of saved h0 elements that differ from the plain version's (which
    rounds to nearest, ties to even) at most TIE_SHARE."""
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    ties = (fr.round_bf16(xenc).view(torch.int32) + 0x8000).view(torch.float32)
    args = (kp, t, o, d, venc, ties)
    h0 = ft.fused_level_fwd_spill(*args, True, dot_bf16=True)[4][:, :256]
    h0_plain = ft.fused_level_fwd_spill_ref(*args, True, dot_bf16=True)[4][:, :256]
    share = (h0 != h0_plain).double().mean().item()
    print(f"  ties: encoded inputs halfway between bf16 values, K1s' h0 differs from the plain version's (ties to "
          f"even) on {share:.2e} of its elements (limit {TIE_SHARE:g})")
    if not share <= TIE_SHARE:
        fail("K1s in bf16 does not round ties to even")
    return share


def backward_with_deltas(args, saved, raw, cot, white: bool, dot_bf16: bool):
    """The backward from saved, once, and B1's deltas from its scratch (R*S x
    SAVED_FLOATS; fp32, bf16 in bf16 mode), which B2 read."""
    return backward_operands(args, saved, raw, cot, white, dot_bf16)[:2]


def backward_operands(args, saved, raw, cot, white: bool, dot_bf16: bool):
    """The backward from saved, once: its gradients, B1's deltas (fp32, bf16
    in bf16 mode) and the integrator backward's g_raw (R*S x 4: sigma, rgb)
    from their scratches."""
    from aonerf_torch.ops.kernels import fused_train as ft

    return ft.fused_level_bwd_saved(*args, saved, raw, *cot, white, dot_bf16=dot_bf16, deltas=True)


def b1_products(kp, saved, grow, delta, dtype):
    """B1 in bf16 mode as products of what it read, layer by layer, from the
    rgb head down: (name, the delta B1 wrote (bf16), its columns of the delta
    scratch; the same delta formed in ``dtype`` from the operands B1
    multiplied, each rounded to bf16: the delta of the layer above as B1
    wrote it, or g_raw, and the weight; masked by the saved activation)."""
    from aonerf_torch.ops.kernels import fused_render as fr

    def rnd(x):
        return fr.round_bf16(x).to(dtype)

    def on(c0, width=256):  # the ReLU mask of the saved activation at columns c0..
        return saved[:, c0: c0 + width] > 0

    view, btl = SAVED_FLOATS - 128, 8 * 256
    yield "view", delta[:, view:], (rnd(grow[:, 1:]) @ rnd(kp["wr"]).t()) * on(view, 128)
    yield "bottleneck", delta[:, btl: view], rnd(delta[:, view:]) @ rnd(kp["wva"]).t()
    yield "h7", delta[:, 7 * 256: btl], (rnd(delta[:, btl: view]) @ rnd(kp["wb"]).t()
                                        + rnd(grow[:, :1]) @ rnd(kp["wd"]).t()) * on(7 * 256)
    for i in range(6, -1, -1):
        w = kp["w5x" if i == 4 else f"w{i + 1}"]
        yield f"h{i}", delta[:, 256 * i: 256 * (i + 1)], (rnd(delta[:, 256 * (i + 1): 256 * (i + 2)])
                                                          @ rnd(w).t()) * on(256 * i)


def b1_heads(saved, grow) -> dict:
    """The head gradients B1 sums, in fp64 from the operands it read: wd and
    wr the products of rounded saved activations and g_raw, bd and br the
    sums of the fp32 g_raw (wvb, whose per-ray sums B1 rounds, is left out)."""
    from aonerf_torch.ops.kernels import fused_render as fr

    h7, hv = fr.round_bf16(saved[:, 7 * 256: 8 * 256]).double(), fr.round_bf16(saved[:, SAVED_FLOATS - 128:]).double()
    g = grow.double()
    return {"wd": h7.t() @ fr.round_bf16(grow[:, :1]).double(), "bd": g[:, :1].sum(0),
            "wr": hv.t() @ fr.round_bf16(grow[:, 1:]).double(), "br": g[:, 1:].sum(0)}


# The bias gradient each delta of b1_products sums into.
B1_BIASES = {"view": "bv", "bottleneck": "bb", **{f"h{i}": f"b{i}" for i in range(8)}}


def b1_delta_error(got, ref64) -> float:
    """A bf16 delta B1 wrote against its fp64 product: the largest excess of
    |got - ref64| over half a bf16 ulp (2^-8 |ref64|, what rounding its fp32
    sum to nearest may add), over max |ref64|."""
    err = (got.double() - ref64).abs() - ref64.abs() * 2.0 ** -8
    return (err.clamp_min(0).max() / ref64.abs().max().clamp_min(1e-300)).item()


def b1_errors(kp, saved, grow, delta, grads) -> tuple:
    """B1 in bf16 against what it read: the largest error, over its deltas
    (b1_delta_error) and its head gradients, against the fp64 products and
    sums of its operands (max abs err / max |fp64|, held to B1_TOL); the
    largest error of its ten bias sums against the fp64 sums of those fp64
    products (held to B1_BIAS_TOL); and the largest abs error of its deltas
    against the same products in fp32 (cuBLAS), B1's plain version on its own
    operands, rounded to bf16 as B1 writes them."""
    worst = bias = 0.0
    for name, got, want in b1_products(kp, saved, grow, delta, torch.float64):
        worst = max(worst, b1_delta_error(got, want))
        bias = max(bias, _rel(grads[B1_BIASES[name]].reshape(-1), want.sum(0)))
        del want
    for name, want in b1_heads(saved, grow).items():
        worst = max(worst, _rel(grads[name].reshape(-1), want.reshape(-1)))
    err = 0.0
    for _, got, want in b1_products(kp, saved, grow, delta, torch.float32):
        err = max(err, (got.float() - want.to(torch.bfloat16).float()).abs().max().item())
        del want
    return worst, bias, err


def b1_check(args, cot, S: int) -> dict:
    """B1 in bf16 at the train step's shapes, at the tile K2 chooses: its
    deltas and head gradients against the fp64 products of what it read
    (B1_TOL), its bias sums against their fp64 sums (B1_BIAS_TOL), and its
    deltas against B1's plain version on the same operands; its time by
    torch.profiler in turns with that plain version (bf16, plain, bf16,
    plain), its bound."""
    from aonerf_torch.ops.kernels import fused_train as ft

    R = args[1].shape[0]
    *_, saved, raw = ft.fused_level_fwd_spill(*args, True, dot_bf16=True)
    got, delta, grow = backward_operands(args, saved, raw, cot, True, True)
    tile = ft.bwd_tiles[(R, S, True)]
    worst, bias, err = b1_errors(args[0], saved, grow, delta, got)
    if not worst <= B1_TOL:
        fail(f"B1 bf16 S={S}: off the fp64 products of its own operands by {worst:.3e} (limit {B1_TOL:g})")
    if not bias <= B1_BIAS_TOL:
        fail(f"B1 bf16 S={S}: bias sums off the fp64 sums of its deltas by {bias:.3e} (limit {B1_BIAS_TOL:g})")
    k2 = lambda: ft.fused_level_bwd_saved(*args, saved, raw, *cot, True, dot_bf16=True)  # noqa: E731
    plain_fn = lambda: [p for _, _, p in b1_products(args[0], saved, grow, delta, torch.float32)]  # noqa: E731
    ms = _bwd_pass_ms(k2, iters=3, passes=K2_PASSES_BF16)["B1"]
    plain_ms = cuda_ms(plain_fn, warmup=1, iters=3)
    ms_again = _bwd_pass_ms(k2, iters=3, passes=K2_PASSES_BF16)["B1"]
    plain_again = cuda_ms(plain_fn, warmup=0, iters=3)
    bound, by = _b1_bound_bf16(R, S, tile)
    print(f"  S={S}: B1 bf16 (level_bwd_delta_kernel<true>, torch.profiler) at {R} rays, ray tile {tile}: {ms:.3f} / "
          f"{ms_again:.3f} ms, its plain version on the same operands {plain_ms:.3f} / {plain_again:.3f} ms (in "
          f"turns); bound {bound:.3f} ms ({by}); against the fp64 products of its operands {worst:.3e} of the "
          f"largest entry beyond half a bf16 ulp (limit {B1_TOL:g}), its ten bias sums {bias:.3e} (limit "
          f"{B1_BIAS_TOL:g}); max abs err against the plain version {err:.3e}")
    del saved, raw, delta, grow
    return {"S": S, "R": R, "ray_tile": tile, "ms": ms, "ms_again": ms_again, "plain_ms": plain_ms,
            "plain_ms_again": plain_again, "bound_ms": bound, "bound_by": by, "max_abs_err": err,
            "fp64_rel_err": worst, "bias_rel_err": bias}


def b2_operands(saved, xenc, delta) -> dict:
    """Each of B2's products: (H, rows x K; Delta, rows x N), views."""
    return {n: (xenc if h is None else saved[:, h: h + 256], delta[:, c: c + (128 if n == "wva" else 256)])
            for n, (h, c) in B2_PRODUCTS.items()}


def b2_plain(ops: dict, delta, dot_bf16: bool) -> dict:
    """B2's share of the plain version: each product as it forms it (fp32
    cuBLAS, on operands rounded to bf16 in bf16 mode) and, in fp32, each
    bias as the sum of its deltas (in bf16 mode B1 sums the biases)."""
    from aonerf_torch.ops.kernels import fused_render as fr

    rnd = fr.round_bf16 if dot_bf16 else (lambda x: x)
    out = {n: rnd(h).float().t() @ rnd(d).float() for n, (h, d) in ops.items()}
    if not dot_bf16:
        out.update({n: delta[:, c: c + (128 if n == "bv" else 256)].sum(0) for n, c in B2_BIASES.items()})
    return out


def b2_errors(got: dict, ops: dict, delta, dot_bf16: bool) -> tuple:
    """B2 against what it read: the largest error of its gradients (the 21
    in fp32, the 11 weight products in bf16 mode) against the products of
    its operands (rounded to bf16 in bf16 mode) and, in fp32, the sums of its
    deltas, in fp64 (max abs err / max |fp64|, held to B2_TOL or
    B2_FP32_TOL); and its largest abs error against B2's share of the plain
    version on the same operands."""
    from aonerf_torch.ops.kernels import fused_render as fr

    rnd = fr.round_bf16 if dot_bf16 else (lambda x: x)
    worst = 0.0
    for n, (h, d) in ops.items():
        want = rnd(h).double().t() @ rnd(d).double()
        worst = max(worst, _rel(got[n], want))
        del want
    for n, c in ({} if dot_bf16 else B2_BIASES).items():
        worst = max(worst, _rel(got[n].reshape(-1), delta[:, c: c + (128 if n == "bv" else 256)].double().sum(0)))
    plain = b2_plain(ops, delta, dot_bf16)
    err = max((got[n].reshape(-1) - plain[n].reshape(-1)).abs().max().item() for n in plain)
    return worst, err


def b2_library_ms(ops: dict, dot_bf16: bool) -> tuple:
    """One torch.mm a product of B2, summed: fp32 operands (TF32 off), or in
    bf16 mode on the very bf16 column slices of saved and delta that B2 reads
    (xenc, fp32, converted beforehand, not timed) with an fp32 result where
    torch.mm takes out_dtype; and what was timed."""
    if not dot_bf16:
        pairs, kw, kind = [(h.t(), d) for h, d in ops.values()], {}, "fp32 torch.mm"
    else:
        pairs = [(h.t().to(torch.bfloat16), d.to(torch.bfloat16)) for h, d in ops.values()]  # views where bf16
        try:
            torch.mm(*pairs[0], out_dtype=torch.float32)
            kw, kind = {"out_dtype": torch.float32}, "bf16 torch.mm, fp32 out (out_dtype)"
        except (TypeError, RuntimeError):
            kw, kind = {}, "bf16 torch.mm, bf16 out (no out_dtype)"
    ms = cuda_ms(lambda: [torch.mm(a, b, **kw) for a, b in pairs], warmup=1, iters=3)
    del pairs
    return ms, kind


def b2_bound(R: int, S: int, peak_flops: float, macs_factor: int = 1, scratch_bytes: int = 4) -> dict:
    """B2 as its own function: its products at peak_flops (macs_factor
    products a product: 3 for 3xTF32), against the bytes it must move, each
    read or written once: every saved column but the view layer's and every
    delta column at scratch_bytes a value (2 in bf16 mode, whose scratches
    are bf16), xenc in fp32, and the partial sets it writes.
    bound_ms_layout: the same with both scratches at 4 bytes a value, the
    fp32 layout that bf16 mode had before its scratches were bf16."""
    rows = R * S
    ops = macs_factor * 2.0 * rows * B2_TC_MACS / peak_flops * 1e3

    def bytes_ms(scratch_b: int) -> float:
        n = rows * (scratch_b * (2 * SAVED_FLOATS - 128) + 4.0 * 63) + 4.0 * K2_RANGES * N_WEIGHTS
        return n / PEAK_BYTES * 1e3

    t_bytes = bytes_ms(scratch_bytes)
    ms, by = _bound(ops, t_bytes)
    layout_ms, _ = _bound(ops, bytes_ms(4))
    return {"bound_ms": ms, "bound_by": by, "bound_ms_ops": ops, "bound_ms_bytes": t_bytes,
            "bound_ms_layout": layout_ms}


def b2_check(args, cot, S: int) -> dict:
    """B2 in bf16 at the train step's shapes: its 11 gradients against the
    fp64 products of what it read (B2_TOL) and against B2's share of the
    plain bf16 version; its time by torch.profiler in turns with that plain
    share and with the fp32 B2 (fp32, bf16, plain, bf16, plain, fp32), its
    bound and the library's torch.mm on the same bf16 slices."""
    from aonerf_torch.ops.kernels import fused_train as ft

    xenc = args[5].reshape(-1, args[5].shape[-1])
    *_, saved, raw = ft.fused_level_fwd_spill(*args, True, dot_bf16=True)
    got, delta = backward_with_deltas(args, saved, raw, cot, True, True)
    ops = b2_operands(saved, xenc, delta)
    worst, err = b2_errors(got, ops, delta, True)
    if not worst <= B2_TOL:
        fail(f"B2 bf16 S={S}: off the fp64 product of its own operands by {worst:.3e} (limit {B2_TOL:g})")
    k2 = lambda: ft.fused_level_bwd_saved(*args, saved, raw, *cot, True, dot_bf16=True)  # noqa: E731
    saved32 = saved.float()  # the fp32 mode's layout of the same values
    k2_32 = lambda: ft.fused_level_bwd_saved(*args, saved32, raw, *cot, True)  # noqa: E731
    plain_fn = lambda: b2_plain(ops, delta, True)  # noqa: E731
    fp32_ms = _bwd_pass_ms(k2_32, iters=3)["B2"]
    ms = _bwd_pass_ms(k2, iters=3, passes=K2_PASSES_BF16)["B2"]
    plain_ms = cuda_ms(plain_fn, warmup=1, iters=3)
    ms_again = _bwd_pass_ms(k2, iters=3, passes=K2_PASSES_BF16)["B2"]
    plain_again = cuda_ms(plain_fn, warmup=0, iters=3)
    fp32_again = _bwd_pass_ms(k2_32, iters=3)["B2"]
    library_ms, library = b2_library_ms(ops, True)
    b = b2_bound(args[1].shape[0], S, PEAK_BF16_FLOPS, scratch_bytes=2)
    print(f"  S={S}: B2 bf16 (level_bwd_dw_bf16_kernel, torch.profiler) {ms:.3f} / {ms_again:.3f} ms, fp32 B2 "
          f"{fp32_ms:.3f} / {fp32_again:.3f} ms, B2's share of the plain bf16 version {plain_ms:.3f} / "
          f"{plain_again:.3f} ms (in turns: fp32, bf16, plain, bf16, plain, fp32); bound {b['bound_ms']:.3f} ms "
          f"({b['bound_by']}: {b['bound_ms_bytes']:.3f} ms for its bytes at 3.35 TB/s, both bf16 scratches at 2 "
          f"bytes a value; {b['bound_ms_layout']:.3f} ms were they fp32, 4 bytes; "
          f"{b['bound_ms_ops']:.3f} ms for its products at 989 TFLOP/s); {library} {library_ms:.3f} ms; against "
          f"the fp64 products of its operands {worst:.3e} of the largest entry (limit {B2_TOL:g}), max abs err "
          f"against the plain bf16 share {err:.3e}")
    del saved, saved32, raw, delta, ops
    return {"S": S, "ms": ms, "ms_again": ms_again, "fp32_ms": fp32_ms, "fp32_ms_again": fp32_again,
            "plain_ms": plain_ms, "plain_ms_again": plain_again, **b, "library_ms": library_ms,
            "library": library, "max_abs_err": err, "fp64_rel_err": worst}


def _in_turns(chosen, at16, kernel: str, iters: int) -> tuple:
    """Device ms per call of the kernel whose name holds `kernel` (by
    torch.profiler) in chosen() and in at16(), in turns (chosen, 16, 16,
    chosen): ([chosen, chosen again], [16, 16 again]). At the fast preset's
    shapes a launch's host work outlasts the kernel, so CUDA events around a
    run of calls would time the host."""
    def dev(fn):
        return sum(v for k, v in _kernel_ms(fn, iters).items() if kernel in k)
    a, b, b2, a2 = dev(chosen), dev(at16), dev(at16), dev(chosen)
    return [a, a2], [b, b2]


def host_ms(fn, n: int = 20, batches: int = 5) -> float:
    """Host ms per call of fn(), the median over ``batches`` runs of n calls
    without a synchronize (the host's clock spreads from run to run): the
    wrapper's own work (packing, tensor maps, the launch) while the card
    runs behind it."""
    runs = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append((time.perf_counter() - t0) * 1e3 / n)
        torch.cuda.synchronize()
    return float(np.median(runs))


def _same_at_16(what, fn, args, white: bool) -> None:
    """Fails unless fn's outputs at the tile its wrapper chooses equal, bit
    for bit, those at 16 rays a block, in fp32 and in bf16 mode; ends with
    the chosen tile's launch, so the wrapper's record of the shape holds it."""
    for dot in (False, True):
        chosen = fn(*args, white, dot_bf16=dot)
        at16 = fn(*args, white, ray_tile=16, dot_bf16=dot)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(chosen, at16)):
            if not torch.equal(a, b):
                fail(f"{what} {'bf16' if dot else 'fp32'} white={white}: output {i} at the chosen tile differs from "
                     "its bits at 16 rays a block")
        del chosen, at16
        fn(*args, white, dot_bf16=dot)


def k1_preset_check(args, S: int) -> dict:
    """K1 bf16 at the fast preset's chunk (CHUNK_FAST rays), at the tile its
    wrapper chooses: the bf16 rule (the fp32 kernel not asked to miss at this
    size), its outputs equal to K1s bf16's and, in both modes, to those at 16
    rays a block; times in turns with the 16-ray launch, its bounds, the plain
    bf16 version, the host time of a launch."""
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    R = args[1].shape[0]
    args64 = ({n: v.double() for n, v in args[0].items()}, *(a.double() for a in args[1:]))
    worst, err = 0.0, 0.0
    for white in (True, False):
        got = fr.fused_render_level(*args, white, dot_bf16=True)
        k1s = ft.fused_level_fwd_spill(*args, white, dot_bf16=True)
        torch.cuda.synchronize()
        for n, g, w in zip(OUTPUTS, got, k1s):
            if not torch.isfinite(g).all():
                fail(f"K1 bf16 S={S} at {R} rays white={white}: non-finite {n}")
            if not torch.equal(g, w):
                fail(f"K1 bf16 S={S} at {R} rays white={white}: {n} differs from K1s bf16's")
        got = dict(zip(OUTPUTS, got))
        del k1s
        _same_at_16(f"K1 S={S} at {R} rays", fr.fused_render_level, args, white)
        orders = {k: bf16_k1_plain(args, white, mm) for k, mm in BF16_ORDERS.items()}
        ref = bf16_k1_plain(args64, white)
        ratios = bf16_ratios(got, ref, bf16_limits(orders, ref, TOL_BF16_FWD))
        bad = sorted(n for n, r in ratios.items() if not r <= 1.0)
        if bad:
            fail(f"K1 bf16 S={S} at {R} rays white={white}: off the fp64 bf16 reference beyond the bf16 rule on {bad}")
        worst = max(worst, max(ratios.values()))
        err = max(err, max((got[n] - orders["cuBLAS"][n]).abs().max().item() for n in OUTPUTS))
        del got, orders, ref
    tile = fr.launch_tiles[(R, S, True)]
    k1 = lambda: fr.fused_render_level(*args, True, dot_bf16=True)  # noqa: E731
    k1_16 = lambda: fr.fused_render_level(*args, True, ray_tile=16, dot_bf16=True)  # noqa: E731
    ms, ms16 = _in_turns(k1, k1_16, "fused_render_level_kernel", iters=20)
    call_ms = cuda_ms(k1, warmup=2, iters=40)
    plain = cuda_ms(lambda: fr.fused_render_level_ref(*args, True, dot_bf16=True), warmup=1, iters=5)
    host = host_ms(k1)
    b = _fwd_bounds(S, R)
    print(f"  S={S}: K1 bf16 at the fast preset's chunk of {R} rays, ray tile {tile}: {ms[0]:.3f} / {ms[1]:.3f} ms "
          f"of device time (torch.profiler), at 16 rays a block {ms16[0]:.3f} / {ms16[1]:.3f} ms (in turns); a call "
          f"{call_ms:.3f} ms by CUDA events over 40, its host work {host:.3f} ms (median of 5 x 20 calls "
          f"unsynchronized); plain "
          f"bf16 {plain:.3f} ms, bound {b['bf16'][0]:.3f} ms ({b['bf16'][1]}); bf16 rule at most {worst:.3f} of its "
          f"limit, max abs err against the fp32-summed plain bf16 {err:.3e}; outputs equal to K1s bf16's and, "
          "in both modes, to those at 16 rays a block")
    return {"S": S, "R": R, "ray_tile": tile, "ms": ms[0], "ms_again": ms[1], "ms_t16": ms16[0],
            "ms_t16_again": ms16[1], "plain_ms": plain, "bound_ms": b["bf16"][0], "bound_by": b["bf16"][1],
            "bound_ms_tf32": b["tf32"][0], "host_ms": host, "call_ms": call_ms, "max_abs_err": err,
            "rule_ratio": worst}


def _b1_bound_bf16(R: int, S: int, ray_tile: int) -> tuple:
    """B1 in bf16 mode as its own function at ray_tile rays a block: its
    products at the bf16 peak, its narrow products and the wvb sum at the
    fp32 peak; against its bytes, each read or written once: the saved
    activations it masks with (bf16, 2 bytes), g_raw (4 floats), the bf16
    deltas it writes, venc, the weights and its blocks' narrow sets (with
    the bias sums, whose size the library gives)."""
    from aonerf_torch.ops.kernels import fused_train as ft

    rows = R * S
    ops = (2.0 * rows * B1_TC_MACS / PEAK_BF16_FLOPS
           + 2.0 * (rows * B1_FP32_MACS + R * 27 * 128) / PEAK_FP32_FLOPS) * 1e3
    narrow = ft._library().aonerf_fused_level_bwd_narrow_floats(1)
    n_bytes = (rows * (2.0 * B1_SAVED_FLOATS + 2.0 * SAVED_FLOATS + 4.0 * 4)
               + 4.0 * (R * 27 + N_WEIGHTS + (R // ray_tile) * narrow))
    return _bound(ops, n_bytes / PEAK_BYTES * 1e3)


def k1s_preset_check(args, S: int) -> dict:
    """K1s bf16 at the fast preset's batch (BATCH_FAST rays), at the tile its
    wrapper chooses: its saved layers against the bf16 rule, its outputs
    equal to K1 bf16's and, in both modes, to those at 16 rays a block; times
    in turns with the 16-ray launch, its bounds and the plain bf16 version;
    then K2 bf16 from what it saved, at the tile its wrapper chooses and at
    16 rays a block: its gradients against the bf16 rule at both (the
    gradients the preset trains on), B2's gradients equal at both (B1's
    deltas do not depend on the tile), B1's time by torch.profiler in turns
    with the 16-ray launch, B1's bound, the host time of a K2 call."""
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    R = args[1].shape[0]
    args64 = ({n: v.double() for n, v in args[0].items()}, *(a.double() for a in args[1:]))
    for white in (True, False):
        got = ft.fused_level_fwd_spill(*args, white, dot_bf16=True)
        k1 = fr.fused_render_level(*args, white, dot_bf16=True)
        torch.cuda.synchronize()
        for n, g, w in zip(OUTPUTS, got, k1):
            if not torch.equal(g, w):
                fail(f"K1s bf16 S={S} at {R} rays white={white}: {n} differs from K1 bf16's")
        if white:
            saved, raw = got[4], got[5]
        del got, k1
        _same_at_16(f"K1s S={S} at {R} rays", ft.fused_level_fwd_spill, args, white)
    tile = ft.fwd_tiles[(R, S, True)]
    orders = {k: saved_layers(ft.fused_level_fwd_spill_ref(*args, True, mm=mm, dot_bf16=True)[4])
              for k, mm in BF16_ORDERS.items()}
    ref = saved_layers(ft.fused_level_fwd_spill_ref(*args64, True, dot_bf16=True)[4])
    ratios = bf16_ratios(saved_layers(saved), ref, bf16_limits(orders, ref, TOL_BF16_FWD))
    err = max((saved_layers(saved)[n] - orders["cuBLAS"][n]).abs().max().item() for n in ref)
    del orders, ref
    bad = sorted(n for n, r in ratios.items() if not r <= 1.0)
    if bad:
        fail(f"K1s bf16 S={S} at {R} rays: saved layers off the fp64 bf16 reference beyond the bf16 rule on {bad}")
    k1s = lambda: ft.fused_level_fwd_spill(*args, True, dot_bf16=True)  # noqa: E731
    k1s_16 = lambda: ft.fused_level_fwd_spill(*args, True, ray_tile=16, dot_bf16=True)  # noqa: E731
    ms, ms16 = _in_turns(k1s, k1s_16, "level_fwd_spill_kernel", iters=20)
    plain = cuda_ms(lambda: ft.fused_level_fwd_spill_ref(*args, True, dot_bf16=True), warmup=1, iters=3)
    b = _fwd_bounds(S, R, spill=True, saved_bytes=2)
    rng = np.random.default_rng(SEED + 400 + S)
    cot = tuple(torch.from_numpy(a.astype(np.float32)).to(saved.device) for a in (
        rng.standard_normal((R, 3)), rng.standard_normal(R), 0.1 * rng.standard_normal(R),
        rng.standard_normal((R, S))))
    k2 = lambda: ft.fused_level_bwd_saved(*args, saved, raw, *cot, True, dot_bf16=True)  # noqa: E731
    k2_16 = lambda: ft.fused_level_bwd_saved(*args, saved, raw, *cot, True, ray_tile=16, dot_bf16=True)  # noqa: E731
    grads16 = k2_16()
    grads = k2()
    k2_tile = ft.bwd_tiles[(R, S, True)]
    if not all(torch.isfinite(g).all() for g in (*grads.values(), *grads16.values())):
        fail(f"K2 bf16 S={S} at {R} rays: non-finite gradients")
    moved = [n for n in B2_PRODUCTS if not torch.equal(grads[n], grads16[n])]  # the biases are B1's sums
    if moved:
        fail(f"K2 bf16 S={S} at {R} rays: B2's gradients {sorted(moved)} differ between ray tiles {k2_tile} and 16")
    orders = {o: bf16_k2_plain(args, cot, True, mm) for o, mm in BF16_ORDERS.items()}
    ref = bf16_k2_plain(args64, tuple(x.double() for x in cot), True)
    lim = bf16_limits(orders, ref, TOL_BF16_GRAD)
    fp32_ratios = bf16_ratios(ft.fused_level_bwd(*args, *cot, True), ref, lim)
    k2_ratio = _check_rule(f"K2 bf16 S={S} at {R} rays from K1s' saved, ray tile {k2_tile}",
                           bf16_ratios(grads, ref, lim), fp32_ratios)
    k2_ratio_16 = _check_rule(f"K2 bf16 S={S} at {R} rays from K1s' saved, 16 rays a block",
                              bf16_ratios(grads16, ref, lim), fp32_ratios)
    del orders, ref, lim, args64, grads16
    parts = _bwd_pass_ms(k2, iters=5, passes=K2_PASSES_BF16)
    _, delta = backward_with_deltas(args, saved, raw, cot, True, True)
    b2_library, _ = b2_library_ms(b2_operands(saved, args[5].reshape(R * S, -1), delta), True)
    b2_b = b2_bound(R, S, PEAK_BF16_FLOPS, scratch_bytes=2)
    del delta
    b1_ms, b1_ms16 = _in_turns(k2, k2_16, "level_bwd_delta_kernel", iters=20)
    k2_host = host_ms(k2)
    k2_host16 = host_ms(k2_16)
    b1_bound, b1_by = _b1_bound_bf16(R, S, k2_tile)
    b1_bound16, _ = _b1_bound_bf16(R, S, 16)
    del saved, raw, grads
    print(f"  S={S}: K1s bf16 at the fast preset's batch of {R} rays, ray tile {tile}: {ms[0]:.3f} / {ms[1]:.3f} ms "
          f"of device time (torch.profiler), at 16 rays a block {ms16[0]:.3f} / {ms16[1]:.3f} ms (in turns), "
          f"plain bf16 {plain:.3f} ms, bound {b['bf16'][0]:.3f} ms ({b['bf16'][1]}; saved at 2 bytes a value); "
          f"saved vs fp64 bf16 reference, error / "
          f"limit at most {max(ratios.values()):.3f}; max abs err against the fp32-summed plain bf16 {err:.3e}")
    print(f"  S={S}: K2 bf16 from its saved at {R} rays, ray tile {k2_tile}, by pass (torch.profiler) "
          + ", ".join(f"{n} {v:.3f}" for n, v in parts.items())
          + f" ms (B2's bound {b2_b['bound_ms']:.3f} ms, {b2_b['bound_by']}; bf16 torch.mm on its slices "
          f"{b2_library:.3f} ms); B1 {b1_ms[0]:.3f} / {b1_ms[1]:.3f} ms of device time, at 16 rays a block {b1_ms16[0]:.3f} / "
          f"{b1_ms16[1]:.3f} ms (in turns); B1's bound {b1_bound:.3f} ms ({b1_by}; {b1_bound16:.3f} at 16 rays a "
          f"block); host work a K2 bf16 call {k2_host:.3f} ms (at 16 rays a block {k2_host16:.3f}; median of 5 x 20 "
          f"calls unsynchronized); bf16 rule at most {k2_ratio:.3f} of its limit, {k2_ratio_16:.3f} at 16 rays a "
          "block; B2's gradients equal at both tiles")
    return {"S": S, "R": R, "ray_tile": tile, "ms": ms[0], "ms_again": ms[1], "ms_t16": ms16[0],
            "ms_t16_again": ms16[1], "plain_ms": plain, "bound_ms": b["bf16"][0], "bound_by": b["bf16"][1],
            "bound_ms_tf32": b["tf32"][0], "max_abs_err": err, "rule_ratio": max(ratios.values()),
            "k2_rule_ratio": k2_ratio, "k2_rule_ratio_t16": k2_ratio_16, "k2_ray_tile": k2_tile,
            "k2_passes_ms": parts, "b1_ms": b1_ms[0], "b1_ms_again": b1_ms[1], "b1_ms_t16": b1_ms16[0],
            "b1_ms_t16_again": b1_ms16[1], "b1_bound_ms": b1_bound, "b1_bound_by": b1_by,
            "b1_bound_ms_t16": b1_bound16, "k2_host_ms": k2_host, "k2_host_ms_t16": k2_host16,
            "b2_ms": parts["B2"], "b2_bound_ms": b2_b["bound_ms"], "b2_library_ms": b2_library}


def phase_bf16_kernels(nerf, boxes, focal) -> dict:
    """K1, K1s and K2 in bf16 mode against the bf16 rule, at the serving
    tile's 4096 rays (K1) and the train step's 2048 (K1s, K2), S = 65 and
    193, both backgrounds; K1s' outputs equal to K1's bits; ties; times in
    turns with the fp32 mode; then K1 at the fast preset's chunk of 256 rays
    and K1s (with B1 after it) at its batch of 224, at the tile the
    wrappers choose, in turns with 16 rays a block."""
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    dev = torch.device("cuda")
    names = fr.WEIGHT_NAMES
    k1_levels, k1s_levels, k2_levels, b1_levels, b2_levels, k1_preset, k1s_preset = [], [], [], [], [], [], []
    o, d, lvls = _train_levels(nerf, boxes, focal, R=R, seed=SEED + 100, dot_bf16=True)
    for kp, t, venc, xenc in lvls:
        S = t.shape[1]
        args = (kp, t, o, d, venc, xenc)
        args64 = ({n: v.double() for n, v in kp.items()}, *(a.double() for a in (t, o, d, venc, xenc)))
        worst, err = 0.0, 0.0
        for white in (True, False):
            got = dict(zip(OUTPUTS, fr.fused_render_level(*args, white, dot_bf16=True)))
            f32k = dict(zip(OUTPUTS, fr.fused_render_level(*args, white)))
            torch.cuda.synchronize()
            for n, g in got.items():
                if not torch.isfinite(g).all():
                    fail(f"K1 bf16 S={S} white={white}: non-finite {n}")
            orders = {o: bf16_k1_plain(args, white, mm) for o, mm in BF16_ORDERS.items()}
            p32 = orders["cuBLAS"]
            ref = bf16_k1_plain(args64, white)
            lim = bf16_limits(orders, ref, TOL_BF16_FWD)
            print(f"kernel fused_render_level bf16 S={S} white={white} at {R} rays: vs fp64 bf16 reference, kernel "
                  f"(fp32-summed plain bf16; limit) " + ", ".join(
                      f"{n} {_rel(got[n], ref[n]):.3e} ({_rel(p32[n], ref[n]):.3e}; {lim[n]:.3e})" for n in OUTPUTS))
            worst = max(worst, _check_rule(f"K1 bf16 S={S} white={white}", bf16_ratios(got, ref, lim),
                                           bf16_ratios(f32k, ref, lim)))
            err = max(err, max((got[n] - p32[n]).abs().max().item() for n in OUTPUTS))
            del got, f32k, orders, p32, ref
        k1 = lambda: fr.fused_render_level(*args, True, dot_bf16=True)  # noqa: E731
        k1_32 = lambda: fr.fused_render_level(*args, True)  # noqa: E731
        iters = 20 if S > 100 else 40
        ms32 = cuda_ms(k1_32, warmup=2, iters=iters)
        ms = cuda_ms(k1, warmup=2, iters=iters)
        ms_again = cuda_ms(k1, warmup=0, iters=iters)
        ms32_again = cuda_ms(k1_32, warmup=0, iters=iters)
        plain_ms = cuda_ms(lambda: fr.fused_render_level_ref(*args, True, dot_bf16=True), warmup=1, iters=3)
        b = _fwd_bounds(S, R)
        print(f"  S={S}: K1 bf16 at {R} rays, ray tile {fr.launch_tiles[(R, S, True)]}: {ms:.3f} / {ms_again:.3f} ms, "
              f"fp32 {ms32:.3f} / {ms32_again:.3f} ms (in turns: fp32, bf16, bf16, fp32), plain bf16 {plain_ms:.3f} "
              f"ms; bound {b['bf16'][0]:.3f} ms ({b['bf16'][1]}; the products at 989 TFLOP/s bf16), "
              f"{b['tf32'][0]:.3f} ms at the 495 TFLOP/s TF32 peak; max abs err against the fp32-summed plain bf16 "
              f"{err:.3e}")
        k1_levels.append({"S": S, "ray_tile": fr.launch_tiles[(R, S, True)], "ms": ms, "ms_again": ms_again,
                          "fp32_ms": ms32, "fp32_ms_again": ms32_again, "plain_ms": plain_ms,
                          "bound_ms": b["bf16"][0], "bound_by": b["bf16"][1], "bound_ms_tf32": b["tf32"][0],
                          "max_abs_err": err, "rule_ratio": worst})
        del args64
        # the fast preset's validation and test launches (phase 14) are at its chunk, 256 rays
        k1_preset.append(k1_preset_check((kp, *(a[:CHUNK_FAST].contiguous() for a in (t, o, d, venc)),
                                          xenc.reshape(R, S, -1)[:CHUNK_FAST].contiguous()), S))

    o, d, lvls = _train_levels(nerf, boxes, focal, R=R_TRAIN, dot_bf16=True)
    for kp, t, venc, xenc in lvls:
        S = t.shape[1]
        args = (kp, t, o, d, venc, xenc)
        args64 = ({n: v.double() for n, v in kp.items()}, *(a.double() for a in (t, o, d, venc, xenc)))
        for white in (True, False):
            k1 = fr.fused_render_level(*args, white, dot_bf16=True)
            got = ft.fused_level_fwd_spill(*args, white, dot_bf16=True)
            again = ft.fused_level_fwd_spill(*args, white, dot_bf16=True)
            torch.cuda.synchronize()
            for n, g, w in zip(OUTPUTS, got, k1):
                if not torch.equal(g, w):
                    fail(f"K1s bf16 S={S} white={white}: {n} differs from K1 bf16's")
            for n, g, a in zip(OUTPUTS + ("saved", "raw"), got, again):
                if not torch.isfinite(g).all():
                    fail(f"K1s bf16 S={S} white={white}: non-finite {n}")
                if not torch.equal(g, a):
                    fail(f"K1s bf16 S={S} white={white}: a repeat call gave other bits on {n}")
            if white:
                saved, raw = got[4], got[5]
            del k1, got, again
        # the saved layers do not depend on the background
        orders, raw_err = {}, None
        for name, mm in BF16_ORDERS.items():
            s32, r32 = ft.fused_level_fwd_spill_ref(*args, True, mm=mm, dot_bf16=True)[4:]
            if raw_err is None:  # cuBLAS, the plain version as it runs
                raw_err, saved_err = (raw - r32).abs().max().item(), (saved - s32).abs().max().item()
            orders[name] = saved_layers(s32)
            del r32
        p32 = orders["cuBLAS"]
        ref = saved_layers(ft.fused_level_fwd_spill_ref(*args64, True, dot_bf16=True)[4])
        lim = bf16_limits(orders, ref, TOL_BF16_FWD)
        ratios = bf16_ratios(saved_layers(saved), ref, lim)
        rms = {n: ((saved_layers(saved)[n].double() - ref[n]).pow(2).mean().sqrt()
                   / (p32[n].double() - ref[n]).pow(2).mean().sqrt().clamp_min(1e-300)).item() for n in ref}
        print(f"kernel fused_level_fwd_spill bf16 S={S} at {R_TRAIN} rays: comp/acc/depth/weights equal to K1 bf16's bit "
              f"for bit, both backgrounds, a repeat call the same bits; saved vs fp64 bf16 reference, error / limit "
              + ", ".join(f"{n} {r:.3f}" for n, r in ratios.items())
              + "; rms error over the fp32-summed plain bf16's " + ", ".join(f"{n} {r:.2f}" for n, r in rms.items())
              + f"; max abs err against it: saved {saved_err:.3e}, raw {raw_err:.3e}")
        bad = sorted(n for n, r in ratios.items() if not r <= 1.0)
        if bad:
            fail(f"K1s bf16 S={S}: saved layers off the fp64 bf16 reference beyond the bf16 rule on {bad}")
        del saved, raw, orders, s32, p32, ref
        tie_share = tie_check(*args) if S < 100 else None
        k1s = lambda: ft.fused_level_fwd_spill(*args, True, dot_bf16=True)  # noqa: E731
        k1s32 = lambda: ft.fused_level_fwd_spill(*args, True)  # noqa: E731
        iters = 10 if S > 100 else 20
        ms32 = cuda_ms(k1s32, warmup=2, iters=iters)
        ms = cuda_ms(k1s, warmup=2, iters=iters)
        ms_again = cuda_ms(k1s, warmup=0, iters=iters)
        ms32_again = cuda_ms(k1s32, warmup=0, iters=iters)
        plain_ms = cuda_ms(lambda: ft.fused_level_fwd_spill_ref(*args, True, dot_bf16=True), warmup=1, iters=3)
        b = _fwd_bounds(S, R_TRAIN, spill=True, saved_bytes=2)
        print(f"  S={S}: K1s bf16 at {R_TRAIN} rays, ray tile {ft.fwd_tiles[(R_TRAIN, S, True)]}: {ms:.3f} / "
              f"{ms_again:.3f} ms, fp32 {ms32:.3f} / {ms32_again:.3f} ms (in turns), "
              f"plain bf16 {plain_ms:.3f} ms; bound {b['bf16'][0]:.3f} ms ({b['bf16'][1]}; saved bf16, 2 bytes a "
              f"value; {_fwd_bounds(S, R_TRAIN, spill=True)['bf16'][0]:.3f} ms were it fp32), "
              f"{b['tf32'][0]:.3f} ms at the TF32 peak")
        k1s_levels.append({"S": S, "ms": ms, "ms_again": ms_again, "fp32_ms": ms32, "fp32_ms_again": ms32_again,
                           "plain_ms": plain_ms, "bound_ms": b["bf16"][0], "bound_by": b["bf16"][1],
                           "bound_ms_tf32": b["tf32"][0], "max_abs_err": max(saved_err, raw_err),
                           "rule_ratio": max(ratios.values()), "tie_share": tie_share,
                           "ray_tile": ft.fwd_tiles[(R_TRAIN, S, True)]})
        # the fast preset's training launches (phase 14) are at its batch, 224 rays
        k1s_preset.append(k1s_preset_check((kp, *(a[:BATCH_FAST].contiguous() for a in (t, o, d, venc)),
                                            xenc.reshape(R_TRAIN, S, -1)[:BATCH_FAST].contiguous()), S))

        rng = np.random.default_rng(SEED + 300 + S)
        cot = tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            rng.standard_normal((R_TRAIN, 3)), rng.standard_normal(R_TRAIN), 0.1 * rng.standard_normal(R_TRAIN),
            rng.standard_normal((R_TRAIN, S))))
        worst, err = 0.0, 0.0
        for white in (True, False):
            got = ft.fused_level_bwd(*args, *cot, white, dot_bf16=True)
            *_, saved, raw = ft.fused_level_fwd_spill(*args, white, dot_bf16=True)
            split = ft.fused_level_bwd_saved(*args, saved, raw, *cot, white, dot_bf16=True)
            f32k = ft.fused_level_bwd(*args, *cot, white)
            torch.cuda.synchronize()
            del saved, raw
            for n in names:
                if not torch.isfinite(got[n]).all():
                    fail(f"K2 bf16 S={S} white={white}: non-finite gradient {n}")
                if not torch.equal(split[n], got[n]):
                    fail(f"K2 bf16 S={S} white={white}: the backward from K1s' saved differs from the composition on {n}")
            del split
            orders = {o: bf16_k2_plain(args, cot, white, mm) for o, mm in BF16_ORDERS.items()}
            p32 = orders["cuBLAS"]
            ref = bf16_k2_plain(args64, tuple(c.double() for c in cot), white)
            lim = bf16_limits(orders, ref, TOL_BF16_GRAD)
            worst = max(worst, _check_rule(f"K2 bf16 S={S} white={white}", bf16_ratios(got, ref, lim),
                                           bf16_ratios(f32k, ref, lim)))
            err = max(err, max((got[n] - p32[n]).abs().max().item() for n in names))
            del got, f32k, orders, p32, ref
        again = ft.fused_level_bwd(*args, *cot, True, dot_bf16=True)
        if not all(torch.equal(again[n], ft.fused_level_bwd(*args, *cot, True, dot_bf16=True)[n]) for n in names):
            fail(f"K2 bf16 S={S}: a repeat call gave other bits")
        del again
        *_, saved, raw = ft.fused_level_fwd_spill(*args, True, dot_bf16=True)
        k2 = lambda: ft.fused_level_bwd_saved(*args, saved, raw, *cot, True, dot_bf16=True)  # noqa: E731
        saved32 = saved.float()  # the fp32 mode's layout of the same values
        k2_32 = lambda: ft.fused_level_bwd_saved(*args, saved32, raw, *cot, True)  # noqa: E731
        plain = lambda: ft.fused_level_bwd_saved_ref(*args, saved, raw, *cot, True, dot_bf16=True)  # noqa: E731
        iters = 5 if S > 100 else 10
        ms32 = cuda_ms(k2_32, warmup=2, iters=iters)
        ms = cuda_ms(k2, warmup=2, iters=iters)
        plain_ms = cuda_ms(plain, warmup=1, iters=3)
        ms_again = cuda_ms(k2, warmup=0, iters=iters)
        plain_again = cuda_ms(plain, warmup=0, iters=3)
        ms32_again = cuda_ms(k2_32, warmup=0, iters=iters)
        parts = _bwd_pass_ms(k2, iters=3, passes=K2_PASSES_BF16)
        del saved, saved32, raw
        b = _bwd_bounds_bf16(R_TRAIN, S)
        b1_bound, b1_by = _b1_bound_bf16(R_TRAIN, S, ft.bwd_tiles[(R_TRAIN, S, True)])
        print(f"  S={S}: K2 bf16 (the backward from saved) {ms:.3f} / {ms_again:.3f} ms, fp32 {ms32:.3f} / "
              f"{ms32_again:.3f} ms, plain bf16 {plain_ms:.3f} / {plain_again:.3f} ms (in turns: fp32, bf16, plain, "
              f"bf16, plain, fp32); bound {b['bf16'][0]:.3f} ms ({b['bf16'][1]}), {b['tf32'][0]:.3f} ms at the "
              f"TF32 peak; by pass (torch.profiler) " + ", ".join(f"{n} {v:.3f}" for n, v in parts.items())
              + f"; B1's bound {b1_bound:.3f} ms ({b1_by}); max abs err against plain bf16 {err:.3e}")
        k2_levels.append({"S": S, "ms": ms, "ms_again": ms_again, "fp32_ms": ms32, "fp32_ms_again": ms32_again,
                          "plain_ms": plain_ms, "plain_ms_again": plain_again, "bound_ms": b["bf16"][0],
                          "bound_by": b["bf16"][1], "bound_ms_tf32": b["tf32"][0], "passes_ms": parts,
                          "b1_bound_ms": b1_bound, "b1_bound_by": b1_by, "max_abs_err": err, "rule_ratio": worst})
        b1_levels.append(b1_check(args, cot, S))
        b2_levels.append(b2_check(args, cot, S))
        del args64
        torch.cuda.empty_cache()
    return {"k1": k1_levels, "k1s": k1s_levels, "k2": k2_levels, "b1": b1_levels, "b2": b2_levels,
            "k1_preset": k1_preset, "k1s_preset": k1s_preset}


def _fast_config(root: str, out: str) -> str:
    """config/vanilla_tpu_fast.json on the smoke scene, cut as phase 7 cuts
    config/vanilla.json (320x240, lr 1e-3 with no delay, one val view),
    validating and checkpointing after its last multi-step."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", "vanilla_tpu_fast.json")) as f:
        cfg = json.load(f)
    every = FAST_MULTI_STEPS * cfg["inner_steps"]
    cfg.update({
        "root_dir": root, "output_path": out, "exp_name": "smoke_bf16", "img_wh": [W, H],
        "lr_init": 1e-3, "lr_delay_steps": 0, "val_every_steps": every, "ckpt_every_steps": every,
        "limit_val_batches": 1, "seed": SEED,
    })
    path = os.path.join(out, "fast.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _bf16_counts() -> tuple:
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    return fr.bf16_launches, ft.bf16_fwd_launches, ft.bf16_launches


def step_ms_in_turns(cfg_path: str) -> dict:
    """ms per train step at config/vanilla.json's batch (phase 7's scene and
    cuts), fp32 and bf16 in turns (fp32, bf16, bf16, fp32), each over one
    timed multi-step after an untimed one, from the seed's initial weights;
    "batch" is the batch; "peak_gb": each mode's peak device memory over its
    runs (torch.cuda.max_memory_allocated())."""
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    out = {"fp32": [], "bf16": [], "batch": load_config(cfg_path).batch_size, "peak_gb": {"fp32": 0.0, "bf16": 0.0}}
    for dtype in ("f32", "bf16", "bf16", "f32"):
        cfg = load_config(cfg_path, {"compute_dtype": dtype, "exp_name": f"step_{dtype}"})
        trainer = Trainer(cfg)
        buffers = trainer.train_buffers()
        torch.cuda.reset_peak_memory_stats()
        trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)
        torch.cuda.synchronize()
        mode = "fp32" if dtype == "f32" else "bf16"
        out[mode].append((time.perf_counter() - t0) * 1e3 / trainer._inner_steps)
        out["peak_gb"][mode] = max(out["peak_gb"][mode], torch.cuda.max_memory_allocated() / 1e9)
        trainer.close()
        del trainer, buffers
        torch.cuda.empty_cache()
    return out


def phase_bf16_training(tmp: str, root: str, fp32_cfg_path: str) -> dict:
    """The bf16 main path: the train CLI at config/vanilla_tpu_fast.json's
    settings, validation and a checkpoint; --run_eval of the test views; view
    0 in bf16 against the same checkpoint in fp32; the bf16 step beside the
    fp32 step at config/vanilla.json's batch."""
    from aonerf_torch.cli import train as cli
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft
    from aonerf_torch.train import step as step_mod
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    cfg_path = _fast_config(root, os.path.join(tmp, "out"))
    cfg = load_config(cfg_path)
    n_steps = FAST_MULTI_STEPS * cfg.inner_steps
    n_val_tiles = -(-W * H // cfg.chunk)
    losses = []
    real = step_mod.vanilla_loss_and_grads

    def recorded(*args, **kwargs):  # observes each step's loss, changes nothing
        out = real(*args, **kwargs)
        losses.append(out[0])
        return out

    torch.cuda.synchronize()
    _reset_fused_launches()
    fr.launch_tiles.clear()
    ft.fwd_tiles.clear()
    ft.bwd_tiles.clear()
    t0 = time.perf_counter()
    with mock.patch.object(step_mod, "vanilla_loss_and_grads", recorded):
        metrics = cli.main(["--config", cfg_path, "--max_steps", str(n_steps)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    train_counts, fp32_counts = _bf16_counts(), _fused_launches()
    train_tiles = {"K1": dict(fr.launch_tiles), "K1s": dict(ft.fwd_tiles), "K2": dict(ft.bwd_tiles)}
    run_dir = os.path.join(cfg.output_path, cfg.exp_name)
    ckpt = torch.load(os.path.join(run_dir, "ckpts", f"ckpt_{n_steps:08d}.pt"), map_location="cpu")
    dtypes = {v.dtype for part in (ckpt["params"], ckpt["opt_state"]["mu"], ckpt["opt_state"]["nu"])
              for v in part.values()}

    trainer = Trainer(cfg)  # restores the step-n_steps checkpoint
    buffers = trainer.train_buffers()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)
    torch.cuda.synchronize()
    fast_step_ms = (time.perf_counter() - t0) * 1e3 / trainer._inner_steps
    fast_busy_ms, _ = profile_train_steps(trainer, buffers, cfg.seed)
    trainer.close()
    del trainer, buffers

    _reset_fused_launches()
    fr.launch_tiles.clear()
    test_t0 = time.perf_counter()
    stats = cli.main(["--config", cfg_path, "--run_eval"])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - test_t0
    test_counts, test_all = _bf16_counts(), _fused_launches()
    test_tiles = dict(fr.launch_tiles)

    bands = {}
    for field, exp_name in (("trained", cfg.exp_name), ("initial", "smoke_bf16_init")):  # no checkpoint: the seed's
        views = {}
        for dtype in ("bf16", "f32"):
            tr = Trainer(load_config(cfg_path, {"run_eval": True, "compute_dtype": dtype, "exp_name": exp_name}))
            views[dtype] = tr._renderer(tr._view_rays(tr.dataset.get_image(0)))
            tr.close()
        diff = (views["bf16"][0] - views["f32"][0]).abs()
        bands[field] = (diff.max().item(), diff.mean().item(), views["f32"][1].mean().item())
    steps = step_ms_in_turns(fp32_cfg_path)

    loss = torch.stack(losses).cpu().numpy()
    first, last = loss[: cfg.inner_steps].mean(), loss[-cfg.inner_steps:].mean()
    print(f"bf16 training: config/vanilla_tpu_fast.json (batch {cfg.batch_size}, inner_steps {cfg.inner_steps}, "
          f"grad_clip {cfg.grad_clip}, compute_dtype {cfg.compute_dtype}, chunk {cfg.chunk}), {len(losses)} steps in "
          f"{seconds:.1f} s; loss, mean of the first multi-step {first:.5f}, of the last {last:.5f}; val psnr "
          f"{metrics.get('val_psnr')}")
    def shown(tiles):  # (rays, samples, dot_bf16) -> tile
        return ", ".join(f"({r}, {s_}{', bf16' if b else ''}) -> {t_}" for (r, s_, b), t_ in sorted(tiles.items()))

    print(f"  launches (bf16 mode): K1 {train_counts[0]} (expected 2 levels x {n_val_tiles} val tiles = "
          f"{2 * n_val_tiles}), K1s {train_counts[1]} and K2 {train_counts[2]} (expected 2 x {n_steps} = "
          f"{2 * n_steps}); every mode together {fp32_counts}; ray tiles chosen, (rays, samples) -> tile: K1 "
          f"{shown(train_tiles['K1'])}; K1s {shown(train_tiles['K1s'])}; K2 {shown(train_tiles['K2'])}")
    print(f"  checkpoint tensor dtypes {sorted(str(d) for d in dtypes)}; step at batch {cfg.batch_size}: "
          f"{fast_step_ms:.3f} ms = {cfg.batch_size / fast_step_ms * 1e3:.1f} rays/s (one multi-step, host clock); "
          f"the card busy {fast_busy_ms:.3f} ms of it ({100 * fast_busy_ms / fast_step_ms:.1f}%; the profile above)")
    print(f"  --run_eval in bf16: {test_s:.1f} s for the test views ({test_s / N_TEST:.3f} s a view), K1 bf16 launches "
          f"{test_counts[0]} (every mode {test_all}), ray tiles {shown(test_tiles)}; psnr "
          f"{stats['psnr']['test']:.4f} dB, ssim {stats['ssim']['test']:.5f}, object psnr "
          f"{stats['psnr_obj']['test']:.4f} dB; view 0 in bf16 against fp32 (limits {TOL_BF16_VIEW_MAX:g} max, "
          f"{TOL_BF16_VIEW_MEAN:g} mean): " + "; ".join(
              f"{f} field max abs rgb diff {mx:.3e}, mean {mn:.3e} (mean acc {acc:.4f})"
              for f, (mx, mn, acc) in bands.items()))
    print(f"  train step at batch {steps['batch']} (config/vanilla.json, phase 7's scene; in turns fp32, bf16, bf16, fp32): "
          f"fp32 {', '.join(f'{x:.3f}' for x in steps['fp32'])} ms, bf16 {', '.join(f'{x:.3f}' for x in steps['bf16'])} ms; "
          f"peak device memory fp32 {steps['peak_gb']['fp32']:.3f} GB, bf16 {steps['peak_gb']['bf16']:.3f} GB")
    if not np.isfinite(loss).all() or len(losses) != n_steps:
        fail(f"bf16 training: {len(losses)} steps, finite {np.isfinite(loss).all()}")
    if not last < first:
        fail("bf16 training: the loss did not fall")
    if train_counts != (2 * n_val_tiles, 2 * n_steps, 2 * n_steps) or fp32_counts != train_counts:
        fail("the bf16 training run did not launch K1, K1s and K2 in bf16 mode as expected")
    expected_test = 2 * n_val_tiles * N_TEST
    if test_counts != (expected_test, 0, 0) or test_all != test_counts:
        fail(f"the bf16 test run launched {test_all}, expected K1 bf16 {expected_test}")
    if dtypes != {torch.float32}:
        fail(f"the bf16 checkpoint holds {dtypes}")
    for name in ("psnr", "ssim", "psnr_obj"):
        if not np.isfinite(stats[name]["test"]):
            fail(f"bf16 test {name}: {stats[name]}")
    for field, (mx, mn, _) in bands.items():
        if not (mx <= TOL_BF16_VIEW_MAX and mn <= TOL_BF16_VIEW_MEAN):
            fail(f"the bf16 view of the {field} field is off its fp32 render beyond the stated band")
    return {"k1": train_counts[0], "k1s": train_counts[1], "k2": train_counts[2], "test_k1": test_counts[0],
            "fast_step_ms": fast_step_ms, "fast_busy_ms": fast_busy_ms, "steps_ms": steps, "view_bands": bands,
            "test_seconds_per_view": test_s / N_TEST,
            "ray_tiles": {k: {f"{r}x{s_}": t_ for (r, s_, _), t_ in v.items()} for k, v in
                          (*train_tiles.items(), ("K1 test", test_tiles))},
            "loss_first": float(first), "loss_last": float(last)}


# ------------------------------------------------------- articulated bf16

ART_BF16_RAYS = 256  # rays of phase 15's rule on the card
# The presets' --run_eval renders PRESET_SWEEP_POSES of the 19 sweep poses,
# so the script stays within its time limit; phases 10 and 12 render all 19
# of the same sweep in fp32.
PRESET_SWEEP_POSES = 2
PRESET_COST_STEPS = 5  # steps a dispatch where phase 16 times and profiles a preset's step
PRESETS = ("autodecoder_tpu_fast", "ae_art_tpu_quality", "ae_art_tpu_fast")
TURN_BATCH = 4096  # phase 17: config/autodecoder.json's and config/ae_art.json's batch
OPT_STEPS = 20  # phase 18's steps a run (the ranger run resumes at OPT_STEPS // 2)
OPT_RUNS = {  # phase 18: the reference's optimizer recipes, 4 epochs of 5 steps
    "sgd_steplr_warmup": dict(optimizer="sgd", lr_scheduler="steplr", lr_init=0.05, decay_step=[2],
                              warmup_epochs=1, warmup_multiplier=2.0),
    "adamw_cosine": dict(optimizer="adam", lr_scheduler="cosine", lr_init=1e-3, weight_decay=1e-4),
    "radam_poly": dict(optimizer="radam", lr_scheduler="poly", lr_init=1e-3),
    "ranger_poly": dict(optimizer="ranger", lr_scheduler="poly", lr_init=1e-3),
}
REUSE, REUSE_INNER = 4, 8  # phase 19: ae_encode_reuse and inner_steps
RAGGED_STEPS = 20  # phase 20


def _random_biases(module, generator) -> None:
    """Every Linear's bias from N(0, 0.05^2): the seed's are zero, and a
    bias rounded or added at the wrong point shows only through them."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.Linear):
                m.bias.copy_(0.05 * torch.randn(m.bias.shape, generator=generator))


def articulated_bf16_rule(f32, rays, latents, near: float, far: float, white: bool, device,
                          layers: bool = True) -> dict:
    """The articulated bf16 rule (tests/test_torch_bf16_articulated_rule.py,
    PERF.md section 2) on the card. ``f32`` is an fp32 ArticulatedNeRF on the
    CPU; rays and latents are CPU tensors. Reference: the form summed in fp64
    (Form('fp64', 'flax'), the CPU tests' stand-in for flax) at the fp64
    evaluation's points; legitimate evaluations: the form summed in fp32 and
    in reversed fp32, and the port's bf16 field on the CPU (held to flax
    there). End to end each level's share of rows off the reference's raw
    outputs and comp_rgb's rms against fp64, for the card's bf16 field and
    (the control) its fp32 field, each against 2x the farthest legitimate
    evaluation; with ``layers`` every product of the coarse MLP from the fp64
    form's inputs on the card (``models.mlp.linear`` / ``latent_linear`` in
    bf16) by the layer rule, the CPU port's share standing in for flax's.
    Returns {"e2e": {name: [(share, rms, share limit, rms limit)] a level},
    "layers": [(name, (ulps, share), share limit)], "ok", "fp32_ok"}."""
    from aonerf_torch import full_fp32
    from aonerf_torch.models import bf16_form as bf
    from aonerf_torch.models.articulated import ArticulatedNeRF, latent_linear
    from aonerf_torch.models.mlp import linear
    from aonerf_torch.ops.encoding import pos_enc

    def port(dtype, dev):
        m = ArticulatedNeRF(num_coarse_samples=f32.num_coarse_samples, num_fine_samples=f32.num_fine_samples,
                            latent_dense=f32.coarse_mlp.latent_dense, compute_dtype=dtype, device=dev)
        m.load_state_dict(f32.state_dict())
        return m

    def port_eval(m, dev, pts):
        r = {k: v.to(dev) for k, v in rays.items()}
        lat = {k: v.to(dev) for k, v in latents.items()}
        comps = [x[0].cpu() for x in m(r, False, white, near, far, lat)]
        venc = pos_enc(r["viewdirs"], 0, m.deg_view)  # each MLP holds full_fp32 itself
        raws = [torch.cat(mlp(p.to(dev), venc, lat), -1).cpu() for mlp, p in zip((m.coarse_mlp, m.fine_mlp), pts)]
        return comps, raws

    with torch.no_grad():
        levels64, _, pts = bf.Form("fp64", "none").field(f32, rays, white, near, far, latents)
        comps64, pts = [x[0] for x in levels64], [p.float() for p in pts]
        ref = [torch.cat(bf.Form("fp64", "flax").mlp(mlp, p, bf.Form("fp64", "flax").pos_enc(
            rays["viewdirs"], 0, f32.deg_view).float(), latents), -1) for mlp, p in zip((f32.coarse_mlp, f32.fine_mlp), pts)]
        evals = {}
        for name, (sums, rounding) in (("form fp32", ("fp32", "flax")), ("form fp32 reversed", ("fp32_reversed", "flax"))):
            lv, raws, _ = bf.Form(sums, rounding).field(f32, rays, white, near, far, latents, samples=pts)
            evals[name] = ([x[0] for x in lv], [torch.cat(x, -1) for x in raws])
        evals["port bf16 cpu"] = port_eval(port(torch.bfloat16, "cpu"), "cpu", pts)
        card16 = port(torch.bfloat16, device)
        evals["card bf16"] = port_eval(card16, device, pts)
        evals["card fp32"] = port_eval(port(torch.float32, device), device, pts)
    legit = ("form fp32", "form fp32 reversed", "port bf16 cpu")
    stats = {n: [(bf.row_share(raws[i], ref[i]), bf.rms(comps[i], comps64[i])) for i in range(2)]
             for n, (comps, raws) in evals.items()}
    e2e = {}
    for n, lv in stats.items():
        e2e[n] = [(s, r) + bf.e2e_limits([stats[m][i][0] for m in legit], [stats[m][i][1] for m in legit],
                                         ref[i].shape[0] * ref[i].shape[1]) for i, (s, r) in enumerate(lv)]

    def passes(name):
        return all(s <= ls and r <= lr for s, r, ls, lr in e2e[name])

    out = {"e2e": e2e, "layers": [], "ok": passes("card bf16"), "fp32_ok": passes("card fp32")}
    if layers:
        form = bf.Form("fp64", "flax")
        form.record = []
        with torch.no_grad():
            form.mlp(f32.coarse_mlp, pts[0], form.pos_enc(rays["viewdirs"], 0, f32.deg_view).float(), latents)
        card_mlp = card16.coarse_mlp
        for name, x, want in form.record:
            layer, cpu_layer = getattr(card_mlp, name), getattr(f32.coarse_mlp, name)
            with torch.no_grad(), full_fp32():  # as the MLP holds it around its products
                if isinstance(x, tuple):
                    got = latent_linear(layer, x[0].to(device), [v.to(device) for v in x[1]], x[0].shape[0],
                                        torch.bfloat16)
                    cpu = latent_linear(cpu_layer, x[0], x[1], x[0].shape[0], torch.bfloat16)
                else:
                    got = linear(layer, x.to(device), torch.bfloat16)
                    cpu = linear(cpu_layer, x, torch.bfloat16)
            scale = bf.term_scale(cpu_layer, x)
            cpu_share = bf.layer_errors(cpu, want, scale)[1]
            errs = bf.layer_errors(got.cpu(), want, scale)
            limit = bf.layer_limit(cpu_share, want.numel())
            out["layers"].append((name, errs, limit))
            out["ok"] = out["ok"] and got.dtype == torch.bfloat16 and bf.layer_passes(errs, cpu_share, want.numel())
    return out


def ae_bf16_rule(ae32, rays, src, deg, near: float, far: float, white: bool, device) -> dict:
    """The articulated bf16 rule end to end on the auto-encoder's forward on
    the card (``ae32`` an fp32 AutoEncoderArticulatedNeRF on the CPU): each
    head's code and the predicted state entry by entry, the share off the
    fp64-summed form's beyond the threshold and the rms against the fp64
    evaluation, and each level's comp_rgb by its rms; limits 2x the farthest
    of the form in fp32, in reversed fp32 and the port's bf16 on the CPU.
    Returns {"parts": {name: [(share, rms, share limit, rms limit)]}, "ok"}."""
    from aonerf_torch.models import bf16_form as bf
    from aonerf_torch.models.ae import AutoEncoderArticulatedNeRF

    def rows(levels, codes, state):
        return [x[0].cpu() for x in levels], [codes[k].reshape(-1, 1).cpu() for k in sorted(codes)] + [
            state.reshape(-1, 1).cpu()]

    def port(dtype, dev):
        f = ae32.field
        m = AutoEncoderArticulatedNeRF(num_coarse_samples=f.num_coarse_samples, num_fine_samples=f.num_fine_samples,
                                       latent_dense=f.coarse_mlp.latent_dense, compute_dtype=dtype, device=dev)
        m.load_state_dict(ae32.state_dict())
        levels, latents, state = m({k: v.to(dev) for k, v in rays.items()}, src.to(dev), deg.to(dev), False, white,
                                   near, far)
        return rows(levels, {k: v for k, v in latents.items() if k != "articulation_deg"}, state)

    with torch.no_grad():
        comps64, parts64 = rows(*bf.Form("fp64", "none").autoencoder(ae32, rays, src, deg, white, near, far))
        _, ref = rows(*bf.Form("fp64", "flax").autoencoder(ae32, rays, src, deg, white, near, far))
        evals = {name: rows(*bf.Form(*form).autoencoder(ae32, rays, src, deg, white, near, far))
                 for name, form in (("form fp32", ("fp32", "flax")), ("form fp32 reversed", ("fp32_reversed", "flax")))}
        evals["port bf16 cpu"] = port(torch.bfloat16, "cpu")
        evals["card bf16"] = port(torch.bfloat16, device)
    legit = ("form fp32", "form fp32 reversed", "port bf16 cpu")
    stats = {n: [(bf.row_share(p, q), bf.rms(p, q64)) for p, q, q64 in zip(parts, ref, parts64)]
             + [(0.0, bf.rms(c, c64)) for c, c64 in zip(comps, comps64)] for n, (comps, parts) in evals.items()}
    sizes = [q.shape[0] for q in ref] + [1, 1]
    limits = [bf.e2e_limits([stats[m][i][0] for m in legit], [stats[m][i][1] for m in legit], sizes[i])
              for i in range(len(sizes))]
    parts = {n: [s + lim for s, lim in zip(v, limits)] for n, v in stats.items()}
    return {"parts": parts, "ok": all(s <= ls and r <= lr for s, r, ls, lr in parts["card bf16"])}


def phase_articulated_bf16_rule(root: str) -> dict:
    """The articulated bf16 rule on the card (latent_dense, the presets'
    schedule): the seed's field with random biases on ART_BF16_RAYS rays of a
    train view, two codes (the rays grouped by view), end to end and layer by
    layer; the fp32 field on the card must miss it. Then the seed's random
    auto-encoder on a val view's source image."""
    from aonerf_torch.data.sapien_multi import SapienMultiDataset
    from aonerf_torch.models.ae import AutoEncoderArticulatedNeRF
    from aonerf_torch.models.articulated import ArticulatedNeRF

    t0 = time.perf_counter()
    ds = SapienMultiDataset(root, split="train", img_wh=(W, H))
    g = torch.Generator().manual_seed(SEED + 18)
    f32 = ArticulatedNeRF(latent_dense=True, generator=g, device="cpu")
    _random_biases(f32, g)
    latents = {k: 0.3 * torch.randn((2, c), generator=g) for k, c in (("density", 128), ("color", 128),
                                                                      ("articulation", 32))}
    img = ds.get_image(0, 0, 0)
    pix = np.random.default_rng(SEED + 18).choice(W * H, ART_BF16_RAYS, replace=False)
    rays = {k: torch.from_numpy(img[k][pix]) for k in ("rays_o", "rays_d", "viewdirs")}
    flags = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    res = articulated_bf16_rule(f32, rays, latents, ds.near, ds.far, True, torch.device("cuda"))
    flag_kept = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction == flags

    ae32 = AutoEncoderArticulatedNeRF(generator=torch.Generator().manual_seed(SEED + 19), device="cpu")
    _random_biases(ae32.field, g)
    _random_biases(ae32.joint_state_decoder, g)
    val = SapienMultiDataset(root, split="val", img_wh=(W, H)).get_image(0, 0, 0)
    ae = ae_bf16_rule(ae32, {k: torch.from_numpy(val[k][pix]) for k in ("rays_o", "rays_d", "viewdirs")},
                      torch.from_numpy(val["src_imgs"])[None], torch.tensor(val["deg"]), ds.near, ds.far, True,
                      torch.device("cuda"))
    seconds = time.perf_counter() - t0

    def shown(levels):
        return "; ".join(f"L{i} share {s:.4f} (limit {ls:.4f}), rms {r:.3e} (limit {lr:.3e})"
                         for i, (s, r, ls, lr) in enumerate(levels))

    print(f"articulated bf16 rule: the seed's field (random biases), {ART_BF16_RAYS} rays of a {W}x{H} train view, "
          f"2 codes, latent_dense, on the card against the CPU ({seconds:.1f} s with the CPU's reference forms):")
    for name, levels in res["e2e"].items():
        print(f"  {name}: {shown(levels)}")
    worst = max(res["layers"], key=lambda x: x[1][1] / x[2])
    print(f"  layers: {len(res['layers'])} products of the coarse MLP on the card, largest error "
          f"{max(e[0] for _, e, _ in res['layers']):.3f} bf16 ulp, largest share / limit "
          f"{worst[1][1]:.2e} / {worst[2]:.2e} ({worst[0]}); allow_bf16_reduced_precision_reduction restored "
          f"after the forwards: {flag_kept}")
    names = ["code articulation", "code color", "code density", "state", "L0 comp", "L1 comp"]
    for name, parts in ae["parts"].items():
        print(f"  AE {name}: " + ", ".join(f"{p} share {s:.3f} (limit {ls:.3f}) rms {r:.3e} (limit {lr:.3e})"
                                          for p, (s, r, ls, lr) in zip(names, parts)))
    if not res["ok"]:
        fail("the card's bf16 articulated field misses the articulated bf16 rule")
    if res["fp32_ok"]:
        fail("the card's fp32 articulated field meets the bf16 rule: the rule does not tell the modes apart")
    if not ae["ok"]:
        fail("the card's bf16 auto-encoder misses the articulated bf16 rule")
    if not flag_kept:
        fail("the bf16 field left allow_bf16_reduced_precision_reduction changed")
    return {"layers": len(res["layers"]), "e2e": res["e2e"], "ae": ae["parts"]}


def _preset_config(name: str, root: str, out: str) -> str:
    """config/<name>.json as published on phase 9's scene: 320x240, its lr
    without the 2500-step delay (which would hold the lr at ~1% through the
    run), a validation and a checkpoint after its two dispatches."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", f"{name}.json")) as f:
        cfg = json.load(f)
    every = 2 * cfg["inner_steps"]
    cfg.update({
        "root_dir": root, "output_path": out, "exp_name": f"smoke_{name}", "img_wh": [W, H], "lr_delay_steps": 0,
        "val_every_steps": every, "ckpt_every_steps": every, "limit_val_batches": 1, "seed": SEED,
    })
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def phase_bf16_preset(tmp: str, name: str) -> dict:
    """One articulated bf16 preset as published, through the CLI: two
    dispatches with a validation and a checkpoint, the loss falling, no fused
    kernel launched, the checkpoint fp32; --run_eval (PRESET_SWEEP_POSES
    poses) and, for the auto-decoder, --run_optimize; the step's cost."""
    from aonerf_torch.cli import train as cli
    from aonerf_torch.train import step as step_mod
    from aonerf_torch.train import step_ae
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    root = os.path.join(tmp, "multi")  # phase 9's scene
    cfg_path = _preset_config(name, root, os.path.join(tmp, "out"))
    cfg = load_config(cfg_path)
    ae = cfg.exp_type == "vanilla_ae_art"
    mod, fn = (step_ae, "ae_loss_and_grads") if ae else (step_mod, "autodecoder_loss_and_grads")
    real = getattr(mod, fn)
    losses = []

    def recorded(*args, **kwargs):  # observes each step's loss, changes nothing
        out = real(*args, **kwargs)
        losses.append(out[0])
        return out

    n_steps = 2 * cfg.inner_steps
    torch.cuda.synchronize()
    _reset_fused_launches()
    t0 = time.perf_counter()
    with mock.patch.object(mod, fn, recorded):
        metrics = cli.main(["--config", cfg_path, "--max_steps", str(n_steps)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fused = _fused_launches()
    run_dir = os.path.join(cfg.output_path, cfg.exp_name)
    ckpt = torch.load(os.path.join(run_dir, "ckpts", f"ckpt_{n_steps:08d}.pt"), map_location="cpu")
    dtypes = {v.dtype for part in (ckpt["params"], ckpt["opt_state"]["mu"], ckpt["opt_state"]["nu"])
              for v in part.values()}

    os.environ.pop("AONERF_LPIPS_WEIGHTS", None)  # test() refuses LPIPS weights: LPIPS is not ported
    _reset_fused_launches()
    t0 = time.perf_counter()
    stats = cli.main(["--config", cfg_path, "--run_eval", "--test_sweep_poses", str(PRESET_SWEEP_POSES)])
    torch.cuda.synchronize()
    test_s = (time.perf_counter() - t0) / PRESET_SWEEP_POSES
    fused_test = _fused_launches()
    history = None
    if not ae:
        t0 = time.perf_counter()
        history = cli.main(["--config", cfg_path, "--run_optimize", "--optimize_steps", str(OPTIMIZE_STEPS),
                            "--batch_size", str(OPTIMIZE_BATCH)]).get("psnr1", [])
        opt_s = time.perf_counter() - t0

    # the step's cost: PRESET_COST_STEPS steps a dispatch from the checkpoint
    trainer = Trainer(load_config(cfg_path, {"inner_steps": PRESET_COST_STEPS}))
    buffers = trainer.train_buffers()
    trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)  # untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (2 * PRESET_COST_STEPS)
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"bf16 preset {name}: batch {cfg.batch_size}, inner_steps {cfg.inner_steps}, views a step "
          f"{cfg.ae_views_per_step}, lr {cfg.lr_init} (no delay), latent_dense {cfg.latent_dense}, chunk {cfg.chunk}")
    busy_ms, prof = profile_train_steps(trainer, buffers, cfg.seed)
    print_top_ops(prof, PRESET_COST_STEPS, step_ms, busy_ms)
    trainer.close()
    del trainer, buffers
    torch.cuda.empty_cache()

    loss = torch.stack(losses).cpu().numpy()
    k = max(5, n_steps // 20)
    first, last = loss[:k].mean(), loss[-k:].mean()
    print(f"  {len(losses)} steps in {train_s:.1f} s (two dispatches, a validation, a checkpoint); loss, mean of the "
          f"first {k} {first:.5f}, of the last {k} {last:.5f}; val psnr {metrics.get('val_psnr')}, object psnr "
          f"{metrics.get('val_psnr_obj')}" + (f", state error {metrics.get('val_state_error_rad')} rad" if ae else ""))
    print(f"  K1, K1s, K2 launches {fused} training, {fused_test} in --run_eval (expected 0); checkpoint dtypes "
          f"{sorted(str(d) for d in dtypes)}")
    print(f"  --run_eval: {PRESET_SWEEP_POSES} of the 19 sweep poses, {test_s:.3f} s a view (test(): render, "
          f"metrics, writers); psnr {stats['psnr']['test']:.4f}, ssim {stats['ssim']['test']:.5f}, object psnr "
          f"{stats['psnr_obj']['test']:.4f}" + ("" if ae else f"; --run_optimize {OPTIMIZE_STEPS} steps at batch "
                                                   f"{OPTIMIZE_BATCH} in {opt_s:.2f} s, psnr1 {history}"))
    print(f"  step: {step_ms:.3f} ms on the host clock = {cfg.batch_size / step_ms * 1e3:.1f} rays/s (2 dispatches "
          f"of {PRESET_COST_STEPS} after an untimed one); the card busy {busy_ms:.3f} ms a step, idle "
          f"{100 * max(0.0, 1 - busy_ms / step_ms):.1f}%; peak device memory {peak_gb:.3f} GB ({base_bytes / 1e9:.3f} "
          f"GB held before the steps)")
    if len(losses) != n_steps or not np.isfinite(loss).all():
        fail(f"{name}: {len(losses)} steps, expected {n_steps}; finite {np.isfinite(loss).all()}")
    if not last < first:
        fail(f"{name}: the loss did not fall")
    if fused != (0, 0, 0) or fused_test != (0, 0, 0):
        fail(f"{name}: a fused level kernel was launched")
    if dtypes != {torch.float32}:
        fail(f"{name}: the checkpoint holds {dtypes}")
    if not all(np.isfinite(metrics.get(m, np.nan)) for m in ("val_psnr", "val_psnr_obj")):
        fail(f"{name}: validation metrics {metrics}")
    if not all(np.isfinite(stats[m]["test"]) for m in ("psnr", "ssim", "psnr_obj")):
        fail(f"{name}: test metrics {stats}")
    if not ae and (len(history) != 1 or not np.isfinite(history).all()):
        fail(f"{name}: code optimization psnr1 {history}")
    return {"step_ms": step_ms, "busy_ms": busy_ms, "peak_gb": peak_gb, "loss_first": float(first),
            "loss_last": float(last), "test_seconds_per_view": test_s}


def phase_articulated_turns(tmp: str) -> dict:
    """The auto-decoder's and the auto-encoder's step at TURN_BATCH
    (config/autodecoder.json, config/ae_art.json, phase 9's scene), fp32 and
    bf16 in turns (fp32, bf16, bf16, fp32), each one timed dispatch of 2
    steps after an untimed one, from the seed's weights; and each mode's
    peak device memory."""
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    out = {}
    for name, make in (("autodecoder", _autodecoder_config), ("ae_art", _ae_config)):
        cfg_path = make(os.path.join(tmp, "multi"), os.path.join(tmp, "turns"))
        ms, peak = {"fp32": [], "bf16": []}, {"fp32": 0.0, "bf16": 0.0}
        for dtype in ("f32", "bf16", "bf16", "f32"):
            cfg = load_config(cfg_path, {"compute_dtype": dtype, "exp_name": f"turn_{name}_{dtype}",
                                         "batch_size": TURN_BATCH, "inner_steps": 2})
            trainer = Trainer(cfg)
            buffers = trainer.train_buffers()
            torch.cuda.reset_peak_memory_stats()
            trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)
            torch.cuda.synchronize()
            mode = "fp32" if dtype == "f32" else "bf16"
            ms[mode].append((time.perf_counter() - t0) * 1e3 / trainer._inner_steps)
            peak[mode] = max(peak[mode], torch.cuda.max_memory_allocated() / 1e9)
            trainer.close()
            del trainer, buffers
            torch.cuda.empty_cache()
        print(f"articulated step at batch {TURN_BATCH}, {name} (config/{name}.json, phase 9's scene), in turns fp32, "
              f"bf16, bf16, fp32 (2 steps a dispatch, host clock): fp32 {', '.join(f'{x:.3f}' for x in ms['fp32'])} "
              f"ms, bf16 {', '.join(f'{x:.3f}' for x in ms['bf16'])} ms; peak device memory fp32 {peak['fp32']:.3f} "
              f"GB, bf16 {peak['bf16']:.3f} GB")
        out[name] = {"ms": ms, "peak_gb": peak}
    return out


def _recording(module, name: str, sink: list, pick=lambda out: out[0]):
    """mock.patch of module.name that records pick(output) of each call and
    changes nothing."""
    real = getattr(module, name)

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        sink.append(pick(out))
        return out

    return mock.patch.object(module, name, recorded)


def _fell(losses) -> tuple:
    loss = torch.stack(list(losses)).float().cpu().numpy()
    n = max(1, len(loss) // 4)
    first, last = float(loss[:n].mean()), float(loss[-n:].mean())
    return first, last, bool(np.isfinite(loss).all() and last < first)


def phase_optimizers(tmp: str, root: str) -> dict:
    """The reference's optimizers and schedules through Trainer.fit on phase
    7's scene (config/vanilla.json, fp32), each OPT_STEPS steps; the ranger
    run resumes from its checkpoint at OPT_STEPS // 2; then the
    auto-decoder with latent_lr on phase 9's scene."""
    from aonerf_torch.train import step as step_mod
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.ckpt import CheckpointManager
    from aonerf_torch.utils.config import load_config

    t_phase = time.perf_counter()
    base = {"root_dir": root, "output_path": os.path.join(tmp, "opt"), "img_wh": [W, H], "seed": SEED,
            "val_every_steps": 1000, "ckpt_every_steps": OPT_STEPS // 2, "steps_per_epoch": 5, "num_epochs": 4}
    vanilla = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", "vanilla.json")
    out = {}
    for name, settings in OPT_RUNS.items():
        cfg = load_config(vanilla, {**base, **settings, "exp_name": name})
        losses = []
        _reset_fused_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _recording(step_mod, "vanilla_loss_and_grads", losses):
            trainer = Trainer(cfg)
            if name == "ranger_poly":  # a checkpoint half way, and a resume from it
                trainer.fit(max_steps=OPT_STEPS // 2)
                trainer.close()
                saved = CheckpointManager(os.path.join(trainer.run_dir, "ckpts")).restore(OPT_STEPS // 2)
                trainer = Trainer(cfg)
                names = list(trainer.state.params)
                slow = trainer.state.opt_state.slots["slow"]
                same = trainer.state.step == OPT_STEPS // 2 and all(
                    torch.equal(t.cpu(), saved["opt_state"]["slow"][n]) for t, n in zip(slow, names))
                moved = any(not torch.equal(saved["opt_state"]["slow"][n], saved["params"][n]) for n in names)
                if not (same and moved):
                    fail(f"{name}: the resumed slow weights differ from the saved ones (equal {same}; "
                         f"synced off the parameters {moved})")
                print(f"  {name}: resumed at step {trainer.state.step}, the slow weights of {len(names)} parameters "
                      f"equal to the checkpoint's (torch.equal)")
            trainer.fit(max_steps=OPT_STEPS)
            lrs = [trainer.lr_fn(s) for s in (0, OPT_STEPS // 2, OPT_STEPS - 1)]
            slots = sorted(trainer.state.opt_state.slots)
            trainer.close()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        _, k1s, k2 = _fused_launches()
        first, last, fell = _fell(losses)
        print(f"optimizer {name}: {len(losses)} steps at batch {cfg.batch_size} ({seconds:.1f} s), loss first "
              f"{first:.5f} last {last:.5f} (fell {fell}), lr at steps 0/{OPT_STEPS // 2}/{OPT_STEPS - 1} "
              f"{lrs[0]:.6g}/{lrs[1]:.6g}/{lrs[2]:.6g}, slots {slots}, launches K1s {k1s} K2 {k2}")
        if len(losses) != OPT_STEPS or not fell:
            fail(f"{name}: {len(losses)} steps, loss fell {fell}")
        if k1s != 2 * OPT_STEPS or k2 != 2 * OPT_STEPS:
            fail(f"{name}: K1s {k1s} and K2 {k2} launches, expected {2 * OPT_STEPS} each")
        out[name] = {"k1s": k1s, "k2": k2, "loss": [first, last], "lr": lrs, "seconds": seconds}

    cfg_path = _autodecoder_config(os.path.join(tmp, "multi"), os.path.join(tmp, "opt"))
    cfg = load_config(cfg_path, {"latent_lr": 1e-3, "exp_name": "latent_lr", "val_every_steps": 1000,
                                 "ckpt_every_steps": 1000})
    losses = []
    t0 = time.perf_counter()
    with _recording(step_mod, "autodecoder_loss_and_grads", losses):
        trainer = Trainer(cfg)
        trainer.fit(max_steps=OPT_STEPS)
        tx = trainer.tx
        lrs = [trainer.lr_fn(s) for s in (0, OPT_STEPS // 2, OPT_STEPS - 1)]
        trainer.close()
    torch.cuda.synchronize()
    first, last, fell = _fell(losses)
    print(f"optimizer autodecoder latent_lr: {len(losses)} steps at batch {cfg.batch_size} "
          f"({time.perf_counter() - t0:.1f} s), loss first {first:.5f} last {last:.5f} (fell {fell}), field lr at "
          f"steps 0/{OPT_STEPS // 2}/{OPT_STEPS - 1} {lrs[0]:.6g}/{lrs[1]:.6g}/{lrs[2]:.6g}, codes lr "
          f"{tx.codes_tx.schedule(0):.6g} ({type(tx).__name__}: {tx.n_model} field parameters)")
    if len(losses) != OPT_STEPS or not fell or tx.codes_tx.schedule(0) != 1e-3:
        fail(f"auto-decoder with latent_lr: {len(losses)} steps, loss fell {fell}")
    out["autodecoder_latent_lr"] = {"loss": [first, last], "lr": lrs}
    print(f"  phase optimizers: {time.perf_counter() - t_phase:.1f} s")
    return out


def _busy_ms(fn, n_steps: int) -> tuple:
    """(wall ms, device busy ms) a step of fn() under torch.profiler, the
    busy time the sum of its kernels' device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kernels = (e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall / n_steps, sum(_dev_us(e) for e in kernels) / 1e3 / n_steps


def phase_encode_reuse(tmp: str) -> dict:
    """config/ae_art.json with ae_encode_reuse REUSE, inner_steps REUSE_INNER
    on phase 9's scene: two dispatches with the frozen partition checked on
    the card around every field-only step, then the step's cost beside
    ae_encode_reuse 1, in turns."""
    from aonerf_torch.train import step_ae
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    t_phase = time.perf_counter()
    cfg_path = _ae_config(os.path.join(tmp, "multi"), os.path.join(tmp, "reuse"))
    settings = {"inner_steps": REUSE_INNER, "val_every_steps": 1000, "ckpt_every_steps": 1000}
    cfg = load_config(cfg_path, {**settings, "ae_encode_reuse": REUSE, "exp_name": "reuse"})
    checked, broken = [], []
    real = step_ae.masked_field_update

    def checked_update(tx, params, grads, opt_state):
        # the frozen partition and its moments before and after: bit for bit
        frozen = [i for i, m in enumerate(step_ae.field_update_mask(params)) if not m]
        values = list(params.values())
        before = [(values[i].clone(), *(opt_state.slots[k][i].clone() for k in sorted(opt_state.slots)))
                  for i in frozen]
        new = real(tx, params, grads, opt_state)
        after = [(values[i], *(new.slots[k][i] for k in sorted(new.slots))) for i in frozen]
        same = all(torch.equal(a, b) for x, y in zip(before, after) for a, b in zip(x, y))
        checked.append(len(frozen))
        if not same or new.count != opt_state.count + 1:
            broken.append(opt_state.count)
        return new

    field_losses, full_losses = [], []
    with mock.patch.object(step_ae, "masked_field_update", checked_update), \
            _recording(step_ae, "ae_field_loss_and_grads", field_losses), \
            _recording(step_ae, "ae_loss_and_grads", full_losses):
        trainer = Trainer(cfg)
        buffers = trainer.train_buffers()
        for _ in range(2):
            trainer.state, metrics = trainer.step_fn(trainer.state, buffers, cfg.seed)
        torch.cuda.synchronize()
    n_groups = 2 * REUSE_INNER // REUSE
    first, last, fell = _fell(field_losses)
    print(f"encode reuse {REUSE}, inner_steps {REUSE_INNER}: {trainer.state.step} steps in 2 dispatches, "
          f"{len(full_losses)} full steps and {len(field_losses)} field-only steps; frozen partition "
          f"({checked[0] if checked else 0} parameters and their mu/nu) bit for bit unchanged on "
          f"{len(checked) - len(broken)} of {len(checked)} field-only steps; field-only loss first {first:.5f} last "
          f"{last:.5f} (fell {fell}); last group's loss {float(metrics['loss']):.5f}, lr {metrics['lr']:.6g}")
    if broken or len(checked) != n_groups * (REUSE - 1) or len(full_losses) != n_groups or not fell:
        fail(f"encode reuse: frozen partition moved on steps {broken}, {len(checked)} field-only steps checked, "
             f"{len(full_losses)} full steps, field-only loss fell {fell}")

    # the step's cost in turns, on that trainer and one with ae_encode_reuse 1
    # (after an untimed dispatch): host ms of a synchronized dispatch, then
    # the card's busy ms a step by torch.profiler over one more
    trainers = {REUSE: trainer, 1: Trainer(load_config(cfg_path, {**settings, "exp_name": "turn_1"}))}
    trainers[1].state, _ = trainers[1].step_fn(trainers[1].state, buffers, cfg.seed)
    ms = {REUSE: [], 1: []}
    for reuse in (REUSE, 1, 1, REUSE):
        tr = trainers[reuse]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.state, _ = tr.step_fn(tr.state, buffers, cfg.seed)
        torch.cuda.synchronize()
        ms[reuse].append((time.perf_counter() - t0) * 1e3 / REUSE_INNER)
    busy = {}
    for reuse, tr in trainers.items():

        def dispatch():
            tr.state, _ = tr.step_fn(tr.state, buffers, cfg.seed)

        busy[reuse] = _busy_ms(dispatch, REUSE_INNER)[1]
        tr.close()
    del trainers, trainer, buffers
    torch.cuda.empty_cache()
    fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)  # noqa: E731
    print(f"  in turns (reuse {REUSE}, 1, 1, {REUSE}; {REUSE_INNER} steps a dispatch at batch {cfg.batch_size}): "
          f"host ms a step reuse {REUSE} {fmt(ms[REUSE])}, reuse 1 {fmt(ms[1])}; card busy ms a step "
          f"(torch.profiler) reuse {REUSE} {busy[REUSE]:.3f}, reuse 1 {busy[1]:.3f}; idle share reuse {REUSE} "
          f"{100 * max(0.0, 1 - busy[REUSE] / min(ms[REUSE])):.1f}%, reuse 1 "
          f"{100 * max(0.0, 1 - busy[1] / min(ms[1])):.1f}%")
    print(f"  phase encode reuse: {time.perf_counter() - t_phase:.1f} s")
    return {"host_ms": ms, "busy_ms": busy, "field_steps_checked": len(checked)}


def phase_ragged(tmp: str) -> dict:
    """Phase 9's scene with one instance's 10-degree views removed:
    Trainer.fit on the host-batched step behind the prefetcher, then
    --run_eval on 2 sweep poses."""
    import shutil

    from aonerf_torch.cli import train as cli
    from aonerf_torch.train import step_ae
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "ragged")
    shutil.copytree(os.path.join(tmp, "multi"), root)
    second = sorted(os.listdir(root))[1]
    shutil.rmtree(os.path.join(root, second, "train", "10_degree"))
    cfg_path = _ae_config(root, os.path.join(tmp, "ragged_out"))
    cfg = load_config(cfg_path, {"val_every_steps": 1000, "ckpt_every_steps": 1000})
    losses = []
    with _recording(step_ae, "ae_loss_and_grads", losses):
        trainer = Trainer(cfg)
        try:
            trainer.train_buffers()
            fail("the ragged scene has uniform device buffers")
        except ValueError:
            pass
        trainer.fit(max_steps=2)  # the first steps, untimed
        # the timed and profiled fits leave out the checkpoint fit writes at
        # its end (a copy of ~0.6 GB to the host and a file)
        with mock.patch.object(trainer.ckpt, "save", lambda *args, **kwargs: None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.fit(max_steps=RAGGED_STEPS)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / (RAGGED_STEPS - 2)
            n_prof = 4
            wall_ms, busy_ms = _busy_ms(lambda: trainer.fit(max_steps=RAGGED_STEPS + n_prof), n_prof)
        trainer.ckpt.save(trainer.state.step, trainer._state_dict())  # for --run_eval
        steps = trainer.state.step
        trainer.close()
    first, last, fell = _fell(losses[:RAGGED_STEPS])
    print(f"ragged dataset (instance {second} without 10_degree): {steps} host-batched steps at batch "
          f"{cfg.batch_size}, loss first {first:.5f} last {last:.5f} (fell {fell}); host ms a step "
          f"{host_ms:.3f} (steps 3-{RAGGED_STEPS}, batches assembled by the prefetcher's thread), card busy "
          f"{busy_ms:.3f} ms a step (torch.profiler over {n_prof} steps, {wall_ms:.3f} ms a step profiled): idle "
          f"{100 * max(0.0, 1 - busy_ms / host_ms):.1f}%")
    if steps != RAGGED_STEPS + n_prof or len(losses) != steps or not fell:
        fail(f"ragged dataset: {steps} steps, {len(losses)} losses, loss fell {fell}")
    stats = cli.main(["--config", cfg_path, "--run_eval", "--test_sweep_poses", "2"])
    psnr = stats["psnr"]["test"]
    files = sorted(os.listdir(os.path.join(cfg.output_path, cfg.exp_name, cfg.render_name)))
    print(f"  --run_eval on 2 sweep poses: psnr {psnr:.3f}, psnr_obj {stats['psnr_obj']['test']:.3f}, "
          f"{len(files)} render files")
    if not np.isfinite(psnr) or not any(f.startswith("image") for f in files):
        fail("ragged dataset: --run_eval gave no finite psnr or no images")
    print(f"  phase ragged: {time.perf_counter() - t_phase:.1f} s")
    return {"host_ms": host_ms, "busy_ms": busy_ms, "loss": [first, last]}


NOISE_STD = 1.0  # phases 21-22: noise_std as in config files that set it
NOISE_STEPS = 20  # phase 22's steps; phase 23 runs as many with is_optimize
PROFILE_STEPS = 5  # phase 23's profile_steps (and its steps_per_epoch)


def _noise(R: int, S: int, seed: int):
    """A level's sigma noise, uniform(0, 1) x NOISE_STD from a seed, (R, S) fp32 on the card."""
    u = np.random.default_rng(seed).uniform(size=(R, S)).astype(np.float32)
    return torch.from_numpy(u).cuda() * NOISE_STD


def _noisy_fwd_plain(args, white: bool, noise, mm=torch.matmul, dot_bf16: bool = False):
    from aonerf_torch.ops.kernels import fused_train as ft

    return ft.fused_level_fwd_spill_ref(*args, white, mm=mm, dot_bf16=dot_bf16, noise=noise)


def phase_noise_kernels(nerf, boxes, focal) -> dict:
    """K1s with sigma noise (noise_std 1.0 from a seed) at the train step's
    2048 rays, S = 65 and 193, in fp32 and bf16 mode: raw sigma exactly the
    noiseless call's plus the noise, everything else of the noiseless
    call's bits, a zero noise the noiseless bits; the outputs and raw
    against the plain version with the same noise (fp32: within TOL; bf16:
    the bf16 rule); K2 from the noisy saved and raw against its plain
    version from the same saved and raw (fp32: the per-gradient rule; bf16:
    the bf16 rule); K1s with and without noise timed in turns."""
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    t_phase = time.perf_counter()
    dev, R, white = torch.device("cuda"), R_TRAIN, True
    names = fr.WEIGHT_NAMES
    levels = []
    for dot_bf16 in (False, True):
        mode = "bf16" if dot_bf16 else "fp32"
        o, d, lvls = _train_levels(nerf, boxes, focal, dot_bf16=dot_bf16)
        for kp, t, venc, xenc in lvls:
            S = t.shape[1]
            args = (kp, t, o, d, venc, xenc)
            args64 = ({n: v.double() for n, v in kp.items()}, *(a.double() for a in (t, o, d, venc, xenc)))
            noise = _noise(R, S, SEED + 600 + S)
            quiet = ft.fused_level_fwd_spill(*args, white, dot_bf16=dot_bf16)
            zero = ft.fused_level_fwd_spill(*args, white, dot_bf16=dot_bf16, noise=torch.zeros_like(noise))
            got = ft.fused_level_fwd_spill(*args, white, dot_bf16=dot_bf16, noise=noise)
            again = ft.fused_level_fwd_spill(*args, white, dot_bf16=dot_bf16, noise=noise)
            torch.cuda.synchronize()
            what = f"K1s {mode} with noise S={S}"
            for i, n in enumerate(OUTPUTS + ("saved", "raw")):
                if not torch.isfinite(got[i]).all():
                    fail(f"{what}: non-finite {n}")
                if not torch.equal(got[i], again[i]):
                    fail(f"{what}: a repeat call gave other bits on {n}")
                if not torch.equal(zero[i], quiet[i]):
                    fail(f"{what}: a zero noise changed {n} from the noiseless call's bits")
            if not torch.equal(got[4], quiet[4]) or not torch.equal(got[5][:, 1:], quiet[5][:, 1:]):
                fail(f"{what}: the noise changed the saved activations or raw rgb")
            if not torch.equal(got[5][:, 0], quiet[5][:, 0] + noise.reshape(-1)):
                fail(f"{what}: raw sigma is not the noiseless raw sigma plus the noise (one fp32 add)")
            del zero, again
            plain = _noisy_fwd_plain(args, white, noise, dot_bf16=dot_bf16)
            errs = {n: (g.float() - p.float()).abs().max().item()
                    for n, g, p in zip(OUTPUTS + ("raw",), got[:4] + got[5:], plain[:4] + plain[5:])}
            if dot_bf16:  # comp/acc/depth/weights and raw: the bf16 rule
                def outputs(run):
                    return {**dict(zip(OUTPUTS, run[:4])), "raw": run[5]}

                orders = {k: outputs(_noisy_fwd_plain(args, white, noise, mm, True)) for k, mm in BF16_ORDERS.items()}
                ref = outputs(_noisy_fwd_plain(args64, white, noise.double(), dot_bf16=True))
                ratios = bf16_ratios(outputs(got), ref, bf16_limits(orders, ref, TOL_BF16_FWD))
                del orders, ref
                bad = sorted(n for n, r in ratios.items() if not r <= 1.0)
                fwd_ratio = max(ratios.values())
                rule = "bf16 rule, error / limit " + ", ".join(f"{n} {r:.3f}" for n, r in ratios.items())
            else:
                bad = sorted(n for n, v in errs.items() if not v <= TOL[n])
                fwd_ratio = max(v / TOL[n] for n, v in errs.items())
                rule = "within TOL"
            print(f"kernel fused_level_fwd_spill {mode} with noise (noise_std {NOISE_STD:g}) S={S} at {R} rays: "
                  f"raw sigma = the noiseless raw sigma + the noise bit for bit, saved and raw rgb the noiseless "
                  f"bits, a zero noise the noiseless bits, a repeat call the same bits; max abs err against the "
                  f"plain version with the same noise " + ", ".join(f"{n} {v:.3e}" for n, v in errs.items())
                  + f" ({rule})")
            if bad:
                fail(f"{what}: off its plain version with the same noise on {bad}")

            rng = np.random.default_rng(SEED + 700 + S)
            cot = tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
                rng.standard_normal((R, 3)), rng.standard_normal(R), 0.1 * rng.standard_normal(R),
                rng.standard_normal((R, S))))
            cot64 = tuple(c.double() for c in cot)
            saved, raw = got[4], got[5]
            k2 = ft.fused_level_bwd_saved(*args, saved, raw, *cot, white, dot_bf16=dot_bf16)
            torch.cuda.synchronize()
            del got, plain
            if not all(torch.isfinite(k2[n]).all() for n in names):
                fail(f"K2 {mode} from noisy K1s S={S}: a non-finite gradient")

            def k2_plain(a, c, mm=torch.matmul, dtype=torch.float32):  # from K1s' noisy saved and raw
                return ft.fused_level_bwd_saved_ref(*a, saved, raw.to(dtype), *c, white, mm=mm, dot_bf16=dot_bf16)

            if dot_bf16:
                orders = {k: k2_plain(args, cot, mm) for k, mm in BF16_ORDERS.items()}
                ref = k2_plain(args64, cot64, dtype=torch.float64)
                ratios = bf16_ratios(k2, ref, bf16_limits(orders, ref, TOL_BF16_GRAD))
                k2_err = max((k2[n] - orders["cuBLAS"][n]).abs().max().item() for n in names)
                del orders, ref
                worst = max(ratios, key=ratios.get)
                k2_ratio = ratios[worst]
                print(f"  K2 bf16 from the noisy saved and raw S={S}: bf16 rule, closest to its limit {worst} "
                      f"{k2_ratio:.3f}; max abs err against the plain bf16 version {k2_err:.3e}")
                if not k2_ratio <= 1.0:
                    fail(f"K2 bf16 from noisy K1s S={S}: beyond the bf16 rule on "
                         f"{sorted(n for n, r in ratios.items() if r > 1.0)}")
            else:
                p32, p64 = k2_plain(args, cot), k2_plain(args64, cot64, dtype=torch.float64)
                k2_err = max((k2[n] - p32[n]).abs().max().item() for n in names)
                k2_ratio = _check_grads(f"K2 fp32 from the noisy saved and raw S={S}", _grad_errors(k2, p64, names),
                                        _grad_errors(p32, p64, names))
                del p32, p64
            del k2, args64, saved, raw
            torch.cuda.empty_cache()
            k1s_quiet = lambda: ft.fused_level_fwd_spill(*args, white, dot_bf16=dot_bf16)  # noqa: E731
            k1s_noisy = lambda: ft.fused_level_fwd_spill(*args, white, dot_bf16=dot_bf16, noise=noise)  # noqa: E731
            iters = 10 if S > 100 else 20
            ms_q = cuda_ms(k1s_quiet, warmup=2, iters=iters)
            ms_n = cuda_ms(k1s_noisy, warmup=2, iters=iters)
            ms_n2 = cuda_ms(k1s_noisy, warmup=0, iters=iters)
            ms_q2 = cuda_ms(k1s_quiet, warmup=0, iters=iters)
            print(f"  S={S}: K1s {mode} with noise {ms_n:.3f} / {ms_n2:.3f} ms, without {ms_q:.3f} / {ms_q2:.3f} ms "
                  f"(CUDA events, in turns: without, with, with, without)")
            levels.append({"mode": mode, "S": S, "ms": ms_n, "ms_again": ms_n2, "ms_without_noise": ms_q,
                           "ms_without_noise_again": ms_q2, "max_abs_err": max(errs.values()),
                           "fwd_ratio": fwd_ratio, "k2_ratio": k2_ratio, "k2_max_abs_err": k2_err})
        del o, d, lvls
    print(f"  phase noise kernels: {time.perf_counter() - t_phase:.1f} s")
    return {"levels": levels}


def phase_noise_training(root: str, tmp: str) -> dict:
    """config/vanilla.json with noise_std 1.0 on phase 7's scene: NOISE_STEPS
    steps through Trainer.fit, the loss falling, K1s and K2 launched once a
    level a step, a noise draw a level a step."""
    from aonerf_torch.ops.random import Draws
    from aonerf_torch.train import step as step_mod
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    t_phase = time.perf_counter()
    vanilla = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", "vanilla.json")
    cfg = load_config(vanilla, {"root_dir": root, "output_path": os.path.join(tmp, "noise"), "exp_name": "noise",
                                "img_wh": [W, H], "seed": SEED, "lr_init": 1e-3, "lr_delay_steps": 0,
                                "noise_std": NOISE_STD, "val_every_steps": 1000, "ckpt_every_steps": 1000})
    losses, draws = [], []
    _reset_fused_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _recording(step_mod, "vanilla_loss_and_grads", losses), \
            _recording(Draws, "noise", draws, pick=lambda out: tuple(out.shape)):
        trainer = Trainer(cfg)
        trainer.fit(max_steps=NOISE_STEPS)
        trainer.close()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1, k1s, k2 = _fused_launches()
    first, last, fell = _fell(losses)
    print(f"noise training: config/vanilla.json with noise_std {NOISE_STD:g}, {len(losses)} steps at batch "
          f"{cfg.batch_size} ({seconds:.1f} s), loss first {first:.5f} last {last:.5f} (fell {fell}); launches K1 "
          f"{k1}, K1s {k1s}, K2 {k2} (expected 0, {2 * NOISE_STEPS}, {2 * NOISE_STEPS}); noise draws {len(draws)} "
          f"of shapes {sorted(set(draws))}")
    if len(losses) != NOISE_STEPS or not fell:
        fail(f"noise training: {len(losses)} steps, loss fell {fell}")
    if (k1, k1s, k2) != (0, 2 * NOISE_STEPS, 2 * NOISE_STEPS) or len(draws) != 2 * NOISE_STEPS:
        fail("noise training did not launch K1s and K2, or draw the noise, once a level a step")
    print(f"  phase noise training: {time.perf_counter() - t_phase:.1f} s")
    return {"k1s": k1s, "k2": k2, "loss": [first, last], "seconds": seconds}


def phase_settings(root: str, tmp: str) -> dict:
    """On phase 7's scene, config/vanilla.json at inner_steps 5: is_optimize
    with profile_steps 5 (a checkpoint every steps_per_epoch = 5 steps, all
    kept; a torch.profiler trace of the first 5 steps and its device-op
    table), then debug_nans: a NaN planted in a weight raises
    FloatingPointError, the same run without it trains."""
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config
    from aonerf_torch.utils.profile import device_op_table, latest_trace, timed_ops

    t_phase = time.perf_counter()
    vanilla = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", "vanilla.json")
    base = {"root_dir": root, "output_path": os.path.join(tmp, "settings"), "img_wh": [W, H], "seed": SEED,
            "lr_init": 1e-3, "lr_delay_steps": 0, "inner_steps": PROFILE_STEPS, "limit_val_batches": 1}
    cfg = load_config(vanilla, {**base, "exp_name": "optimize", "is_optimize": True, "ckpt_keep": 1,
                                "steps_per_epoch": PROFILE_STEPS, "val_every_steps": PROFILE_STEPS,
                                "profile_steps": PROFILE_STEPS})
    trainer = Trainer(cfg)
    trainer.fit(max_steps=NOISE_STEPS)
    steps, kept_all = trainer.ckpt.steps(), trainer.ckpt.keep is None
    trainer.close()
    trace_dir = os.path.join(trainer.run_dir, "profile")
    path = latest_trace(trace_dir)
    what, times = timed_ops(path) if path else ("", {})
    table = device_op_table(trace_dir, top_k=8)
    fwd = sum(c for n, (_, c) in times.items() if "level_fwd_spill_kernel" in n)
    bwd = {n: c for n, (_, c) in times.items() if "level_bwd_" in n}
    print(f"settings: is_optimize with profile_steps {PROFILE_STEPS}: checkpoints at steps {steps} (every "
          f"steps_per_epoch = {cfg.ckpt_every_steps}, all kept: {kept_all}); trace {os.path.basename(path or '')}, "
          f"level_fwd_spill_kernel x{fwd}, level_bwd_* " + ", ".join(f"{_kernel_name(n)} x{c}" for n, c in bwd.items()))
    print("  device_op_table:\n" + "\n".join("    " + line for line in table.splitlines()))
    expected = list(range(PROFILE_STEPS, NOISE_STEPS + 1, PROFILE_STEPS))
    if steps != expected or not kept_all or cfg.ckpt_every_steps != PROFILE_STEPS:
        fail(f"is_optimize: checkpoints {steps}, expected {expected} all kept")
    if what != "device" or fwd != 2 * PROFILE_STEPS or not bwd or "level_fwd_spill_kernel" not in table:
        fail(f"profile_steps: the trace's device ops lack K1s ({fwd} launches) or K2's kernels ({sorted(bwd)})")

    nan_cfg = load_config(vanilla, {**base, "exp_name": "nans", "debug_nans": True, "val_every_steps": 1000,
                                    "ckpt_every_steps": 1000})
    trainer = Trainer(nan_cfg)
    with torch.no_grad():
        trainer.state.params["coarse_mlp.pts_3.weight"].view(-1)[7] = float("nan")
    try:
        trainer.fit(max_steps=PROFILE_STEPS)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    at_step = trainer.state.step
    trainer.close()
    clean = Trainer(load_config(vanilla, {**base, "exp_name": "clean", "debug_nans": True, "val_every_steps": 1000,
                                          "ckpt_every_steps": 1000}))
    last = clean.fit(max_steps=PROFILE_STEPS)
    clean_steps = clean.state.step
    clean.close()
    where = "a level's outputs" if raised and "level's" in raised else "not the level outputs"
    print(f"  debug_nans: a NaN planted in coarse_mlp.pts_3.weight raised FloatingPointError ({raised!r}: at "
          f"{where}, as JAX and the CPU raise) with the state at step {at_step}; without it {clean_steps} steps, "
          f"loss {last.get('loss')}")
    if raised is None or at_step != 0 or "level's" not in raised:
        fail("debug_nans did not raise at the level outputs of the first step on a planted NaN")
    if clean_steps != PROFILE_STEPS or not np.isfinite(last.get("loss", float("nan"))):
        fail("debug_nans: the run without a NaN did not train")
    print(f"  phase settings: {time.perf_counter() - t_phase:.1f} s")
    return {"ckpt_steps": steps, "fwd_launches_traced": fwd, "table": table.splitlines()[:4]}


LPIPS_SEED = SEED + 800


def phase_lpips_test(cfg_path: str, tmp: str) -> dict:
    """--run_eval on phase 7's checkpoint with AONERF_LPIPS_WEIGHTS naming a
    synthetic weights file at VGG16's widths from a seed: results.json's
    lpips finite, test view 0's LPIPS on the card within 1e-4 relative of
    the plain CPU computation of the same images, and test()'s seconds a
    view with and without LPIPS."""
    from aonerf_torch.cli import train as cli
    from aonerf_torch.eval import lpips
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    t_phase = time.perf_counter()
    weights = os.path.join(tmp, "lpips_vgg16_random.npz")
    lpips.write_random_weights(weights, LPIPS_SEED)
    cfg = load_config(cfg_path, {"run_eval": True, "render_name": "render_lpips"})
    with mock.patch.dict(os.environ, {"AONERF_LPIPS_WEIGHTS": weights}):
        stats = cli.main(["--config", cfg_path, "--run_eval", "--save_path", "render_lpips"])
        trainer = Trainer(cfg)
        (rgb, _, _), target, _ = trainer._test_view(0)
        img, tgt = rgb.reshape(H, W, 3), torch.from_numpy(target).cuda().reshape(H, W, 3)
        on_card = float(lpips.lpips_distance(lpips.load_weights(weights), img, tgt))
        on_cpu = float(lpips.lpips_distance(lpips.load_weights(weights, "cpu"), img.cpu(), tgt.cpu()))
        seconds = {}
        for name, env in (("with", {"AONERF_LPIPS_WEIGHTS": weights}), ("without", {"AONERF_LPIPS_WEIGHTS": ""})):
            with mock.patch.dict(os.environ, env):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = trainer.test()
                torch.cuda.synchronize()
                seconds[name] = (time.perf_counter() - t0) / N_TEST
                if (name == "with") != np.isfinite(out["lpips"]["test"]):
                    fail(f"test() {name} LPIPS weights: lpips {out['lpips']}")
        trainer.close()
    rel = abs(on_card - on_cpu) / abs(on_cpu)
    value = stats["lpips"]["test"]
    print(f"lpips test: --run_eval with random VGG16-width LPIPS weights (seed {LPIPS_SEED}): results.json lpips "
          f"{value}, psnr {stats['psnr']['test']:.4f}; view 0's LPIPS on the card {on_card:.9f}, on the CPU "
          f"{on_cpu:.9f} (rel diff {rel:.2e}, tol 1e-4); test() {seconds['with']:.4f} s a view with LPIPS, "
          f"{seconds['without']:.4f} s without")
    if list(stats["lpips"]) != ["test"] or not np.isfinite(value):
        fail(f"lpips test: results.json lpips {stats['lpips']}")
    if not rel <= 1e-4:
        fail("lpips test: view 0's LPIPS on the card disagrees with the CPU's")
    print(f"  phase lpips test: {time.perf_counter() - t_phase:.1f} s")
    return {"lpips": value, "view0_card": on_card, "view0_cpu": on_cpu, "seconds_per_view": seconds}


# Where one NaN is planted and, after the place, its bits where they are not
# torch's NaN (0x7fc00000): 0x7fffffff is the NaN the card's arithmetic gives
# (an Adam update gone NaN), 0xffffffff its negation; split into TF32 halves
# on the integer pipe either would round to a zero. "xenc": the encoded
# input of one sample, as the card's sin gives it for a NaN sample point.
NAN_CASES = ("trunk", "view", "cotangent", "trunk 0x7fffffff", "view 0xffffffff", "cotangent 0x7fffffff",
             "xenc 0x7fffffff")
XENC_NAN_RAY, XENC_NAN_SAMPLE = 3, 5  # the sample whose encoded input the "xenc" case makes NaN


def plant_nan(kp: dict, cot: tuple, case: str, xenc: torch.Tensor):
    """Copies of a level's kernel params, cotangents and encoded samples
    (R*S or (R, S) rows) with one NaN of the case's bits: in the trunk (w3,
    input 7 to unit 11), in the view branch (wva, bottleneck input 5 to unit
    9), in ray 2's acc cotangent, or in feature width // 2 of sample
    XENC_NAN_SAMPLE of ray XENC_NAN_RAY's encoded input."""
    kp = {n: v.clone() for n, v in kp.items()}
    cot = tuple(c.clone() for c in cot)
    xenc = xenc.clone()
    place, _, bits = case.partition(" ")
    S = cot[3].shape[1]
    rows = xenc.view(-1, xenc.shape[-1])
    target = {"trunk": (kp["w3"], (7, 11)), "view": (kp["wva"], (5, 9)), "cotangent": (cot[1], (2,)),
              "xenc": (rows, (XENC_NAN_RAY * S + XENC_NAN_SAMPLE, rows.shape[1] // 2))}[place]
    target[0].view(torch.int32)[target[1]] = int(np.array(int(bits or "0x7fc00000", 16), np.uint32).view(np.int32))
    if not torch.isnan(target[0][target[1]]):
        fail(f"plant_nan: {case} planted no NaN")
    return kp, cot, xenc


def _finite_part(out: dict, masks: dict) -> dict:
    """Each tensor with its NaN entries (by the kernel's masks) set to 0,
    for the rules, which hold the finite entries."""
    return {n: torch.where(masks[n], torch.zeros_like(v), v) for n, v in out.items()}


def _nan_masks(what: str, got: dict, want: dict) -> dict:
    """The kernel's isnan masks, failed unless equal to the plain version's."""
    masks = {}
    for n, g in got.items():
        masks[n] = torch.isnan(g)
        if not torch.equal(masks[n], torch.isnan(want[n])):
            fail(f"{what}: {n} is NaN at {int(masks[n].sum())} entries, its plain version at "
                 f"{int(torch.isnan(want[n]).sum())}; {int((masks[n] != torch.isnan(want[n])).sum())} differ")
    return masks


def phase_nan_kernels(nerf, boxes, focal) -> dict:
    """K1 at the serving tile's 4096 rays, K1s and K2 at the train step's
    2048, S = 65 and 193, fp32 and bf16 mode, with one NaN planted in a
    trunk weight, then in a view-branch weight, in one sample's encoded
    input, and (K2) in a cotangent:
    each output and gradient NaN exactly where its plain version's is, its
    finite entries held to the plain versions under the existing rules
    (fp32: TOL and K2's per-gradient rule; bf16: the bf16 rule)."""
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    t_phase = time.perf_counter()
    white, rows = True, []
    for dot_bf16 in (False, True):
        mode = "bf16" if dot_bf16 else "fp32"
        for R_k, kernel in ((R, "K1"), (R_TRAIN, "K1s+K2")):
            o, d, lvls = _train_levels(nerf, boxes, focal, R=R_k, seed=SEED + 900, dot_bf16=dot_bf16)
            for kp0, t, venc, xenc in lvls:
                S = t.shape[1]
                rng = np.random.default_rng(SEED + 901 + S)
                cot0 = tuple(torch.from_numpy(a.astype(np.float32)).cuda() for a in (
                    rng.standard_normal((R_k, 3)), rng.standard_normal(R_k), 0.1 * rng.standard_normal(R_k),
                    rng.standard_normal((R_k, S))))
                for case in NAN_CASES if kernel != "K1" else [c for c in NAN_CASES if not c.startswith("cotangent")]:
                    kp, cot, xe = plant_nan(kp0, cot0, case, xenc)
                    args = (kp, t, o, d, venc, xe)
                    args64 = ({n: v.double() for n, v in kp.items()}, *(a.double() for a in (t, o, d, venc, xe)))
                    what = f"{kernel} {mode} S={S} NaN in the {case}"
                    if kernel == "K1":
                        got = dict(zip(OUTPUTS, fr.fused_render_level(*args, white, dot_bf16=dot_bf16)))
                        plain = lambda a, mm=torch.matmul: dict(zip(OUTPUTS, fr.fused_render_level_ref(  # noqa: E731
                            *a, white, mm=mm, dot_bf16=dot_bf16)))
                    else:
                        fwd = ft.fused_level_fwd_spill(*args, white, dot_bf16=dot_bf16)
                        saved, raw = fwd[4], fwd[5]
                        got = {**dict(zip(OUTPUTS, fwd[:4])),
                               **ft.fused_level_bwd_saved(*args, saved, raw, *cot, white, dot_bf16=dot_bf16)}
                        del fwd

                        def plain(a, mm=torch.matmul, c=cot, saved=saved, raw=raw):
                            f = ft.fused_level_fwd_spill_ref(*a, white, mm=mm, dot_bf16=dot_bf16)
                            cc = tuple(x.to(a[1].dtype) for x in c)
                            return {**dict(zip(OUTPUTS, f[:4])), **ft.fused_level_bwd_saved_ref(
                                *a, saved, raw.to(a[1].dtype), *cc, white, mm=mm, dot_bf16=dot_bf16)}
                    torch.cuda.synchronize()
                    p32 = plain(args)
                    masks = _nan_masks(what, got, p32)
                    fin = lambda x: _finite_part(x, masks)  # noqa: E731
                    p64 = fin(plain(args64))
                    if dot_bf16:
                        orders = {k: fin(plain(args, mm)) for k, mm in BF16_ORDERS.items()}
                        lim = {n: max(TOL_BF16_FWD if n in OUTPUTS else TOL_BF16_GRAD, TOL_BF16_SPREAD * max(
                            _rel(run[n], ref) for run in orders.values())) for n, ref in p64.items()}
                        ratios = bf16_ratios(fin(got), p64, lim)
                        del orders
                    else:
                        k64, e64 = _grad_errors(fin(got), p64, list(got)), _grad_errors(fin(p32), p64, list(got))
                        ratios = {n: ((got[n] - p32[n]).abs().nan_to_num(0.0).max().item() / TOL[n]) if n in OUTPUTS
                                  else k64[n] / max(TOL_GRAD, TOL_GRAD_FACTOR * e64[n]) for n in got}
                    worst = max(ratios, key=ratios.get)
                    share = {n: m.double().mean().item() for n, m in masks.items()}
                    print(f"nan kernels: {what} at {R_k} rays: isnan masks equal to the plain version's on all "
                          f"{len(got)} outputs (NaN share " + ", ".join(
                              f"{n} {v:.3f}" for n, v in share.items() if n in OUTPUTS or 0 < v < 1)
                          + f"); finite entries {'by the bf16 rule' if dot_bf16 else 'within TOL / the K2 rule'}, "
                          f"closest to its limit {worst} {ratios[worst]:.3f}")
                    if not ratios[worst] <= 1.0:
                        fail(f"{what}: finite entries off the plain version beyond the rule on "
                             f"{sorted(n for n, r in ratios.items() if not r <= 1.0)}")
                    rows.append({"mode": mode, "kernel": kernel, "S": S, "case": case, "ratio": ratios[worst],
                                 "nan_share": share})
                    del got, p32, p64, masks
                    torch.cuda.empty_cache()
            del o, d, lvls
    print(f"  phase nan kernels: {time.perf_counter() - t_phase:.1f} s")
    return {"cases": rows}


# Phase 26: the card's density grid against the CPU's from the same restored
# parameters (and, for the auto-encoder, the same encoded codes), relative to
# the CPU grid's largest value. Both are fp32 products summed in other
# orders; the articulated fields pass the warped points through sin(2^9 x),
# which magnifies that to ~5e-5 of the largest value (the port against JAX
# on the CPU: tests/test_torch_geometry.py, TOL_F32 2e-4).
GEO_RES, GEO_EXPORT_RES, GEO_GRID_TOL = 32, 128, 2e-4
# Half-widths of the cubic box of phase 26's grids: export_voxels' default
# first, widened while the card's grid is constant in the box. Phase 7's
# step-60 vanilla density is 0 in every one of them (its raw density is
# negative everywhere: 60 steps towards an empty scene), so its mesh check
# runs on the raw density, in the default box.
GEO_HALF_WIDTHS = (1.5, 3.0, 6.0, 12.0)


def gap_level(grid: np.ndarray, margin: float, q_lo: float = 0.5, q_hi: float = 0.95):
    """(level, gap): a level in the widest gap between consecutive sorted
    grid values between the q_lo and q_hi quantiles, or anywhere when that
    gap is not wider than 2 x margin; None when no gap is."""
    v = np.unique(grid.ravel().astype(np.float64))
    for lo, hi in ((q_lo, q_hi), (0.0, 1.0)):
        i0, i1 = int(lo * (len(v) - 1)), int(hi * (len(v) - 1))
        if i1 <= i0:
            continue
        gaps = np.diff(v[i0:i1 + 1])
        i = i0 + int(np.argmax(gaps))
        if v[i + 1] - v[i] > 2.0 * margin:
            return 0.5 * (v[i] + v[i + 1]), float(v[i + 1] - v[i])
    return None, 0.0


def phase_geometry(runs: dict, tmp: str) -> dict:
    """For the checkpoints of phases 7, 9 and 11 (vanilla, auto-decoder,
    auto-encoder): export_voxels --resolution 128 --mesh on the card; a
    32^3 density grid on the card and on the CPU from the same restored
    parameters within GEO_GRID_TOL, in the first box of GEO_HALF_WIDTHS
    where the card's grid is not constant (the vanilla raw density where its
    density is constant in all of them); a level from the card's grid
    (in its widest gap near the top, clear of both grids' difference) whose
    marching-tetrahedra mesh is non-empty and has the CPU grid's mesh's
    faces, vertices within the bound the grids' difference allows; the
    seconds of a 128^3 grid and of its mesh in that box."""
    import copy

    from aonerf_torch import full_fp32
    from aonerf_torch.cli import export_voxels
    from aonerf_torch.ops.encoding import pos_enc
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config
    from aonerf_torch.viz import voxelgrid as vg
    from aonerf_torch.viz.mesh import marching_tetrahedra

    def raw_density_fn(model):  # the vanilla fine MLP's density before its ReLU
        mlp = model.fine_mlp

        def fn(p):
            with full_fp32():
                enc = pos_enc(p, mlp.min_deg_point, mlp.max_deg_point)
                return mlp(enc, vg._fixed_view_cond(p, mlp.deg_view))[1][..., 0]

        return fn

    t_phase = time.perf_counter()
    smi = smi_line()
    out = {}
    for name, cfg_path in runs.items():
        base = os.path.join(tmp, f"geometry_{name}")
        t0 = time.perf_counter()
        summary = export_voxels.main(["--config", cfg_path, "--out", base + "_occ.ply", "--mesh", base + "_mesh.ply",
                                      "--resolution", str(GEO_EXPORT_RES)])
        cli_s = time.perf_counter() - t0
        keys = ["out", "occupied", "resolution", "threshold", "step", "mesh", "mesh_verts", "mesh_faces"]
        if list(summary) != keys or summary["step"] <= 0 or not all(
                os.path.exists(summary[k]) for k in ("out", "mesh")):
            fail(f"geometry {name}: export_voxels printed {summary}")

        trainer = Trainer(load_config(cfg_path, {}))
        cpu_model = copy.deepcopy(trainer.model).cpu()
        if name == "vanilla":
            card_fn, cpu_fn = vg.nerf_density_fn(trainer.model), vg.nerf_density_fn(cpu_model)
        elif name == "autodecoder":
            lat = trainer._latents_for(0, 0)
            card_fn = vg.articulated_density_fn(trainer.model, lat)
            cpu_fn = vg.articulated_density_fn(cpu_model, {k: v.cpu() for k, v in lat.items()})
        else:
            lat, _ = trainer._render_setup(trainer.dataset.get_image(0, 0, 0))
            card_fn = vg.ae_density_fn(trainer.model, lat)
            cpu_fn = vg.ae_density_fn(cpu_model, {k: v.cpu() for k, v in lat.items()})
        for half in GEO_HALF_WIDTHS:
            box = ((-half,) * 3, (half,) * 3)
            card = vg.density_grid(card_fn, *box, resolution=GEO_RES, device="cuda")
            if np.ptp(card) > 0:
                break
        what = "density"
        if np.ptp(card) == 0:
            cpu = vg.density_grid(cpu_fn, *box, resolution=GEO_RES, device="cpu")
            print(f"geometry {name}: the density is {card.flat[0]:g} everywhere in the boxes of half-width "
                  f"{GEO_HALF_WIDTHS} on the card, and the CPU's {'too' if np.array_equal(card, cpu) else 'NOT'}; "
                  f"the mesh check takes the raw density")
            if name != "vanilla" or not np.array_equal(card, cpu):
                fail(f"geometry {name}: a constant density grid")
            card_fn, cpu_fn = raw_density_fn(trainer.model), raw_density_fn(cpu_model)
            half, what = GEO_HALF_WIDTHS[0], "raw density"
            box = ((-half,) * 3, (half,) * 3)
            card = vg.density_grid(card_fn, *box, resolution=GEO_RES, device="cuda")
        cpu = vg.density_grid(cpu_fn, *box, resolution=GEO_RES, device="cpu")
        scale = float(np.abs(cpu).max())
        diff = float(np.abs(card - cpu).max())
        rel = diff / max(scale, 1e-30)
        level, gap = gap_level(card, diff)
        print(f"geometry {name} (step {summary['step']}): export_voxels --resolution {GEO_EXPORT_RES} --mesh on the "
              f"card in {cli_s:.1f} s: {summary['occupied']} occupied at threshold {summary['threshold']}, mesh "
              f"{summary['mesh_verts']} verts / {summary['mesh_faces']} faces; {GEO_RES}^3 {what} grid in the box of "
              f"half-width {half:g}: card vs CPU max abs diff {diff:.3e} = {rel:.2e} of its largest value {scale:.4e} (tol {GEO_GRID_TOL:g}); grid min "
              f"{card.min():.4e}, median {np.median(card):.4e}, max {card.max():.4e}")
        if not np.isfinite(card).all() or not (what != "density" or (card >= 0).all()) or not rel <= GEO_GRID_TOL:
            fail(f"geometry {name}: the card's grid is off the CPU's")
        if level is None:
            fail(f"geometry {name}: no gap in the card's grid wider than twice its difference from the CPU's")
        verts, faces = marching_tetrahedra(card, level, *box)
        cverts, cfaces = marching_tetrahedra(cpu, level, *box)
        pitch = 2.0 * half / GEO_RES
        vtol = np.sqrt(3.0) * pitch * diff / (gap - 2.0 * diff) + 1e-9
        vdiff = float(np.abs(verts - cverts).max()) if len(verts) == len(cverts) and len(verts) else float("inf")
        print(f"  level {level:.6e} (widest gap {gap:.3e}): card mesh {len(verts)} verts / {len(faces)} faces, CPU mesh "
              f"{len(cverts)} / {len(cfaces)}, faces equal {np.array_equal(faces, cfaces)}, vertices max diff "
              f"{vdiff:.3e} (bound {vtol:.3e})")
        if not len(faces) or not np.array_equal(faces, cfaces) or not vdiff <= vtol:
            fail(f"geometry {name}: the card grid's mesh is empty or not the CPU grid's")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        big = vg.density_grid(card_fn, *box, resolution=GEO_EXPORT_RES, device="cuda")
        grid_s = time.perf_counter() - t0
        big_level, _ = gap_level(big, 0.0)
        t0 = time.perf_counter()
        bverts, bfaces = marching_tetrahedra(big, big_level, *box)
        mesh_s = time.perf_counter() - t0
        trainer.close()
        print(f"  {GEO_EXPORT_RES}^3 grid {grid_s:.3f} s on the card; its mesh at level {big_level:.4e} "
              f"{len(bverts)} verts / {len(bfaces)} faces in {mesh_s:.2f} s on the host ({smi})")
        out[name] = {"summary": summary, "half_width": half, "field": what, "grid_rel_diff": rel, "level": level, "faces": int(len(faces)),
                     "grid_seconds": grid_s, "mesh_seconds": mesh_s, "cli_seconds": cli_s}
    print(f"  phase geometry: {time.perf_counter() - t_phase:.1f} s")
    return out


# Phase 27: config/vanilla.json at other encoding degrees, DEGREE_STEPS
# steps a run on phase 7's scene: fp32 at max_deg_point 12, deg_view 6
# (encoded widths 75 / 39) and bf16 at 8 / 2 (51 / 15). Phase 2 builds their
# libraries beside the default widths'.
DEGREE_STEPS = 20
DEGREE_RUNS = (("fp32", {"min_deg_point": 0, "max_deg_point": 12, "deg_view": 6}),
               ("bf16", {"min_deg_point": 0, "max_deg_point": 8, "deg_view": 2}))


def _run_widths(deg: dict) -> tuple:
    """The encoded sample and view widths of a run's degrees."""
    return 3 + 6 * (deg["max_deg_point"] - deg["min_deg_point"]), 3 + 6 * deg["deg_view"]


def _degree_bounds(R: int, S: int, P: int, V: int, dot_bf16: bool) -> dict:
    """The bounds of K1, K1s and K2 (the backward from saved) at encoded
    widths P / V in the mode dot_bf16 says, each (ms, what bounds it)."""
    mode = "bf16" if dot_bf16 else "3xtf32"
    return {"K1": _fwd_bounds(S, R, P=P, V=V)[mode],
            "K1s": _fwd_bounds(S, R, spill=True, saved_bytes=2 if dot_bf16 else 4, P=P, V=V)[mode],
            "K2": _bwd_bounds_bf16(R, S, P, V)["bf16"] if dot_bf16 else _bwd_bound_3xtf32_ms(R, S, P, V)}


def degree_level_checks(nerf, boxes, focal, dot_bf16: bool) -> list:
    """K1, K1s and K2 (the backward from K1s' saved) at the NeRF's degrees,
    2048 rays of one view, S = 65 and 193, white background, against their
    plain versions under the default widths' rules, K1s' outputs K1's bits;
    each kernel, its plain version and its bound at these widths. fp32: K1
    and K1s within TOL, K1s' saved layers within SAVED_RMS_FACTOR of the fp32
    plain version's rms error against fp64 (phase 5), and K2 by its
    per-gradient rule on its own inputs: against the plain backward in fp64
    from the same saved and raw, the limit from the fp32 plain backward's
    error on them. The composition K1s + K2 against the plain composition in
    fp64 (phase 6's form) is printed beside it: there the forward's mask
    flips enter, and tools/torch_fwd_accuracy.py --witness showed the accepted
    kernels miss that form on 7 of 16 seed x level cases (ROADMAP Queue 2
    item 1). bf16: the
    bf16 rule on K1's outputs, K1s' saved layers and K2, which the fp32
    kernels must miss."""
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    dev = torch.device("cuda")
    mode = "bf16" if dot_bf16 else "fp32"
    names = fr.WEIGHT_NAMES
    o, d, lvls = _train_levels(nerf, boxes, focal, R=R_TRAIN, seed=SEED + 1000, dot_bf16=dot_bf16)
    rows = []
    for kp, t, venc, xenc in lvls:
        S = t.shape[1]
        P, V = fr.widths(kp)
        what = f"{P}/{V} {mode} S={S}"
        args = (kp, t, o, d, venc, xenc)
        args64 = ({n: v.double() for n, v in kp.items()}, *(a.double() for a in (t, o, d, venc, xenc)))
        rng = np.random.default_rng(SEED + 1000 + S)
        cot = tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            rng.standard_normal((R_TRAIN, 3)), rng.standard_normal(R_TRAIN), 0.1 * rng.standard_normal(R_TRAIN),
            rng.standard_normal((R_TRAIN, S))))
        cot64 = tuple(c.double() for c in cot)
        k1 = fr.fused_render_level(*args, True, dot_bf16=dot_bf16)
        *k1s, saved, raw = ft.fused_level_fwd_spill(*args, True, dot_bf16=dot_bf16)
        got = ft.fused_level_bwd_saved(*args, saved, raw, *cot, True, dot_bf16=dot_bf16)
        torch.cuda.synchronize()
        for n, a, b in zip(OUTPUTS, k1, k1s):
            if not torch.equal(a, b):
                fail(f"degrees {what}: K1s' {n} differs from K1's")
        for n, g in [*zip(OUTPUTS + ("saved", "raw"), (*k1s, saved, raw)), *got.items()]:
            if not torch.isfinite(g).all():
                fail(f"degrees {what}: non-finite {n}")
        if not dot_bf16:
            plain = ft.fused_level_fwd_spill_ref(*args, True)
            errs = {n: (g - w).abs().max().item() for n, g, w in zip(OUTPUTS + ("saved", "raw"), (*k1s, saved, raw),
                                                                         plain)}
            bad = [n for n, v in errs.items() if not v <= TOL[n]]
            if bad:
                fail(f"degrees {what}: K1/K1s off the plain version on {bad}: {errs}")
            rms_ratio = saved_fp64_check(args, saved, plain[4])
            del plain
            s32 = ft.fused_level_bwd_saved_ref(*args, saved, raw, *cot, True)
            s64 = ft.fused_level_bwd_saved_ref(*args64, saved.double(), raw.double(), *cot64, True)
            ratio = _check_grads(f"degrees {what} K2 from K1s' saved", _grad_errors(got, s64, names),
                                 _grad_errors(s32, s64, names))
            err = {"K1": max(errs[n] for n in OUTPUTS), "K1s": max(errs.values()),
                   "K2": max((got[n] - s32[n]).abs().max().item() for n in names)}
            del s32, s64
            p32 = ft.fused_level_bwd_ref(*args, *cot, True)
            p64 = ft.fused_level_bwd_ref(*args64, *cot64, True)
            e_k, e_p = _grad_errors(got, p64, names), _grad_errors(p32, p64, names)
            comp = {n: e_k[n] / max(TOL_GRAD, TOL_GRAD_FACTOR * e_p[n]) for n in names}
            worst = max(comp, key=comp.get)
            print(f"degrees {what}: K1 and K1s within TOL of the plain version (" + ", ".join(
                f"{n} {v:.2e}" for n, v in errs.items()) + f"), K1s K1's bits, its saved layers' rms error at most "
                f"{rms_ratio:.3f} of fp32 plain's; K2 at most {ratio:.3f} of its per-gradient limits; for "
                f"information, the composition against the plain one in fp64 {comp[worst]:.3f} of its limit ({worst})")
            del p32, p64
        else:
            orders = {k: bf16_k1_plain(args, True, mm) for k, mm in BF16_ORDERS.items()}
            ref = bf16_k1_plain(args64, True)
            lim = bf16_limits(orders, ref, TOL_BF16_FWD)
            f32k = dict(zip(OUTPUTS, fr.fused_render_level(*args, True)))
            ratio = _check_rule(f"degrees {what} K1", bf16_ratios(dict(zip(OUTPUTS, k1)), ref, lim),
                                bf16_ratios(f32k, ref, lim))
            err = {"K1": max((a - orders["cuBLAS"][n]).abs().max().item() for n, a in zip(OUTPUTS, k1))}
            del orders, ref, f32k
            orders = {k: saved_layers(ft.fused_level_fwd_spill_ref(*args, True, mm=mm, dot_bf16=True)[4])
                      for k, mm in BF16_ORDERS.items()}
            ref = saved_layers(ft.fused_level_fwd_spill_ref(*args64, True, dot_bf16=True)[4])
            saved_ratios = bf16_ratios(saved_layers(saved), ref, bf16_limits(orders, ref, TOL_BF16_FWD))
            layers = saved_layers(saved)
            err["K1s"] = max(err["K1"], *((layers[n].float() - orders["cuBLAS"][n].float()).abs().max().item()
                                          for n in ref))
            if not max(saved_ratios.values()) <= 1.0:
                fail(f"degrees {what}: K1s' saved layers beyond the bf16 rule: {saved_ratios}")
            del orders, ref
            orders = {k: bf16_k2_plain(args, cot, True, mm) for k, mm in BF16_ORDERS.items()}
            ref = bf16_k2_plain(args64, cot64, True)
            lim = bf16_limits(orders, ref, TOL_BF16_GRAD)
            f32k = ft.fused_level_bwd(*args, *cot, True)
            ratio = max(ratio, max(saved_ratios.values()),
                        _check_rule(f"degrees {what} K2", bf16_ratios(got, ref, lim), bf16_ratios(f32k, ref, lim)))
            err["K2"] = max((got[n] - orders["cuBLAS"][n]).abs().max().item() for n in names)
            print(f"degrees {what}: K1, K1s' saved layers and K2 within the bf16 rule (at most {ratio:.3f} of a "
                  "limit), K1s K1's bits")
            del orders, ref, f32k
        del args64, got
        iters = 5 if S > 100 else 10
        ms = {"K1": cuda_ms(lambda: fr.fused_render_level(*args, True, dot_bf16=dot_bf16), 2, iters),
              "K1s": cuda_ms(lambda: ft.fused_level_fwd_spill(*args, True, dot_bf16=dot_bf16), 2, iters),
              "K2": cuda_ms(lambda: ft.fused_level_bwd_saved(*args, saved, raw, *cot, True, dot_bf16=dot_bf16), 2,
                            iters)}
        plain_ms = {"K1": cuda_ms(lambda: fr.fused_render_level_ref(*args, True, dot_bf16=dot_bf16), 1, 2),
                    "K1s": cuda_ms(lambda: ft.fused_level_fwd_spill_ref(*args, True, dot_bf16=dot_bf16), 1, 2),
                    "K2": cuda_ms(lambda: ft.fused_level_bwd_saved_ref(*args, saved, raw, *cot, True,
                                                                       dot_bf16=dot_bf16), 1, 2)}
        bounds = _degree_bounds(R_TRAIN, S, P, V, dot_bf16)
        tile = fr.launch_tiles[(R_TRAIN, S, dot_bf16)], ft.fwd_tiles[(R_TRAIN, S, dot_bf16)]
        smem = fr.forward_smem_bytes(S, tile[1], P)
        print(f"  {what} at {R_TRAIN} rays: " + ", ".join(
            f"{k} {ms[k]:.3f} ms (plain {plain_ms[k]:.3f}, bound {bounds[k][0]:.3f} by {bounds[k][1]})" for k in ms)
            + f"; ray tiles K1 {tile[0]}, K1s {tile[1]} ({smem} bytes of shared memory a forward block)")
        rows.append({"P": P, "V": V, "mode": mode, "S": S, "ms": ms, "plain_ms": plain_ms,
                     "composition_ratio": None if dot_bf16 else comp[worst],
                     "bound_ms": {k: v[0] for k, v in bounds.items()}, "bound_by": {k: v[1] for k, v in bounds.items()},
                     "max_abs_err": err, "rule_ratio": ratio, "ray_tile": tile[1], "smem_bytes": smem})
        del saved, raw, k1, k1s
        torch.cuda.empty_cache()
    return rows


def one_test_view(root: str, scene: str) -> str:
    """A scene at ``scene`` that is ``root``'s (train and val linked) with
    its first test view only."""
    for split in ("train", "val"):
        os.makedirs(scene, exist_ok=True)
        os.symlink(os.path.join(root, split), os.path.join(scene, split))
    os.makedirs(os.path.join(scene, "test", "rgb"))
    with open(os.path.join(root, "test", "transforms.json")) as f:
        frames = json.load(f)
    frames["frames"] = {"r_0": frames["frames"]["r_0"]}
    with open(os.path.join(scene, "test", "transforms.json"), "w") as f:
        json.dump(frames, f)
    os.symlink(os.path.join(root, "test", "rgb", "r_0.png"), os.path.join(scene, "test", "rgb", "r_0.png"))
    return scene


def phase_degrees(boxes, focal, root: str, tmp: str) -> dict:
    """Phase 27: K1, K1s and K2 at both runs' widths in both modes against
    their plain versions (degree_level_checks); then config/vanilla.json
    (batch 2048, 64+128 samples, 8x256) at each run's degrees and mode,
    DEGREE_STEPS steps through the train CLI on phase 7's scene with one
    test view, launch counts of K1 (validation), K1s and K2 in the run's mode,
    the loss falling; --run_eval of the fp32 run's checkpoint (K1 only) and a
    32^3 grid through export_voxels from it."""
    from aonerf_torch.cli import export_voxels
    from aonerf_torch.cli import train as cli
    from aonerf_torch.models.nerf import NeRF
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft
    from aonerf_torch.train import step as step_mod
    from aonerf_torch.utils.config import load_config

    t_phase = time.perf_counter()
    levels = []
    for _, deg in DEGREE_RUNS:
        nerf = NeRF(generator=torch.Generator().manual_seed(SEED), device="cuda", **deg).eval()
        for dot_bf16 in (False, True):
            levels += degree_level_checks(nerf, boxes, focal, dot_bf16)
        del nerf
    t_kernels = time.perf_counter() - t_phase

    scene = one_test_view(root, os.path.join(tmp, "degrees_scene"))  # phase 7's scene, one test view
    real = step_mod.vanilla_loss_and_grads
    runs = {}
    out = os.path.join(tmp, "out_degrees")
    os.makedirs(out, exist_ok=True)
    for mode, deg in DEGREE_RUNS:
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", "vanilla.json")) as f:
            cfg = json.load(f)
        cfg.update({"root_dir": scene, "output_path": out, "exp_name": f"smoke_degrees_{mode}",
                    "img_wh": [W, H], "lr_init": 1e-3, "lr_delay_steps": 0, "val_every_steps": DEGREE_STEPS,
                    "ckpt_every_steps": DEGREE_STEPS, "limit_val_batches": 1, "seed": SEED,
                    "compute_dtype": {"fp32": "f32", "bf16": "bf16"}[mode], **deg})
        cfg_path = os.path.join(out, f"degrees_{mode}.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        losses = []

        def recorded(*args, **kwargs):  # observes each step's loss, changes nothing
            out = real(*args, **kwargs)
            losses.append(out[0])
            return out

        torch.cuda.synchronize()
        fr.launches = ft.fwd_launches = ft.launches = fr.bf16_launches = ft.bf16_fwd_launches = ft.bf16_launches = 0
        t0 = time.perf_counter()
        with mock.patch.object(step_mod, "vanilla_loss_and_grads", recorded):
            metrics = cli.main(["--config", cfg_path, "--max_steps", str(DEGREE_STEPS)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {"fp32": (fr.launches, ft.fwd_launches, ft.launches),
                  "bf16": (fr.bf16_launches, ft.bf16_fwd_launches, ft.bf16_launches)}
        loss = torch.stack(losses).cpu().numpy()
        n_val_tiles = -(-W * H // cfg["chunk"])
        other = "bf16" if mode == "fp32" else "fp32"
        P, V = _run_widths(deg)
        print(f"degrees {mode} at {P}/{V} (min_deg_point {deg['min_deg_point']}, max_deg_point "
              f"{deg['max_deg_point']}, deg_view {deg['deg_view']}): {len(loss)} steps at batch {cfg['batch_size']}, "
              f"{cfg['num_coarse_samples']}+{cfg['num_fine_samples']} samples in {seconds:.1f} s; loss first 5 "
              f"{loss[:5].mean():.5f}, last 5 {loss[-5:].mean():.5f}; val psnr {metrics.get('val_psnr')}; launches "
              f"K1 {counts[mode][0]} (expected {2 * n_val_tiles}), K1s {counts[mode][1]}, K2 {counts[mode][2]} "
              f"(expected {2 * DEGREE_STEPS} each), {other} mode {counts[other]}")
        if len(loss) != DEGREE_STEPS or not np.isfinite(loss).all() or not loss[-5:].mean() < loss[:5].mean():
            fail(f"degrees {mode}: the loss did not fall over {DEGREE_STEPS} steps")
        if counts[mode] != (2 * n_val_tiles, 2 * DEGREE_STEPS, 2 * DEGREE_STEPS) or any(counts[other]):
            fail(f"degrees {mode}: K1, K1s and K2 were not launched as expected: {counts}")
        runs[mode] = {"cfg_path": cfg_path, "launches": counts[mode], "loss_first5": float(loss[:5].mean()),
                      "loss_last5": float(loss[-5:].mean()), "seconds": seconds, "widths": (P, V)}

    cfg_path = runs["fp32"]["cfg_path"]
    torch.cuda.synchronize()
    fr.launches = ft.fwd_launches = ft.launches = 0
    t0 = time.perf_counter()
    stats = cli.main(["--config", cfg_path, "--run_eval"])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    n_tiles = -(-W * H // load_config(cfg_path).chunk)
    test_counts = (fr.launches, ft.fwd_launches, ft.launches)
    print(f"  --run_eval of the fp32 run's step {DEGREE_STEPS}: 1 test view in {test_s:.2f} s, psnr "
          f"{stats['psnr']['test']:.4f} dB, ssim {stats['ssim']['test']:.5f}; K1, K1s, K2 launches {test_counts} "
          f"(expected ({2 * n_tiles}, 0, 0))")
    if test_counts != (2 * n_tiles, 0, 0) or not all(np.isfinite(stats[k]["test"]) for k in ("psnr", "ssim")):
        fail("degrees: the test view did not render through K1 as expected")
    runs["fp32"]["test_k1"] = test_counts[0]
    t0 = time.perf_counter()
    summary = export_voxels.main(["--config", cfg_path, "--out", os.path.join(tmp, "degrees_occ.ply"),
                                  "--resolution", str(GEO_RES)])
    grid_s = time.perf_counter() - t0
    print(f"  export_voxels --resolution {GEO_RES} of the fp32 run's step {summary['step']} in {grid_s:.2f} s: "
          f"{summary['occupied']} occupied at threshold {summary['threshold']}")
    if summary["step"] != DEGREE_STEPS or summary["resolution"] != GEO_RES or not os.path.exists(summary["out"]):
        fail(f"degrees: export_voxels printed {summary}")
    seconds = time.perf_counter() - t_phase
    print(f"  phase degrees: {seconds:.1f} s (kernel checks {t_kernels:.1f} s; the libraries built in phase 2)")
    return {"levels": levels, "runs": runs, "test_seconds": test_s, "seconds": seconds}


# ---------------------------------------------------------------- phase 28

DP_STEPS = 30  # phase 28's 2-rank vanilla fit, one step a dispatch
DP_REF_STEPS = 10  # its one-rank NCCL run against the non-distributed Trainer
DP_AD_STEPS = 20  # its 2-rank auto-decoder fit on view-sharded buffers
DP_ULPS = 2  # the all-reduced gradient against the fp64 sum of the ranks' shares, in fp32 ulps


def _dp_jobs(jobs) -> dict:
    """One rank of ``run_dp``: each job (name, function of this module,
    kwargs) in turn, with phase 1's TF32 flags."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {name: globals()[fn](**kwargs) for name, fn, kwargs in jobs}


def run_dp(world: int, platform, jobs, timeout: float = 600.0) -> list:
    """Run ``jobs`` on ``world`` spawned ranks (each on ``platform``: None is
    cuda:rank under NCCL, "cuda:0" one shared card under gloo); each rank's
    {name: result}, in rank order (``aonerf_torch.entry.spawn_ranks``)."""
    from aonerf_torch.entry import spawn_ranks

    return spawn_ranks(_dp_jobs, world, platform, (jobs,), timeout)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def flat_params(params) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1) for p in params]).cpu().numpy()


class CaptureTx:
    """An optimizer that keeps the gradients it is given and moves nothing."""

    grads = None

    def schedule(self, step):
        return 0.0

    def init(self, params):
        from aonerf_torch.train.optim import OptState

        return OptState(count=0, slots={})

    def update(self, params, grads, state, mask=None):
        from aonerf_torch.train.optim import OptState

        self.grads = [None if g is None else g.detach().clone() for g in grads]
        return OptState(count=state.count + 1, slots={})


def dp_first_step(cfg: dict) -> dict:
    """A rank's first vanilla step of a fresh Trainer's weights, its
    gradients kept and nothing moved: each K2 launch held by K2's
    per-gradient fp32 rule against the fp64 backward of the rank's own K1s
    saved (phase 5's form); the all-reduced gradient against the fp64 sum of
    the ranks' weighted shares, within DP_ULPS fp32 ulps of each entry; on
    rank 0 the largest difference from the one-rank gradient of the same
    global batch."""
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft
    from aonerf_torch.ops.random import Draws
    from aonerf_torch.parallel import distributed
    from aonerf_torch.train import step as step_mod
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    trainer = Trainer(load_config(None, cfg))
    buffers = trainer.train_buffers()
    tx = CaptureTx()
    step = step_mod.make_vanilla_train_step(trainer.model, tx, trainer.cfg.white_back, trainer.near, trainer.far,
                                            batch_size=trainer.cfg.batch_size, mesh=trainer.mesh)
    k2_calls, shares = [], []
    real_bwd, real_reduce = ft.fused_level_bwd_saved, distributed.all_reduce_sum_

    def recording_bwd(*args, **kwargs):  # observes each K2 launch, changes nothing
        got = real_bwd(*args, **kwargs)
        k2_calls.append((args, {n: g.clone() for n, g in got.items()}))  # autograd may add into its own
        return got

    def recording_reduce(tensors):
        shares.append(torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy())
        return real_reduce(tensors)

    with mock.patch.object(ft, "fused_level_bwd_saved", recording_bwd), \
            mock.patch.object(distributed, "all_reduce_sum_", recording_reduce):
        state, metrics = step(step_mod.create_train_state(trainer.model, tx), buffers, trainer.cfg.seed)
    _sync()
    names = fr.WEIGHT_NAMES
    rank = distributed.rank()
    ratios = []
    for (kp, t, o, d, venc, xenc, saved, raw, *cot), got in k2_calls:
        white = cot[4]
        cot = cot[:4]
        s32 = ft.fused_level_bwd_saved_ref(kp, t, o, d, venc, xenc, saved, raw, *cot, white)
        kp64 = {n: v.double() for n, v in kp.items()}
        s64 = ft.fused_level_bwd_saved_ref(kp64, *(a.double() for a in (t, o, d, venc, xenc)), saved.double(),
                                           raw.double(), *(c.double() for c in cot), white)
        e_k, e_p = _grad_errors(got, s64, names), _grad_errors(s32, s64, names)
        tol = {n: max(TOL_GRAD, TOL_GRAD_FACTOR * e_p[n]) for n in names}
        worst = max(names, key=lambda n: e_k[n] / tol[n])
        ratios.append({"S": t.shape[1], "R": t.shape[0], "ratio": e_k[worst] / tol[worst], "worst": worst})
        bad = {n: (e_k[n], tol[n]) for n in names if not e_k[n] <= tol[n]}
        if bad:
            raise AssertionError(f"rank {rank}: K2 at {t.shape} off its fp64 backward beyond its limits: {bad}")
        del s32, s64, kp64
    del k2_calls
    n_grads = sum(g.numel() for g in tx.grads)
    reduced = torch.cat([g.reshape(-1) for g in tx.grads]).cpu().numpy()
    every = distributed.all_gather_host(shares[0][:n_grads])
    sum64 = np.sum([s.astype(np.float64) for s in every], axis=0)
    ulps = np.abs(reduced.astype(np.float64) - sum64) / np.spacing(np.abs(sum64).astype(np.float32)).astype(np.float64)
    out = {"k2": ratios, "reduce_ulps": float(ulps.max()), "loss": float(metrics["loss"]),
           "rows": trainer.cfg.batch_size // trainer.mesh.n_data}
    if ulps.max() > DP_ULPS:
        raise AssertionError(f"rank {rank}: the all-reduced gradient is {ulps.max():.1f} ulps off the fp64 sum")
    if rank == 0:  # the same global batch through one rank
        draws = Draws.for_step(trainer.cfg.seed, 0, trainer.device)
        batch = step_mod.sample_ray_batch(buffers, draws, trainer.cfg.batch_size)
        _, _, one = step_mod.vanilla_loss_and_grads(trainer.model, state.params, batch, draws, True,
                                                     trainer.cfg.white_back, trainer.near, trainer.far)
        one = torch.cat([g.reshape(-1) for g in one]).cpu().numpy()
        out["one_rank_max_abs"] = float(np.abs(reduced - one).max())
        out["one_rank_rel"] = float(np.abs(reduced - one).max() / np.abs(one).max())
    trainer.close()
    return out


def dp_fit(cfg: dict, max_steps: int, params: bool = False) -> dict:
    """Trainer.fit to ``max_steps``, one step a dispatch: the parameters held
    equal on every rank after every step, each step timed by the host clock
    (synchronized at both ends; the check left out); K1, K1s and K2
    launches from 0; the losses; with ``params`` the flat parameters."""
    from aonerf_torch.parallel import distributed
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    trainer = Trainer(load_config(None, cfg))
    real = trainer.step_fn
    times, losses = [], []

    def timed_checked(state, *args):
        _sync()
        t0 = time.perf_counter()
        state, metrics = real(state, *args)
        _sync()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        flat = flat_params(state.params.values())
        for r, other in enumerate(distributed.all_gather_host(flat)):
            if not np.array_equal(other, flat):
                raise AssertionError(f"rank {r}'s parameters differ from rank {distributed.rank()}'s after step "
                                     f"{state.step}")
        return state, metrics

    trainer.step_fn = timed_checked
    _reset_fused_launches()
    last = trainer.fit(max_steps=max_steps)
    _sync()
    launches = _fused_launches()
    out = {"launches": launches, "step_ms": 1e3 * float(np.median(times[1:])), "losses": losses,
           "checked": len(times), "last": last, "step": trainer.state.step}
    if params:
        out["params"] = flat_params(trainer.state.params.values())
    held = {t.data_ptr(): t.numel() * t.element_size() for t in trainer.train_buffers().values()}
    out["held_bytes"] = sum(held.values())  # the train buffers this rank holds (viewdirs aliases rays_d)
    if trainer.articulated:
        whole = trainer.dataset.device_buffers()
        out["bytes"] = {k: v.numel() * v.element_size() for k, v in trainer.train_buffers().items()}
        out["whole_bytes"] = {k: int(v.nbytes) for k, v in whole.items()}
    trainer.close()
    return out


def dp_test(cfg: dict) -> dict:
    """Trainer.test() of the run's latest checkpoint: the stats and the
    launches of K1, K1s and K2 from 0; then the gathered images (rank 0)."""
    from aonerf_torch.parallel import distributed
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    trainer = Trainer(load_config(None, {**cfg, "run_eval": True}))
    _reset_fused_launches()
    stats = trainer.test()
    _sync()
    launches = _fused_launches()
    rgbs, depths, accs, _, _ = trainer.render_test_views()
    out = {"launches": launches, "stats": stats}
    if distributed.rank() == 0:
        out.update(rgb=rgbs, depth=depths, acc=accs)
    trainer.close()
    return out


def _dp_config(root: str, out: str, name: str, **extra) -> dict:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", "vanilla.json")) as f:
        cfg = json.load(f)
    cfg.update({"root_dir": root, "output_path": out, "exp_name": name, "img_wh": [W, H], "lr_init": 1e-3,
                "lr_delay_steps": 0, "inner_steps": 1, "val_every_steps": DP_STEPS, "ckpt_every_steps": DP_STEPS,
                "limit_val_batches": 1, "seed": SEED, **extra})
    return cfg


def phase_data_parallel(root: str, multi_cfg_path: str, tmp: str) -> dict:
    """Phase 28: data parallelism on torch.distributed, ranks spawned on the
    one card (see the module docstring)."""
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    t0 = time.perf_counter()
    out = os.path.join(tmp, "dp")
    smi = smi_line()
    # one rank under NCCL against the non-distributed Trainer, bit for bit
    try:
        w1 = run_dp(1, None, [("fit", "dp_fit", {"cfg": _dp_config(root, out, "nccl1"), "max_steps": DP_REF_STEPS,
                                                 "params": True})])[0]["fit"]
    except RuntimeError as e:
        fail(f"phase 28, one rank under NCCL: {e}")
    ref = Trainer(load_config(None, _dp_config(root, out, "plain")))
    ref.fit(max_steps=DP_REF_STEPS)
    same = np.array_equal(flat_params(ref.state.params.values()), w1["params"])
    ref.close()
    print(f"data parallel: one rank under NCCL, {DP_REF_STEPS} steps at batch 2048: parameters "
          f"{'equal to' if same else 'DIFFERENT from'} the non-distributed Trainer's, bit for bit; "
          f"{w1['step_ms']:.3f} ms a step ({smi}); launches (K1, K1s, K2) {w1['launches']}")
    if not same:
        fail("phase 28: one rank under NCCL did not give the non-distributed Trainer's parameters")
    if w1["launches"][1:] != (2 * DP_REF_STEPS, 2 * DP_REF_STEPS):
        fail(f"phase 28: the one-rank run launched K1, K1s, K2 {w1['launches']}")

    # two ranks sharing the card under gloo: the vanilla first step, fit, test; the auto-decoder
    with open(multi_cfg_path) as f:
        ad = json.load(f)
    ad.update({"output_path": out, "exp_name": "dp_ad", "inner_steps": 1, "val_every_steps": DP_AD_STEPS,
               "ckpt_every_steps": DP_AD_STEPS, "shard_scene_buffers": True})
    cfg = _dp_config(root, out, "two")
    try:
        two = run_dp(2, "cuda:0", [
            ("first", "dp_first_step", {"cfg": _dp_config(root, out, "first")}),
            ("fit", "dp_fit", {"cfg": cfg, "max_steps": DP_STEPS}),
            ("test", "dp_test", {"cfg": cfg}),
            ("ad", "dp_fit", {"cfg": ad, "max_steps": DP_AD_STEPS}),
        ])
    except RuntimeError as e:
        fail(f"phase 28, two ranks: {e}")
    for r, res in enumerate(two):
        k2 = res["first"]["k2"]
        print(f"  rank {r}, first step ({res['first']['rows']} of 2048 rays): K2 at most "
              + ", ".join(f"{x['ratio']:.3f} (S={x['S']}, {x['worst']})" for x in k2)
              + f" of its per-gradient limits against the fp64 backward of its own K1s saved; the all-reduced "
              f"gradient within {res['first']['reduce_ulps']:.2f} fp32 ulps of the fp64 sum of the ranks' shares "
              f"(limit {DP_ULPS})")
    first = two[0]["first"]
    print(f"  the all-reduced gradient against the one-rank gradient of the same global batch: max abs diff "
          f"{first['one_rank_max_abs']:.3e} ({first['one_rank_rel']:.3e} of the largest entry)")
    fits = [res["fit"] for res in two]
    test_bits = two[0]["test"]
    one = Trainer(load_config(None, {**cfg, "run_eval": True}))  # the same checkpoint on one device
    rgbs, depths, accs, _, _ = one.render_test_views()
    one.close()
    test_same = all(np.array_equal(a, b) for a, b in ((rgbs, test_bits["rgb"]), (depths, test_bits["depth"]),
                                                       (accs, test_bits["acc"])))
    losses = np.asarray(fits[0]["losses"])
    for r, res in enumerate(two):
        print(f"  rank {r} launches (K1, K1s, K2): fit {res['fit']['launches']}, test {res['test']['launches']}, "
              f"auto-decoder {res['ad']['launches']}; parameters held equal after each of {res['fit']['checked']} "
              f"vanilla and {res['ad']['checked']} auto-decoder steps")
    print(f"  every rank holds the whole ray buffers: {fits[0]['held_bytes']} and {fits[1]['held_bytes']} bytes")
    print(f"  vanilla fit: {DP_STEPS} steps, loss first 5 {losses[:5].mean():.5f}, last 5 {losses[-5:].mean():.5f}; "
          f"val psnr {fits[0]['last'].get('val_psnr')}; test() of its checkpoint on 2 ranks "
          f"{'equal to' if test_same else 'DIFFERENT from'} one device's, bit for bit ({len(rgbs)} views); psnr "
          f"{test_bits['stats']['psnr']}")
    ad_res = [res["ad"] for res in two]
    ad_loss = np.asarray(ad_res[0]["losses"])
    held = {k: ad_res[0]["bytes"][k] for k in ("rgb", "mask", "c2w")}
    whole = {k: ad_res[0]["whole_bytes"][k] for k in held}
    print(f"  auto-decoder on view-sharded buffers: each rank holds {held} bytes of rgb/mask/c2w of {whole}; loss "
          f"first 5 {ad_loss[:5].mean():.5f}, last 5 {ad_loss[-5:].mean():.5f} over {DP_AD_STEPS} steps")
    print(f"  step ms: 2 ranks sharing the card {fits[0]['step_ms']:.3f} / {fits[1]['step_ms']:.3f} ms (1024 rays "
          f"each), 1 rank under NCCL {w1['step_ms']:.3f} ms (2048 rays); auto-decoder 2 ranks "
          f"{ad_res[0]['step_ms']:.3f} ms ({smi}). Two ranks on one card measure the mechanism (the all-reduce, "
          f"the host gathers), not a speed-up.")
    print(f"  phase 28: {time.perf_counter() - t0:.1f} s")
    for r, res in enumerate(two):
        if res["fit"]["checked"] != DP_STEPS or res["ad"]["checked"] != DP_AD_STEPS:
            fail(f"phase 28: rank {r} held its parameters equal after {res['fit']['checked']} steps")
        k1, k1s, k2 = res["fit"]["launches"]
        if k1s != 2 * DP_STEPS or k2 != 2 * DP_STEPS or k1 == 0:
            fail(f"phase 28: rank {r}'s fit launched K1, K1s, K2 {res['fit']['launches']}, expected K1 > 0 "
                 f"(validation) and {2 * DP_STEPS} each of K1s and K2")
        if res["test"]["launches"][0] == 0 or res["test"]["launches"][1:] != (0, 0):
            fail(f"phase 28: rank {r}'s test launched {res['test']['launches']}")
    if not test_same:
        fail("phase 28: the gathered test images differ from one device's")
    if not (np.isfinite(losses).all() and losses[-5:].mean() < losses[:5].mean()):
        fail("phase 28: the 2-rank vanilla loss did not fall")
    if not (np.isfinite(ad_loss).all() and ad_loss[-5:].mean() < ad_loss[:5].mean()):
        fail("phase 28: the 2-rank auto-decoder loss did not fall")
    if any(held[k] * 2 != whole[k] for k in held):
        fail(f"phase 28: a rank's view-sharded buffers are not half the scene's: {held} of {whole}")
    return {"launches": [res["fit"]["launches"] for res in two], "one_rank_launches": w1["launches"],
            "test_launches": [res["test"]["launches"] for res in two],
            "step_ms": [f["step_ms"] for f in fits], "one_rank_step_ms": w1["step_ms"]}


# ---------------------------------------------------------------- phase 29

DATA_TRAIN_VIEWS = 100  # phase 29's single scene: the reference's train split
DATA_STEPS = 10  # its fit at config/vanilla.json's widths
LOAD_REPEATS = 3  # each scene loaded this many times a path, in turns; the median printed
# the native loader against the PIL path (tests/test_torch_native.py): rays_o
# equal, rays_d and the rgb within an ulp of a unit value (3e-7, 2e-7)
TOL_LOAD_RAYS_D, TOL_LOAD_RGB = 3e-7, 2e-7


def _datagen(cfg: dict, path: str) -> subprocess.Popen:
    """Start the datagen CLI on ``cfg`` (written to ``path``) in a process of
    its own."""
    with open(path, "w") as f:
        json.dump(cfg, f)
    repo = os.path.dirname(os.path.abspath(__file__))
    # one BLAS thread a process: two datagens share the host's cores, and
    # their products are 3-long, so no sum's order depends on it
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p),
               OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", "aonerf_torch.data.datagen.generate", "--config", path], cwd=repo,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _datagen_done(proc: subprocess.Popen, out_dir: str) -> None:
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"phase 29: the datagen CLI for {out_dir} ran over 600 s")
    last = out.strip().splitlines()[-1] if out.strip() else ""
    if proc.returncode != 0 or json.loads(last or "{}") != {"out_dir": out_dir, "backend": "synthetic"}:
        fail(f"phase 29: the datagen CLI exited {proc.returncode}, printed {last!r}: {err[-2000:]}")


def _png(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path))


def _loads_in_turns(load) -> tuple:
    """``load()`` LOAD_REPEATS times a path, in turns (native, PIL, PIL,
    native, ...); the median host seconds of each and the last dataset each
    path built."""
    seconds, last = {True: [], False: []}, {}
    for i in range(2 * LOAD_REPEATS):
        use_native = (i % 4) in (0, 3)
        if use_native:
            os.environ.pop("AONERF_NO_NATIVE", None)
        else:
            os.environ["AONERF_NO_NATIVE"] = "1"
        try:
            t0 = time.perf_counter()
            last[use_native] = load()
            seconds[use_native].append(time.perf_counter() - t0)
        finally:
            os.environ.pop("AONERF_NO_NATIVE", None)
    return float(np.median(seconds[True])), float(np.median(seconds[False])), last[True], last[False]


def phase_data_path(tmp: str) -> dict:
    """Phase 29: the dataset path (see the module docstring)."""
    from aonerf_torch import native
    from aonerf_torch.cli import train as cli
    from aonerf_torch.data.sapien import SapienDataset
    from aonerf_torch.data.sapien_multi import SapienMultiDataset
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft
    from aonerf_torch.train import step as step_mod
    from aonerf_torch.utils.config import load_config
    from aonerf_torch.viz.check_poses import check_poses
    from aonerf_torch.viz.conventions import load_sapien

    t0 = time.perf_counter()
    smi = smi_line()
    base = os.path.join(tmp, "datagen")
    os.makedirs(base)
    single, multi = os.path.join(base, "single"), os.path.join(base, "multi")
    # the single and the multi scene in two processes at once, then the replay of the single scene's test poses
    procs = [(_datagen({"mode": "single", "out_dir": single, "img_wh": [W, H], "n_train": DATA_TRAIN_VIEWS,
                        "n_val": 2, "n_test": 2, "write_depth": True, "seed": SEED}, single + ".json"), single),
             (_datagen({"mode": "multi", "out_dir": multi, "img_wh": [W, H], "n_instances": 2,
                        "degrees": list(range(0, 100, 10)), "n_images": 4, "seed": SEED}, multi + ".json"), multi)]
    for proc, out_dir in procs:
        _datagen_done(proc, out_dir)
    _datagen_done(_datagen({"mode": "replay", "out_dir": single, "transforms": os.path.join(single, "test",
                            "transforms.json"), "split": "replay", "img_wh": [W, H], "write_depth": True},
                           single + "_replay.json"), single)
    gen_s = time.perf_counter() - t0
    n_files = {d: sum(len(f) for _, _, f in os.walk(d)) for d in (single, multi)}
    replay_same = all(np.array_equal(_png(os.path.join(single, "replay", kind, f"r_{i}.png")),
                                     _png(os.path.join(single, "test", kind, f"r_{i}.png")))
                      for i in range(2) for kind in ("rgb", "depth"))
    depth0 = _png(os.path.join(single, "train", "depth", "r_0.png"))
    print(f"data path: the datagen CLI wrote a {W}x{H} single scene ({DATA_TRAIN_VIEWS} train, 2 val, 2 test views "
          f"with depth; {n_files[single]} files with the replay), a multi scene (2 instances x 10 degrees x 4 views; "
          f"{n_files[multi]} files) and a replay of the test poses in {gen_s:.1f} s; the replay's rgb and depth "
          f"{'equal' if replay_same else 'NOT equal'} to the test views'; train depth r_0 {depth0.dtype} "
          f"{depth0.min()}..{depth0.max()} mm")
    if not replay_same:
        fail("phase 29: the replay of the test poses differs from the test views")
    if depth0.dtype != np.uint16 or not 0 < depth0.max() < 8000:
        fail("phase 29: the depth PNG is not millimeters of the scene")

    lib = native.get_loader()
    print(f"  native loader: {lib._name if lib is not None else None}")
    if lib is None or not os.path.exists(lib._name):
        fail("phase 29: the native loader did not load")
    loads = native.scene_loads
    nat_s, pil_s, nat, pil = _loads_in_turns(lambda: SapienDataset(single, "train", img_wh=(W, H)))
    native_loads = native.scene_loads - loads
    d_err = float(np.abs(nat.all_rays_d - pil.all_rays_d).max())
    rgb_err = float(np.abs(nat.all_rgbs - pil.all_rgbs).max())
    o_same = np.array_equal(nat.all_rays_o, pil.all_rays_o)
    decodes = native.png_decodes
    mnat_s, mpil_s, mnat, mpil = _loads_in_turns(lambda: SapienMultiDataset(multi, "train", img_wh=(W, H)))
    multi_decodes = native.png_decodes - decodes
    multi_same = all(np.array_equal(a.rgb, b.rgb) and np.array_equal(a.mask, b.mask) and np.array_equal(a.c2w, b.c2w)
                     for k in mnat._views for a, b in zip(mnat._views[k], mpil._views[k]))
    print(f"  loads, median of {LOAD_REPEATS} in turns (host seconds on the card's machine, {os.cpu_count()} cores; "
          f"{smi}): single scene {DATA_TRAIN_VIEWS} x {W}x{H} native {nat_s:.4f} s, PIL {pil_s:.4f} s "
          f"({pil_s / nat_s:.1f}x); multi scene 80 views (rgb + seg) native {mnat_s:.4f} s, PIL {mpil_s:.4f} s "
          f"({mpil_s / mnat_s:.1f}x)")
    print(f"  native against PIL: rays_o {'equal' if o_same else 'DIFFERENT'}, rays_d max diff {d_err:.3e} (tol "
          f"{TOL_LOAD_RAYS_D:g}), rgb {rgb_err:.3e} (tol {TOL_LOAD_RGB:g}); multi rgb/mask/c2w "
          f"{'equal' if multi_same else 'DIFFERENT'}; native calls: {native_loads} scene loads, {multi_decodes} PNG "
          f"decodes")
    if native_loads != LOAD_REPEATS or multi_decodes != LOAD_REPEATS * 2 * 80:
        fail(f"phase 29: the native path served {native_loads} scene loads and {multi_decodes} decodes")
    if not (o_same and d_err <= TOL_LOAD_RAYS_D and rgb_err <= TOL_LOAD_RGB and multi_same):
        fail("phase 29: the native loader's buffers disagree with the PIL path's")
    train_c2ws = np.stack([nat._frame_c2w(f) for f in nat.img_files])
    focal = nat.focal
    del nat, pil, mnat, mpil

    # config/vanilla.json at full width on the datagen'd scene
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", "vanilla.json")) as f:
        cfg = json.load(f)
    cfg.update({"root_dir": single, "output_path": os.path.join(tmp, "out_data"), "exp_name": "data_path",
                "img_wh": [W, H], "lr_init": 1e-3, "lr_delay_steps": 0, "inner_steps": DATA_STEPS,
                "val_every_steps": DATA_STEPS, "ckpt_every_steps": DATA_STEPS, "limit_val_batches": 1, "seed": SEED})
    cfg_path = os.path.join(tmp, "data_path.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    n_tiles = -(-W * H // cfg["chunk"])
    losses = []
    loads = native.scene_loads
    torch.cuda.synchronize()
    fr.launches = ft.fwd_launches = ft.launches = 0
    t_fit = time.perf_counter()
    with _recording(step_mod, "vanilla_loss_and_grads", losses):
        metrics = cli.main(["--config", cfg_path, "--max_steps", str(DATA_STEPS)])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    fit_counts = (fr.launches, ft.fwd_launches, ft.launches)
    fit_loads = native.scene_loads - loads
    loss = torch.stack(losses).cpu().numpy()
    print(f"  fit: config/vanilla.json (batch {cfg['batch_size']}, {cfg['num_coarse_samples']}+"
          f"{cfg['num_fine_samples']} samples, 8x256) on the datagen'd scene, {len(loss)} steps in {fit_s:.1f} s "
          f"(loading, steps, validation, checkpoint); loss first {loss[0]:.5f}, last {loss[-1]:.5f}; val psnr "
          f"{metrics.get('val_psnr')}; launches K1, K1s, K2 {fit_counts} (expected ({2 * n_tiles}, {2 * DATA_STEPS}, "
          f"{2 * DATA_STEPS})); train buffers by the native loader: {fit_loads} load")
    if len(loss) != DATA_STEPS or not np.isfinite(loss).all():
        fail(f"phase 29: the fit took {len(loss)} steps, loss {loss}")
    if fit_counts != (2 * n_tiles, 2 * DATA_STEPS, 2 * DATA_STEPS):
        fail(f"phase 29: the fit launched K1, K1s, K2 {fit_counts}")
    if fit_loads != 1:
        fail(f"phase 29: the Trainer's train buffers took the native loader {fit_loads} times")

    # test() of one view, from the fit's checkpoint
    scene = one_test_view(single, os.path.join(tmp, "data_one_view"))
    torch.cuda.synchronize()
    fr.launches = ft.fwd_launches = ft.launches = 0
    t_test = time.perf_counter()
    stats = cli.main(["--config", cfg_path, "--run_eval", "--root_dir", scene])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t_test
    test_counts = (fr.launches, ft.fwd_launches, ft.launches)
    run_dir = os.path.join(cfg["output_path"], cfg["exp_name"])
    with open(os.path.join(run_dir, "results.json")) as f:
        results = json.load(f)
    render_dir = os.path.join(run_dir, load_config(cfg_path).render_name)
    depth_pngs = sorted(n for n in os.listdir(render_dir) if n.startswith("depth") and n.endswith(".png"))
    print(f"  test() of 1 view in {test_s:.2f} s: psnr {results['psnr']['test']:.4f} dB, ssim "
          f"{results['ssim']['test']:.5f}, object psnr {results['psnr_obj']['test']:.4f} dB; launches K1, K1s, K2 "
          f"{test_counts} (expected ({2 * n_tiles}, 0, 0)); depth PNGs {depth_pngs}")
    if test_counts != (2 * n_tiles, 0, 0):
        fail(f"phase 29: test() launched K1, K1s, K2 {test_counts}")
    if not all(np.isfinite(results[k]["test"]) for k in ("psnr", "ssim", "psnr_obj")) or \
            results != json.loads(json.dumps(stats)):
        fail(f"phase 29: results.json {results}")
    if depth_pngs != ["depth000.png", "depth_raw000.png"]:
        fail(f"phase 29: test() wrote the depth PNGs {depth_pngs}")

    # the train poses: the datagen's sphere, and the conventions loader against the dataset
    report = check_poses(train_c2ws, expect_radius=4.0, radius_tol=0.5)
    cams = load_sapien(single, "train", img_wh=(W, H))
    same_c2ws = np.array_equal(cams.c2ws[:, :3, :4].astype(np.float32), train_c2ws)
    print(f"  check_poses on the {report['n_cameras']} train poses: ok {report['ok']}, radius "
          f"{report['radius']['min']:.4f}..{report['radius']['max']:.4f} ({report['radius']['n_outside_expected']} "
          f"outside 4 +- 0.5), look-at min cos {report['lookat_origin']['min_cos']:.6f}; conventions.load_sapien's "
          f"c2ws {'equal to' if same_c2ws else 'DIFFERENT from'} the dataset's, focal {cams.focal} against {focal}")
    if not report["ok"] or report["radius"]["n_outside_expected"] != 0 or report["n_cameras"] != DATA_TRAIN_VIEWS:
        fail(f"phase 29: check_poses {report}")
    if not same_c2ws or cams.focal != focal:
        fail("phase 29: conventions.load_sapien disagrees with the dataset's poses")
    seconds = time.perf_counter() - t0
    print(f"  phase 29: {seconds:.1f} s (datagen {gen_s:.1f} s, fit {fit_s:.1f} s, test {test_s:.1f} s)")
    return {"launches": fit_counts, "test_launches": test_counts, "load_s": {"native": nat_s, "pil": pil_s},
            "multi_load_s": {"native": mnat_s, "pil": mpil_s}, "seconds": seconds}


def main() -> None:
    t_run = time.perf_counter()
    phase_device()
    phase_build()
    from aonerf_torch.data.synthetic import FOVY_DEG, laptop_scene
    from aonerf_torch.models.nerf import NeRF

    nerf = NeRF(generator=torch.Generator().manual_seed(SEED), device="cuda").eval()
    boxes = laptop_scene(80.0)
    focal = 0.5 * H / np.tan(0.5 * np.deg2rad(FOVY_DEG))
    k = phase_kernels(nerf, boxes, focal)
    s = phase_serving(nerf, boxes, focal)
    f = phase_spill(nerf, boxes, focal)
    b = phase_backward(nerf, boxes, focal)
    bk = phase_bf16_kernels(nerf, boxes, focal)
    with tempfile.TemporaryDirectory() as tmp:
        t = phase_training(tmp)
        p = phase_test(t["cfg_path"], t["val_psnr"])
        bt = phase_bf16_training(tmp, t["root"], t["cfg_path"])
        a = phase_autodecoder(tmp)
        phase_articulated_test(a["cfg_path"])
        ae = phase_autoencoder(tmp)
        ae_test = phase_ae_test(ae["cfg_path"])
        phase_articulated_bf16_rule(os.path.join(tmp, "multi"))
        presets = {name: phase_bf16_preset(tmp, name) for name in PRESETS}
        turns = phase_articulated_turns(tmp)
        opt = phase_optimizers(tmp, t["root"])
        phase_encode_reuse(tmp)
        phase_ragged(tmp)
        nk = phase_noise_kernels(nerf, boxes, focal)
        nt = phase_noise_training(t["root"], tmp)
        phase_settings(t["root"], tmp)
        phase_lpips_test(t["cfg_path"], tmp)
        phase_nan_kernels(nerf, boxes, focal)
        phase_geometry({"vanilla": t["cfg_path"], "autodecoder": a["cfg_path"], "autoencoder": ae["cfg_path"]}, tmp)
        dg = phase_degrees(boxes, focal, t["root"], tmp)
        dp = phase_data_parallel(t["root"], a["cfg_path"], tmp)
        dpath = phase_data_path(tmp)
    ae_launches = [x + y for x, y in zip(ae["fused"], ae_test["fused"])]  # K1, K1s, K2 on phases 11-12

    lv = k["levels"]
    tile_ms = sum(x["ms"] for x in lv)
    n_tiles = -(-H * W // R)
    print(f"kernel share of a view: {n_tiles} tiles x {tile_ms:.3f} ms = {n_tiles * tile_ms:.1f} ms "
          f"of {s['seconds_per_view'] * 1e3:.1f} ms")

    def both(levels, key):  # one train step or serving tile: a coarse and a fine launch
        return sum(x[key] for x in levels)

    def bound_by(levels):
        return "operations" if all(x["bound_by"] == "operations" for x in levels) else "bytes"

    entry = {
        "name": "fused_render_level",
        "route": "cuda",
        "source": "aonerf_torch/ops/kernels/csrc/fused_render.cu",
        "replaces": "aonerf/ops/kernels/fused_render.py:194",
        "launches": s["launches"],
        # one serving tile: a coarse (S=65) and a fine (S=193) launch
        "max_abs_err": max(x["max_abs_err"] for x in lv),
        "ms": tile_ms,
        "plain_ms": both(lv, "plain_ms"),
        # the products in 3xTF32 at the TF32 tensor-core peak, the heads at
        # the fp32 peak; bound_ms_fp32: every product at the fp32 peak
        "bound_ms": both(lv, "bound_ms"),
        "bound_ms_fp32": both(lv, "bound_ms_fp32"),
        "bound_by": bound_by(lv),
        "library_ms": None,
        "levels": lv,
        "train_launches": t["k1"],
        "test_launches": p["k1"],
        "ae_launches": ae_launches[0],
        # phase 28: each rank's launches in its 2-rank fit (validation) and test()
        "data_parallel_launches": [x[0] for x in dp["launches"]],
        "data_parallel_test_launches": [x[0] for x in dp["test_launches"]],
        # phase 29: the fit on the datagen'd scene (validation) and its test() of one view
        "data_path_launches": dpath["launches"][0], "data_path_test_launches": dpath["test_launches"][0],
    }
    flv = f["levels"]
    k1s = {
        "name": "fused_level_fwd_spill",
        "route": "cuda",
        "source": "aonerf_torch/ops/kernels/csrc/fused_train.cu",
        "replaces": "aonerf/ops/kernels/fused_render.py:194",
        "launches": t["k1s"],
        # one train step: a coarse (S=65) and a fine (S=193) launch at 2048 rays
        "max_abs_err": max(x["max_abs_err"] for x in flv),
        "ms": both(flv, "ms"),
        "plain_ms": both(flv, "plain_ms"),
        "bound_ms": both(flv, "bound_ms"),
        "bound_ms_fp32": both(flv, "bound_ms_fp32"),
        "bound_by": bound_by(flv),
        "library_ms": None,
        "k1_ms": both(flv, "k1_ms"),
        "levels": flv,
        "ae_launches": ae_launches[1],
        "optimizer_launches": {k: v["k1s"] for k, v in opt.items() if "k1s" in v},
        # phase 28: each rank's 2-rank fit, then the one-rank NCCL run
        "data_parallel_launches": [x[1] for x in dp["launches"]] + [dp["one_rank_launches"][1]],
        "data_path_launches": dpath["launches"][1],  # phase 29's fit
        # phase 21: one coarse and one fine launch with sigma noise, each mode,
        # timed in turns with the same launch without; phase 22: the launches
        # of the noisy training run
        "noise": {"launches": nt["k1s"], "ms": both([x for x in nk["levels"] if x["mode"] == "fp32"], "ms"),
                  "ms_without_noise": both([x for x in nk["levels"] if x["mode"] == "fp32"], "ms_without_noise"),
                  "max_abs_err": max(x["max_abs_err"] for x in nk["levels"]), "levels": nk["levels"]},
    }
    blv = b["levels"]
    k2 = {
        "name": "fused_level_bwd",
        "route": "cuda",
        "source": "aonerf_torch/ops/kernels/csrc/fused_train.cu",
        "replaces": "aonerf/ops/kernels/fused_train.py:239",
        "launches": t["k2"],
        # one train step's backward from saved: a coarse (S=65) and a fine
        # (S=193) launch at 2048 rays; the errors are the composition's
        "max_abs_err": max(x["max_abs_err"] for x in blv),
        "ms": both(blv, "ms"),
        "plain_ms": both(blv, "plain_ms"),
        # B1 and B2 in 3xTF32 at the TF32 tensor-core peak, the rest at the
        # fp32 peak; bound_ms_fp32: every product at the fp32 peak
        "bound_ms": both(blv, "bound_ms"),
        "bound_ms_fp32": both(blv, "bound_ms_fp32"),
        "bound_by": bound_by(blv),
        "library_ms": None,
        "levels": blv,
        "ae_launches": ae_launches[2],
        "optimizer_launches": {k: v["k2"] for k, v in opt.items() if "k2" in v},
        # phase 28: each rank's 2-rank fit, then the one-rank NCCL run
        "data_parallel_launches": [x[2] for x in dp["launches"]] + [dp["one_rank_launches"][2]],
        "data_path_launches": dpath["launches"][2],  # phase 29's fit
        # phase 22: the noisy training run's launches; phase 21: K2 from the
        # noisy saved and raw against its plain version (fp32: the
        # per-gradient rule's ratio; bf16: the bf16 rule's)
        "noise_launches": nt["k2"], "noise_err_over_limit": max(x["k2_ratio"] for x in nk["levels"]),
    }
    b2 = {
        # B2 in fp32 (3xTF32 mma.sync from a TMA ring of 32-row stages), one
        # launch in each launch of fused_level_bwd; ms by torch.profiler, one
        # coarse and one fine level at 2048 rays; plain_ms: B2's share of
        # the plain version; library_ms: one fp32 torch.mm a product, summed
        "name": "level_bwd_dw_kernel", "route": "cuda", "source": "aonerf_torch/ops/kernels/csrc/fused_train.cu",
        "replaces": "aonerf/ops/kernels/fused_train.py:239", "launches": t["k2"],
        "max_abs_err": max(x["b2_max_abs_err"] for x in blv),
        "ms": sum(x["passes"]["B2"]["ms"] for x in blv), "plain_ms": both(blv, "b2_plain_ms"),
        "bound_ms": sum(x["passes"]["B2"]["bound_ms"] for x in blv),
        "bound_by": bound_by([x["passes"]["B2"] for x in blv]), "library_ms": both(blv, "b2_library_ms"),
        "library": "fp32 torch.mm", "fp64_rel_err": max(x["b2_fp64_rel_err"] for x in blv),
    }
    k1s_step, k2_step = k1s["ms"], k2["ms"]
    print(f"train step share: K1s {k1s_step:.3f} ms + K2 {k2_step:.3f} ms + rest "
          f"{t['step_ms'] - k1s_step - k2_step:.3f} ms = {t['step_ms']:.3f} ms")

    def bf16_entry(name, source, replaces, launches, levels, **extra):
        # one coarse (S=65) and one fine (S=193) launch; the products' bound
        # at the bf16 tensor-core peak, bound_ms_tf32 at the TF32 peak
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": max(x["max_abs_err"] for x in levels), "ms": both(levels, "ms"),
            "plain_ms": both(levels, "plain_ms"), "bound_ms": both(levels, "bound_ms"),
            "bound_ms_tf32": both(levels, "bound_ms_tf32"), "bound_by": bound_by(levels), "library_ms": None,
            "fp32_ms": both(levels, "fp32_ms"), "rule_ratio": max(x["rule_ratio"] for x in levels),
            "levels": levels, **extra,
        }

    entries = [
        entry, k1s, k2,
        bf16_entry("fused_render_level_bf16", "aonerf_torch/ops/kernels/csrc/fused_render.cu",
                   "aonerf/ops/kernels/fused_render.py:194", bt["k1"], bk["k1"], test_launches=bt["test_k1"]),
        bf16_entry("fused_level_fwd_spill_bf16", "aonerf_torch/ops/kernels/csrc/fused_train.cu",
                   "aonerf/ops/kernels/fused_render.py:194", bt["k1s"], bk["k1s"]),
        bf16_entry("fused_level_bwd_bf16", "aonerf_torch/ops/kernels/csrc/fused_train.cu",
                   "aonerf/ops/kernels/fused_train.py:239", bt["k2"], bk["k2"]),
    ]
    def preset_entry(name, source, launches, levels):
        # one coarse (S=65) and one fine (S=193) launch at the fast preset's
        # shape and the tile its wrapper chooses; ms_t16: at 16 rays a block
        return {
            "name": name, "route": "cuda", "source": source, "replaces": "aonerf/ops/kernels/fused_render.py:194",
            "launches": launches, "max_abs_err": max(x["max_abs_err"] for x in levels), "ms": both(levels, "ms"),
            "plain_ms": both(levels, "plain_ms"), "bound_ms": both(levels, "bound_ms"), "bound_by": bound_by(levels),
            "library_ms": None, "rays": levels[0]["R"], "ray_tile": levels[0]["ray_tile"],
            "ms_t16": both(levels, "ms_t16"), "rule_ratio": max(x["rule_ratio"] for x in levels), "levels": levels,
        }

    entries += [
        {**preset_entry(f"fused_render_level_bf16 at {CHUNK_FAST} rays",
                        "aonerf_torch/ops/kernels/csrc/fused_render.cu", bt["k1"], bk["k1_preset"]),
         "test_launches": bt["test_k1"], "host_ms": max(x["host_ms"] for x in bk["k1_preset"])},
        # k2_rule_ratio: K2 bf16 from its saved against the bf16 rule
        {**preset_entry(f"fused_level_fwd_spill_bf16 at {BATCH_FAST} rays",
                        "aonerf_torch/ops/kernels/csrc/fused_train.cu", bt["k1s"], bk["k1s_preset"]),
         "k2_rule_ratio": max(x["k2_rule_ratio"] for x in bk["k1s_preset"])},
    ]
    b2lv = bk["b2"]
    entries.append({
        # B2 in bf16 mode, one launch in each launch of fused_level_bwd_bf16 (its
        # launches are those); ms by torch.profiler, one coarse and one fine
        # level at 2048 rays; plain_ms: B2's share of the plain bf16 version
        "name": "level_bwd_dw_bf16_kernel", "route": "cuda", "source": "aonerf_torch/ops/kernels/csrc/fused_train.cu",
        "replaces": "aonerf/ops/kernels/fused_train.py:239", "launches": bt["k2"],
        "max_abs_err": max(x["max_abs_err"] for x in b2lv), "ms": both(b2lv, "ms"), "plain_ms": both(b2lv, "plain_ms"),
        # bound_ms: both bf16 scratches at 2 bytes a value; bound_ms_layout: at
        # 4, the fp32 layout they had before; library_ms: bf16 torch.mm on the
        # same bf16 slices; "preset": at the fast preset's batch
        "bound_ms": both(b2lv, "bound_ms"), "bound_ms_layout": both(b2lv, "bound_ms_layout"),
        "bound_by": bound_by(b2lv), "library_ms": both(b2lv, "library_ms"),
        "library": b2lv[0]["library"], "fp32_ms": both(b2lv, "fp32_ms"), "levels": b2lv,
        "preset": {"rays": BATCH_FAST, "ms": both(bk["k1s_preset"], "b2_ms"),
                   "bound_ms": both(bk["k1s_preset"], "b2_bound_ms"),
                   "library_ms": both(bk["k1s_preset"], "b2_library_ms")},
    })
    b1lv, pre = bk["b1"], bk["k1s_preset"]
    entries.append({
        # B1 in bf16 mode (level_bwd_delta_kernel<true>: native bf16 mma.sync
        # from a TMA ring of the wrapper's bf16 pack of its weights), one
        # launch in each launch of fused_level_bwd_bf16; ms by torch.profiler,
        # one coarse and one fine level at 2048 rays; plain_ms: B1's plain
        # version on the operands it read; "preset": at the fast preset's
        # batch, at the tile K2 chooses and at 16 rays a block, and the host
        # work of a K2 bf16 call there
        "name": "level_bwd_delta_kernel_bf16", "route": "cuda",
        "source": "aonerf_torch/ops/kernels/csrc/fused_train.cu", "replaces": "aonerf/ops/kernels/fused_train.py:239", "launches": bt["k2"],
        "max_abs_err": max(x["max_abs_err"] for x in b1lv), "ms": both(b1lv, "ms"), "plain_ms": both(b1lv, "plain_ms"),
        "bound_ms": both(b1lv, "bound_ms"), "bound_by": bound_by(b1lv), "library_ms": None,
        "product": "mma.sync m16n8k16 bf16", "fp64_rel_err": max(x["fp64_rel_err"] for x in b1lv),
        "bias_rel_err": max(x["bias_rel_err"] for x in b1lv), "levels": b1lv,
        "preset": {"rays": BATCH_FAST, "ray_tile": pre[0]["k2_ray_tile"], "ms": both(pre, "b1_ms"),
                   "ms_t16": both(pre, "b1_ms_t16"), "bound_ms": both(pre, "b1_bound_ms"),
                   "bound_ms_t16": both(pre, "b1_bound_ms_t16"), "host_ms": max(x["k2_host_ms"] for x in pre),
                   "host_ms_t16": max(x["k2_host_ms_t16"] for x in pre)},
    })
    print(f"bf16 step at batch {bt['steps_ms']['batch']}: {min(bt['steps_ms']['bf16']):.3f} ms against fp32 "
          f"{min(bt['steps_ms']['fp32']):.3f} ms, peak device memory {bt['steps_ms']['peak_gb']['bf16']:.3f} GB "
          f"against {bt['steps_ms']['peak_gb']['fp32']:.3f} GB; K1s bf16 {entries[4]['ms']:.3f} ms + K2 bf16 {entries[5]['ms']:.3f} "
          f"ms a step (fp32 {entries[4]['fp32_ms']:.3f} + {entries[5]['fp32_ms']:.3f} ms)")
    entries.append(b2)

    def degree_entry(kernel, name, source, replaces, mode, widths, launches):
        # phase 27: a coarse (S=65) and a fine (S=193) launch at 2048 rays at
        # the run's encoded widths and mode; launches from its training run
        lv = [x for x in dg["levels"] if x["mode"] == mode and (x["P"], x["V"]) == widths]
        return {"name": f"{name} at {widths[0]}/{widths[1]}", "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches, "max_abs_err": max(x["max_abs_err"][kernel] for x in lv),
                "ms": sum(x["ms"][kernel] for x in lv), "plain_ms": sum(x["plain_ms"][kernel] for x in lv),
                "bound_ms": sum(x["bound_ms"][kernel] for x in lv),
                "bound_by": bound_by([{"bound_by": x["bound_by"][kernel]} for x in lv]), "library_ms": None,
                "rule_ratio": max(x["rule_ratio"] for x in lv), "ray_tiles": [x["ray_tile"] for x in lv],
                "smem_bytes": [x["smem_bytes"] for x in lv]}

    for mode, _ in DEGREE_RUNS:
        run = dg["runs"][mode]
        tag = "_bf16" if mode == "bf16" else ""
        k1_launches = run["launches"][0] + run.get("test_k1", 0)  # validation, and the fp32 run's test view
        entries += [
            degree_entry("K1", f"fused_render_level{tag}", "aonerf_torch/ops/kernels/csrc/fused_render.cu",
                         "aonerf/ops/kernels/fused_render.py:194", mode, run["widths"], k1_launches),
            degree_entry("K1s", f"fused_level_fwd_spill{tag}", "aonerf_torch/ops/kernels/csrc/fused_train.cu",
                         "aonerf/ops/kernels/fused_render.py:194", mode, run["widths"], run["launches"][1]),
            degree_entry("K2", f"fused_level_bwd{tag}", "aonerf_torch/ops/kernels/csrc/fused_train.cu",
                         "aonerf/ops/kernels/fused_train.py:239", mode, run["widths"], run["launches"][2]),
        ]
    print(f"whole run: {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()
    }}))


if __name__ == "__main__":
    main()
