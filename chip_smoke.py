#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without printing a
result):
  1. torch/CUDA versions, the card's name and power limit, TF32 switched off.
  2. Build the kernels (coda_neurips2023_tpu_torch/csrc) with nvcc, and
     beside them the scan kernels B, F and G replaced
     (scripts/ball_query_variants.cu), phase 3's yardstick, in parallel.
  3. Each kernel against its plain PyTorch version at the shapes of the two
     eval paths: FPS, ball query and gather exactly, attention (D) within
     ATTN_TOL, ViT attention (E) within VIT_ATTN_TOL at one scene's crops
     (128) and at a stage-1 step's (256); kernel and plain times (CUDA
     events around back-to-back calls spanning SPAN_MS, median of REPS
     after warm-up).  FPS (A) is held bit for bit at 32 x 20000 -> 2048,
     32 x 2048 -> 128, 8 x 20000 -> 2048 and 8 x 40000 -> 2048, each at the
     cluster size its policy picks on this card, beside the floor of its
     loop (the same barriers and cross-block merge without the points'
     work).  Kernel C over GATHER_WIDTHS at (4, 2048) -> (4, 1024, 32): each
     width with the features aligned and one element into their storage
     (C % 4 == 0 takes the 16-byte branch only when aligned), with R ragged
     against a warp's 32 rows (1023 x 31) and as gather_points' (B, 1, M)
     view, bit for bit against group_points_plain; for C >= 64 its time,
     torch.gather's in turns and the bytes bound.
  4. The flagship CoDA model (enc 256, dec 512, 3 + 8 layers, 2048 points,
     128 queries) with random weights from a seed, eval step on 3 batches of
     32 synthetic 20000-point scenes against the 46-class text bank, which
     CLIP's text tower (random weights from a seed) encodes first: shapes,
     finite values, the launch counts of kernels A-D (B exactly
     GRID_LAUNCHES a step: its grid build's two kernels and the query),
     step times, peak memory.
  5. The same model and weights on the CPU (plain PyTorch paths) on 2 scenes:
     integer outputs equal, floats within MODEL_TOL.
  6. The baseline detector's CLIP-crop eval (3detrmulticlasshead
     --if_with_clip) at full width: the flagship detector without a text
     head, CLIP ViT-B/16, batches of 32 scenes with 531 x 730 images, so 4096
     crops through the image tower a step; one warm-up and 3 timed steps:
     shapes, finite values, sem_cls_prob rows that sum to 1 or are zero (an
     invalid box), the launch counts of all five kernels (B GRID_LAUNCHES a
     step), step times, crops/s, peak memory.
  7. The CLIP-crop part of that step for one scene on the CPU (plain paths)
     from the GPU detector's boxes: rects equal, sem_cls_prob within CLIP_TOL.
  8. The baseline detector's training step (scripts/coda_baseline_sunrgbd.sh:
     3detrmulticlasshead at the flagship's width, dropout as shipped,
     matcher costs cls 1 / giou 3 / center 5 / objectness 5, the skip-none-gt
     softmax loss, AdamW with weight decay 0.1 and clip 0.1) on batches of
     TRAIN_BATCH synthetic 20000-point scenes with ground truth, with
     CODA_BQ_FUSED_GATHER=1 (kernel F) for this phase and the next: one
     warm-up and TRAIN_STEPS timed steps: a finite loss, step times,
     scenes/s, peak memory, the matcher's host ms, the launch counts of A, B,
     F and D (F, A and D must launch; F GRID_LAUNCHES a step).
  9. The same step, dropout 0, from the same weights on 2 scenes on the GPU
     and on the CPU (plain paths): assignments equal, loss within STEP_TOL,
     gradients within GRAD_TOL of their global norm.
 10. CoDA's stage-1 distillation training step (scripts/coda_sunrgbd_stage1.sh:
     3detr_predictedbox_distillation at the flagship's width with its 512-d
     text head, dropout as shipped, the baseline's matcher and detection
     losses plus loss_predicted_region_embed_l1 1, no-object-contrast 0.05,
     32 distillation crops a scene, CLIP ViT-B/16 with random weights from a
     seed) on batches of TRAIN_BATCH 20000-point scenes with 531 x 730
     images, with CODA_BQ_ALGO=adaptive (kernel G carries the set
     abstraction; F stays off, as the JAX package's gate says): one warm-up
     and TRAIN_STEPS timed steps: a finite loss, the distillation loss above
     0, the count of valid crops, the launch counts of A, G, C, D and E (all
     must launch, B and F must not; G TILE_LAUNCHES a step), step times,
     scenes/s, crops/s, the matcher's host ms, peak memory.
 11. The same step at dropout 0 on 2 scenes, GPU vs CPU (plain paths), from
     the same weights and the same crop selection (boxes whose rect
     coordinates lie at least RECT_MARGIN px from an integer, so both
     devices cut the same crops): the mask equal, the targets within
     CLIP_TOL, assignments equal, loss within STEP_TOL, gradients within
     GRAD_TOL of their global norm.
 12. One batch of phase 4's eval step with CODA_BQ_MXU=1: kernel G launches
     (the MXU kernel's row) TILE_LAUNCHES times, kernel B does not, and the
     outputs equal phase 4's on that batch within MXU_TOL.
 13. The eval entry point end to end: phase 4's weights saved to build/ as a
     reference-format .pth, then `coda_neurips2023_tpu_torch.main --test_only
     --test_ckpt` (the flags of test_release_models.sh) on the card on the
     synthetic split of CLI_SCENES // 4 scenes (batches of 32, the last
     padded), once with the AP stack on CODA_AP_WORKERS=8 and once serial
     (0): the scan count, finite metrics with the JAX package's key set, the
     first batch's outputs against phase 4's eval step on that batch (with
     the CLI's text bank) within MXU_TOL, every scan's NMS in the host
     library, A-D launched per step as in phase 4 and no other kernel; and
     the numbers of the loop: scenes/s from loader to metrics, device ms a
     step (CUDA events around each batch's copies and step), host metering
     ms a batch split into the in-hull test, NMS and the AP curves, and the
     device's idle share over the loop.  Then one batch (CLIP_SCENES scenes
     padded to 32 rows) through --model_name 3detrmulticlasshead
     --if_with_clip: kernel E launches once a row and layer.
 14. The training entry point end to end: `coda_neurips2023_tpu_torch.main`
     without --test_only, with the flags of scripts/coda_sunrgbd_stage1.sh
     and scripts/coda_sunrgbd_stage2.sh as the scripts give them, cut only
     where the data, the time limit and one card force it (no data paths, so
     the synthetic split of TRAIN_CLI_SCENES scenes with its 64 x 96 images,
     4 steps an epoch at B=8; random CLIP weights; --ngpus 1; the epochs and
     cadences of STAGE1_CUTS and STAGE2_CUTS), into build/phase14/: stage 1
     for one epoch; stage 2 from stage 1's `last_checkpoint` (no suffix, as
     the script passes it) for 3 epochs with the epoch reset every 2 and
     discovery at reset epoch 0 (epochs 0 and 2); then the same stage-2 call
     with --max_epoch 4 and no --set_epoch, which resumes at epoch 3 with
     the optimizer's count where it stopped.  Checked: a finite loss every
     step; every step's learning rate equal to the host schedule replayed on
     the reset epoch; A, B, C, D and E launched on every step (E once a
     layer), E once a layer more on every discovery batch; stage 2's
     artifacts are the JAX do_train's names with .pth checkpoints; the
     pseudo-label files grow from round 1 to round 2 and epoch 1 trains on
     their rows, or, where no row reaches the writer, the gate counts say
     which gate emptied the batches; and one discovery batch (2 scenes) on
     the CPU from the same outputs, with the random tower and with a tower
     pinned to a class that is not seen: the novel mask equal on the boxes
     whose rects lie RECT_MARGIN px from integers and whose CLIP decision is
     not within 1e-4 of a tie or the threshold, the rows within CLIP_TOL.
     Printed beside the card's name and power limit: step ms (median, min,
     max) and scenes/s a call, discovery ms a batch with the tower's part
     and the NMS loop's device ms, the survivors of each gate and the rows
     written, checkpoint bytes and save ms, each eval's loop ms, the
     device's idle share over the epoch loop (1 - the steps' and discovery
     batches' device spans / the loop's wall time), peak memory.
 15. ScanNet on the card.  A fixture in ScanNet's on-disk layout is written
     from a seed under build/phase15/ (SCANNET_TRAIN_SCANS train and
     SCANNET_VAL_SCANS val scans of SCANNET_SCAN_POINTS points on the floor,
     walls and boxes of 7 x 7 x 3 m rooms, raw ScanNet-200 ids from
     scripts/coda_scannet_stage1.sh's lists, 4 x 4 poses and intrinsics).
     (a) `main --test_only --test_ckpt` with test_release_models.sh's
     scannet_stage1 row (60 classes, B=32) on the val scans, with phase 4's
     weights (the angle heads cut to ScanNet's one bin) through a .pth, at
     the CLI's 20000 points and at --num_points 40000, AP workers 8: scenes/s
     loader to metrics, device ms a batch, host meter ms a batch, the idle
     share; A-D launched per step as in phase 4 and no other kernel; the
     first batch against the eval step on it within MXU_TOL; then kernel A
     bit for bit against its plain version at 32 and 48 x 40000 -> 2048
     (the cluster size it takes, and that the card runs that many clusters
     at once) and kernel B at 32 x 40000 with 2048 centres, with kernel,
     plain and bound ms.  (b) The ScanNet stage-1 training step through
     StageContext.make_fused_train_step with coda_scannet_stage1.sh's flags
     (--ngpus 1) at B=TRAIN_BATCH x 20000 points, random ViT-B/16, the 4 x 4
     pose projection, batches from the port's ScannetDetectionDataset with
     images; where OpenCV is not installed, a subclass defined here
     replaces only `_load_image` with a seeded 968 x 1296 frame: step ms,
     crops/s, E launched CLIP_LAYERS times a step; then phase 11's check on
     2 scenes (rects, targets within CLIP_TOL, loss and gradients).
 16. The secondary modes through `main` with phase 4's weights on the
     synthetic split (one batch of 32, the flagship at full width):
     --show_only, --show_box_points, --save_novel_with_class_only (its
     pseudo-label dir made), --save_seen_feat_only (with images) and
     --cal_class_only: files written, ms and kernels launched; each mode's
     first MODE_CPU_SCENES scenes again on the CPU: the same files, their
     numbers within MODE_TOL, the confusion matrix equal.  --crop_only needs
     OpenCV and is held on the CPU by tests/test_torch_port_modes.py.
 17. Data parallelism (parallel/ddp.py).  (a) The launcher's rank function
     starts DDP_WORLD ranks on the one card over gloo (a harness call: NCCL
     refuses two ranks on one card), each running `main` with
     scripts/coda_sunrgbd_stage1.sh's flags at full width, --ngpus 2
     --batchsize_per_gpu DDP_PER_RANK (global 8), DDP_STEPS steps on
     synthetic scenes, dropout 0 and each scene's crops pinned to its first
     --distillation_box_num proposals; beside them one process runs the same
     flags at --ngpus 1 and the global batch, from the same seed.  Held:
     every rank's host rows are its block of one process's batch, bit for
     bit; the ranks' all-reduced losses are equal and within DDP_TOL of one
     process's each step; the weights and BatchNorm statistics after the
     steps within DDP_TOL of their norm, and bit-equal across the ranks; A-E
     launched on every rank's every step (E once a layer); one set of files,
     rank 0's, with one process's names.  Then the ranks run --test_only on
     phase 13's scenes (a padded tail) from phase 4's weights at
     --batchsize_per_gpu_test BATCH / 2: rank 0 meters every scan; each
     batch it meters (the ranks' rows gathered in rank order, the padding
     dropped) has the ground truth of phase 13's one-process batch, bit for
     bit, and its outputs within MXU_TOL; the metrics are phase 13's within
     DDP_METRIC_TOL (with random weights they are all 0, so the batches are
     the check).  Printed beside the card's name and power limit, marked as
     gloo over one card's shared SMs (not a scaling number): each rank's
     step ms, the bytes and ms of its gradient all-reduce a step, its peak
     memory.  (b) `main --test_only --ngpus 8` (the scripts' value, at a
     free --dist_url) runs min(8, cards) ranks and says how many; with two
     or more cards (a)'s checks run again over NCCL, one card a rank, and
     with one card the script says that this part did not run.
 18. The bf16 paths.  (a) Kernels D-bf16 (the encoder's 32 x 4 x 2048 x
     64, the decoder's 32 x 4 x 128 x 2048 x 128 as its split policy cuts it, a
     radius case) and E-bf16 (128 and 256 crops x 12 x 197 x 64), each on
     bf16 inputs against its plain bf16 version: within the bound of
     bf16_attention_check (2^-7 sum_j p_j |v_j| plus one bf16 ulp of the
     row) with at least BF16_BIT_EQUAL of the elements bit-equal, timed
     like phase 3 beside SDPA in bf16 (the radius case with a boolean mask
     made outside the timed window) and kernel D in fp32; each bf16
     kernel's registers and spill bytes from the build's ptxas log (no
     spill); D-bf16's division (a reciprocal a row, two FMAs) bit-equal to
     __fdiv_rn on the encoder's (e, l) pairs and a ladder of e to 2^-149.
     (b) The flagship detector with --compute_dtype bf16 from phase 4's
     weights, its eval step on 32 x 20000 points (warm-up and STEPS timed):
     A, B, C and D-bf16 launch and nothing else, D-bf16 as often as its
     key-split policy says (3 encoder and 8 decoder layers, each with a
     combine where it splits); enc_inds, enc_xyz and
     query_xyz equal to the fp32 model's; the floats within BF16_MODEL_TOL
     of the same model through the plain bf16 attention (with D-bf16's key
     split), and their distance to the fp32 model printed.  (c)
     --clip_dtype bf16: the CLIP-crop eval step of phase 6 (E-bf16 once a
     row and layer, E not at all; sem_cls_prob's distance to the fp32
     tower's on the same crops) and one stage-1 step of phase 10's flags
     on 8 of the scenes (E-bf16 once a layer; a finite loss, the
     distillation loss above 0).  (d) `main --test_only --compute_dtype
     bf16` on phase 13's scenes and weights: metrics, launches (D-bf16, not
     D), scenes/s and the idle share.  The kernels line carries D-bf16 and
     E-bf16 as attention_bf16 and vit_attention_bf16, with their launches
     in (b) and (c), the CLI's and the stage-1 step's, and the decoder,
     radius and 256-crop shapes' times.
 19. The radius-masked encoder (--enc_type masked), point features and the
     sine embedding.  (a) The masked flagship (enc 256, dec 512, 2048
     pre-encoder points kept as 1024 by the interim SA, 128 queries) with
     random weights from a seed, eval step on STEPS batches of 32 x 20000
     synthetic scenes against phase 4's text bank: shapes, finite values,
     enc_inds (32, 1024) indices into the 20000 points that name enc_xyz,
     and the exact launch counts of A (3 a step), B (GRID_LAUNCHES for each
     of the two set abstractions), C (6: the two SAs' centres and xyz, the
     interim SA's 256-d features, the queries) and D (the three masked
     layers and the eight decoder layers, with a combine where
     `attention_splits` splits the 1024 keys), and no other kernel; step ms
     and peak memory.  Then D at the three radii (0.4^2 over the 2048
     pre-encoder points, 0.8^2 and 1.2^2 over the interim SA's 1024) against
     its plain version and fp32 SDPA with a boolean mask made outside the
     timed window (as D decides it), the bound counting the allowed pairs'
     products and every pair's distance test; D at the decoder's 1024 keys
     against SDPA; B at 32 x 1024 over 2048 bit for bit; C on the 256-d
     features (1.07 GB out) bit for bit against torch.gather, and the ms of
     the torch.cat that follows it in query_and_group.  (b) The same
     weights on the CPU on 2 scenes: integer outputs equal, floats within
     MODEL_TOL.  (c) `main --test_only --enc_type masked --test_ckpt` (a
     .pth of (a)'s weights with the encoder.interim_downsampling.* names) on
     phase 13's scenes: metrics with the JAX package's keys, (a)'s launches
     a step and nothing else, the first batch within MXU_TOL of (a)'s step,
     scenes/s and the idle share; then one batch with --compute_dtype bf16
     through build_model and the eval step: D (fp32, radius) in the encoder,
     D-bf16 in the decoder, nothing else, the indices equal to fp32's.  (d)
     The stage-1 step with --enc_type masked (phase 10's flags, dropout as
     shipped, MASKED_TRAIN_STEPS timed steps under CODA_BQ_ALGO=adaptive: A,
     G, C, D and E launch, G twice a step); the same step at dropout 0 from
     the same weights without and with --remat (loss within STEP_TOL,
     gradients within GRAD_TOL of their norm: C's backward adds with
     atomics; step ms and peak memory of both); phase 11's GPU-vs-CPU check
     of the masked step on 2 scenes.  (e) --use_color --pos_embed sine on
     the vanilla flagship: one eval batch of 6-channel scenes (C launched 4
     times: the colours grouped beside the xyz) and GPU vs CPU on 2 scenes.
     Phase 19 prints its seconds, part by part.  The kernels line gives
     each kernel masked_launches, masked_cli_launches and
     masked_stage1_launches; attention carries masked_enc0/1/2_* and
     masked_dec_* (ms, plain, bound, library), ball_query interim_*, gather
     interim_c256_*.
 20. The bf16 detector's training (--compute_dtype bf16).  (a) ptxas's
     log holds no note that it serialized D-bf16's wgmma (C7510-C7515);
     D-bf16 with attention-weight dropout 0.1 against its plain bf16
     version with the same seed, at the bf16 training step's encoder
     (8 x 4 x 2048 x 64) and split decoder cross-attention (Sq 128, Skv
     2048, D 128) and at 1001 keys (padded to 1008; unsplit at D 64, split
     at D 128): values within phase 18 (a)'s bound, and each pair's drop,
     read through a one-hot V, where the hash drops it, in the kernel and
     the plain version alike; the kernel's time with dropout, without it
     (in turns), its bound and SDPA bf16 with dropout_p.  (b) The bf16 backward (dq, dk, dv through
     MaskedAttention's plain bf16 recompute) against the fp32 backward on
     the card within BF16_BACKWARD_TOL, timed beside it and SDPA's bf16
     backward.  (c) The bf16 stage-1 step (CODA_BQ_ALGO=adaptive, the bf16
     tower) and the bf16 baseline step (CODA_BQ_FUSED_GATHER=1) at full
     width, B = 8 x 20000: TRAIN_STEPS timed steps each, D-bf16's exact
     launches a step and no kernel D, E-bf16 once a tower layer, step ms
     and peak memory beside phases 8 and 10's fp32 steps and phase 18
     (c)'s. (d) One bf16 step on 2 scenes GPU vs CPU: the loss within
     BF16_STEP_RTOL of its size, the largest gradient element within
     BF16_GRAD_RTOL of the gradient's norm and the difference's norm within
     BF16_GRAD_NORM_RTOL of it, the assignments the GPU's where the costs
     tie.  (e) main
     with scripts/coda_sunrgbd_stage1.sh's flags and --compute_dtype bf16
     for one epoch (scenes/s, the idle share), then main --compute_dtype
     bf16 --test_only --show_only from its checkpoint.  The kernels line
     gives D-bf16 train_launches (a stage-1 step), baseline_train_launches
     and train_cli_launches, train_dropout_* and train_dropout_decoder_*
     (ms, plain, bound, library, nodrop) and backward_* (its ms, the fp32
     backward's, bound, SDPA's, the largest relative error); E-bf16
     train_launches and train_cli_launches.
 21. Tensor parallelism (parallel/tp.py).  Stage 1's step at full width
     (phase 17 (a)'s flags: dropout 0, the crops pinned, a random ViT-B/16
     teacher from a seed) at a global batch of TP_BATCH for TP_STEPS steps,
     first in one process, then (a) on a grid of dp 1 x mp 2, two ranks on
     the one card over gloo, and (b) with four or more cards, dp 2 x mp 2
     over NCCL, one card a rank: the detector's
     attention heads and FFN and the teacher's heads and MLP sharded over
     mp.  Held: each step's loss within TP_LOSS_TOL of one process's and
     its gradients' global norm (the clip's) within TP_NORM_RTOL; the
     gathered weights within TP_WEIGHT_TOL of their norm; the replicated
     parameters bit-equal on every rank and each shard on its dp peers;
     kernel D called at 2 heads and E at 6 on every rank, A-E launched
     every step; the mp all-reduces a step, forward and backward, as many
     as the blocks switched to the grid call for.  Printed: each rank's
     step ms, the bytes of the mp all-reduces a step and their ms replayed
     alone, the dp gradient all-reduce's bytes and ms, peak memory.  Then D
     (encoder, decoder) and E (256 crops) against their plain versions at
     the local heads, timed beside SDPA.  The kernels line gives each
     kernel tp_launches (rank 0's over (a)'s steps), and D and E a "tp"
     entry of those rows.
 22. The crop kernel (csrc/crop.cu) at the cells' shapes, run after phase 7:
     CROP_CASES rects a scene on phase 4's 531 x 730 frames (32 x 128, the
     CLIP-crop eval's batch; 8 x 32, a stage-1 step's), seeded, with the
     whole frame and a zero-width rect among them, through `clip_crops`
     (one launch) and unnormalised: a scene at a time against the plain
     path on the card, the integers equal except where the plain sum lies
     within 1e-3 of a half (there at most 1 apart; the count that differ is
     printed, 0 where the kernel sums in PyTorch's order), the normalised
     values bit-equal to the plain normalisation of its integers.  Timed
     in turns: the kernel and the plain path a scene at a time (as the
     einsum path ran), beside the bound (the output's and the frames' bytes
     over HBM_RATE, the separable sums' operations, counted from the
     interpolation matrices' nonzero taps, over FP32_PEAK).
     Phases 6 and 10 (and 15 (b)) hold the kernel to one launch a batch or
     step.
Phase 3 also holds kernel F against its plain version and against kernel B
followed by kernel C, bit for bit; kernels B and F (a cell grid) on a
degenerate scene (PLANE_POINTS of each scene's points on one z) and against
the scan kernels they replaced, which it times in turns with them, beside
the grid build on its own; kernel G (tiles of nearby centres on B's grid)
against its plain version, kernel B and the old G (a scan, also from
scripts/ball_query_variants.cu), bit for bit, on the eval SA, stage 1's 8
scenes, the plane, a uniform cloud, ScanNet's 40000 points and the masked
encoder's interim SA, each with G's time and the old G's in turns, B's,
G's build, sort and query alone, the points a centre tests and stages
and the host's time a call; and D in training (with and
without its attention-weight dropout: the output, and q, k, v gradients
through its autograd Function) against its plain version and autograd of it.
The CODA_BQ_* variables are cleared at the start; each phase sets its own.
Where one PyTorch call computes a kernel's function (C: torch.gather, D and
E: scaled_dot_product_attention), phase 3 times the kernel and that call in
turns (kernel, library, kernel, library) and reports each one's mean of the
two medians, so the two are compared on one card; D is so timed at the
encoder's and at the decoder's shape.
The line before the last is {"kernels": [...]}, each kernel with its time,
its plain version's, its bound (the larger of its operations over the
card's peak rate for them and its bytes over the memory rate, counted from
this run's inputs; for the attention kernels D and E, whose products run in
3xTF32 on the tensor cores, QK and PV at TF32_PEAK / 3 and the softmax at
the fp32 peak), and the time of one PyTorch call computing the same
function where there is one; for the ball queries B, F and G the bound
counts the distance tests a grid of cell side r needs on these inputs (the
scan's count is printed beside it, and carried as scan_bound_ms by B, F and
G, with the scan kernel's time scan_ms and the grid build's build_ms; G also
carries B's time, its sort and query alone and, as stage1_*, its times at
the stage-1 step's 8 scenes); the
attention entry also carries the
decoder shape's kernel, plain, library and bound times, the vit_attention
entry those at 256 crops (stage1_*), the fps entry its cluster size and
barrier floor at the main shape, and A and B their ScanNet rows
(scannet_b32, scannet_b48), with scannet_cli_launches,
scannet_stage1_launches and ddp_launches (rank 0's over phase 17 (a)'s
steps) beside train_cli_launches.  The last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

DEVICE = "cuda"  # the card; only a rehearsal of the phases on the CPU sets "cpu"
BATCH = 32
NUM_POINTS = 20000
EVAL_CLASSES = 46
STEPS = 3
REPS = 7
SPAN_MS = 5.0  # a timed run of phase 3 spans at least this long
# phase 3's sweep of kernel C: the xyz branch (3), the 16-byte tile branch
# (C % 4 == 0 on aligned features) and the single-float one (the rest)
GATHER_WIDTHS = (1, 2, 4, 5, 8, 16, 64, 128, 256, 259, 512)
SEED = 0
# fp32 attention: the kernel sums the 64/128-term dot products and the
# softmax-weighted values in another order than cuBLAS, in 3xTF32 (about 22
# of fp32's 24 bits), and rescales its running sum tile by tile; outputs are
# O(1), so 1e-4 absolute is ~1e-5 relative, far above that rounding and far
# below any indexing or masking error (single-pass TF32 would exceed it).
ATTN_TOL = 1e-4
# GPU vs CPU, whole model: the same integer indices, but every matmul sums in
# another order on each device (cuBLAS vs the CPU BLAS) through 3 encoder and
# 8 decoder layers; corners are metres, scores probabilities.
MODEL_TOL = 1e-3
# fp32 ViT attention, S = 197, D = 64: as ATTN_TOL; the kernel takes an exact
# two-pass softmax and multiplies by the reciprocal of the row sum, cuBLAS
# and torch.softmax sum in their own orders; outputs are O(1).
VIT_ATTN_TOL = 1e-4
# GPU vs CPU, CLIP crop scores of one scene: every matmul of the 12 tower
# layers sums in another order on each device (about 1e-5 relative on the
# embeddings), the logit scale of 100 turns that into about 1e-3 of a logit,
# and a crop pixel whose bicubic value lies at a half-integer may round the
# other way (one input value moves by 1/255).
CLIP_TOL = 2e-3
IMAGE_HW = (531, 730)  # the padded SUN RGB-D image, datasets/config.py image_size
CLIP_LAYERS = 12
TRAIN_BATCH = 8  # batchsize_per_gpu of scripts/coda_baseline_sunrgbd.sh
TRAIN_STEPS = 5
# GPU vs CPU, one training step: as MODEL_TOL for the forward, and the loss
# sums 8 layers of losses (center weight 5) over 2 scenes
STEP_TOL = 1e-3
# GPU vs CPU gradients, as a share of their global norm: the backward sums
# every GEMM and reduction in another order on each device
GRAD_TOL = 1e-3

KERNELS = {
    "fps": ("coda_neurips2023_tpu_torch/csrc/fps.cu",
            "coda_neurips2023_tpu/ops/pallas_fps.py:101"),
    "ball_query": ("coda_neurips2023_tpu_torch/csrc/ball_query.cu",
                   "coda_neurips2023_tpu/ops/pallas_ball_query_sorted.py:399"),
    "gather": ("coda_neurips2023_tpu_torch/csrc/gather.cu",
               "coda_neurips2023_tpu/ops/pallas_group_gather.py:150"),
    "attention": ("coda_neurips2023_tpu_torch/csrc/attention.cu",
                  "coda_neurips2023_tpu/ops/pallas_masked_attention.py:121"),
    "vit_attention": ("coda_neurips2023_tpu_torch/csrc/vit_attention.cu",
                      "coda_neurips2023_tpu/ops/pallas_vit_attention.py:109"),
    "ball_query_group": ("coda_neurips2023_tpu_torch/csrc/ball_query_group.cu",
                         "coda_neurips2023_tpu/ops/pallas_ball_query_sorted.py:461"),
    "ball_query_tile": ("coda_neurips2023_tpu_torch/csrc/ball_query_tile.cu",
                        "coda_neurips2023_tpu/ops/pallas_ball_query.py:346"),
    "crop": ("coda_neurips2023_tpu_torch/csrc/crop.cu",
             "none: the einsum crops of coda_neurips2023_tpu/models/distillation.py:110, left to XLA"),
}
# the card's peaks for the bound (NVIDIA's H100 SXM data sheet, 700 W): fp32
# outside the tensor cores, TF32 on them (dense), and device memory
FP32_PEAK = 67e12  # FLOP/s
TF32_PEAK = 495e12  # FLOP/s; an fp32-accurate (3xTF32) product runs at a third
HBM_RATE = 3.35e12  # bytes/s
# a distance test of the ball query: 3 sub, 3 mul, 2 add, 1 compare
BQ_OPS = 9
# an FPS step for one point: the distance (8), its running min, the argmax compare
FPS_OPS = 10
BQ_VARS = ("CODA_BQ_ALGO", "CODA_BQ_MXU", "CODA_BQ_FUSED_GATHER")
SCANNET_POINTS = 40000  # datasets/scannet.py's point count
# phase 3's degenerate scene: this many points of each scene moved onto z = PLANE_Z
PLANE_POINTS = 5000
PLANE_Z = 1.0
N_SEL = 32  # --distillation_box_num, main.py's default
# phase 22: (scenes, rects a scene) of the CLIP-crop eval's batch and a
# stage-1 step's, at CLIP's crop size
CROP_CASES = ((BATCH, 128), (TRAIN_BATCH, N_SEL))
CROP_SIZE = 224
# phase 11: a crop rect is an integer truncation of projected corners; the
# two devices' boxes differ by about 1e-5 m, a few thousandths of a pixel,
# so boxes whose rect coordinates lie this far from an integer cut the same
# crop on both
RECT_MARGIN = 0.05
# phase 12: kernel G is bit-equal to kernel B, so the eval outputs may only
# differ where a kernel sums in a run-dependent order
MXU_TOL = 1e-5
# phase 13: --synthetic_num_scenes; the real_test split is a quarter of it,
# 70 scenes: 2 batches of 32 and a tail of 6 padded to 32
CLI_SCENES = 280
CLI_WORKERS = (8, 0)  # CODA_AP_WORKERS of phase 13's two runs
CLI_KERNELS = ("fps", "ball_query", "gather", "attention", "vit_attention")
CLIP_SCENES = 8  # phase 13's --if_with_clip run: one batch, padded to BATCH rows
# test_release_models.sh's flags for the SUN RGB-D stage-1 model (the
# flagship's widths) on the synthetic split
CLI_ARGS = [
    "--test_only", "--dataset_name", "synthetic", "--model_name", "3detr_predictedbox_distillation",
    "--test_num_semcls", "46", "--test_range_max", "46", "--enc_dim", "256", "--dec_dim", "512",
    "--nqueries", "128", "--num_semcls", "2", "--batchsize_per_gpu_test", "32", "--if_use_v1",
    "--num_points", "20000", "--seed", str(SEED),
]
# the flagship detector's flags (the JAX package's defaults, main.py)
FLAGSHIP_ARGS = dict(
    enc_dim=256, dec_dim=512, enc_type="vanilla", enc_nlayers=3, enc_nhead=4, enc_ffn_dim=128,
    enc_activation="relu", dec_nlayers=8, dec_nhead=4, dec_ffn_dim=256, preenc_npoints=2048,
    nqueries=128, mlp_dropout=0.3, pos_embed="fourier", use_color=False,
)
# StageContext's flags for the 46-class SUN RGB-D eval (scripts/coda_baseline_sunrgbd.sh)
CLIP_ARGS = dict(
    model_name="3detrmulticlasshead", dataset_name="sunrgbd", train_range_max=10,
    test_range_max=46, if_clip_more_prompts=True, if_clip_superset=False,
    clip_model_path=None, clip_bpe_path=None,
)
# the baseline's training flags (scripts/coda_baseline_sunrgbd.sh, main.py's
# defaults for the rest, bench_train.py's optimizer)
TRAIN_ARGS = dict(
    model_name="3detrmulticlasshead", enc_dropout=0.1, dec_dropout=0.1,
    base_lr=1.97e-4, warm_lr=1e-6, warm_lr_epochs=18, final_lr=1e-6, lr_scheduler="cosine",
    weight_decay=0.1, filter_biases_wd=False, clip_gradient=0.1, max_epoch=1080,
    matcher_cls_cost=1, matcher_giou_cost=3, matcher_center_cost=5, matcher_objectness_cost=5,
    loss_giou_weight=0.0, loss_sem_cls_weight=0.0, loss_sem_cls_softmax_weight=0.0,
    loss_sem_cls_softmax_skip_none_gt_sample_weight=1.0, loss_no_object_weight=0.05,
    loss_angle_cls_weight=0.1, loss_angle_reg_weight=0.5, loss_center_weight=5.0,
    loss_size_weight=1.0,
)
# stage 1 on top of the baseline (scripts/coda_sunrgbd_stage1.sh; main.py's
# defaults for the rest), with StageContext's flags
STAGE1_ARGS = dict(
    CLIP_ARGS, model_name="3detr_predictedbox_distillation", dataset_name="sunrgbd_anonymous_aligned_image",
    loss_predicted_region_embed_l1_weight=1.0, loss_no_object_contrast_weight=0.05,
    distillation_box_num=N_SEL, if_clip_weak_labels=False,
)


def matcher_solve_ms(t0, t1):
    """Host ms of the matcher:solve spans (the solve and the copy back up)
    that ended between t0 and t1."""
    from coda_neurips2023_tpu_torch.utils import spans

    return 1e3 * sum(s.t1 - s.t0 for s in spans.between(t0, t1) if s.name == "matcher:solve")


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_in_turns(torch, *fns, rounds=2):
    """Each fn's mean over `rounds` of its `time_ms`, the fns timed in turns
    (a, b, a, b), so a kernel and its yardstick share the card's state."""
    times = [[] for _ in fns]
    for _ in range(rounds):
        for t, fn in zip(times, fns):
            t.append(time_ms(torch, fn))
    return [statistics.fmean(t) for t in times]


def time_ms(torch, fn, reps=REPS, warmup=2):
    """Median, over `reps` runs after `warmup`, of CUDA-event milliseconds a
    call, each run a stretch of back-to-back calls spanning about SPAN_MS,
    so a short kernel's host-side launch cost overlaps the calls before it,
    as on the paths, instead of idling the card inside the measurement."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    calls = max(1, min(100, int(SPAN_MS / max((time.perf_counter() - t0) * 1e3, 1e-3))))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound(flops, nbytes, tc_flops=0):
    """(the least ms the card could take, what bounds it): the larger of the
    operations' time and the bytes over the memory rate.  The operations'
    time is `flops` over the fp32 peak plus `tc_flops`, fp32-accurate
    (3xTF32) tensor-core products, over TF32_PEAK / 3."""
    ops_ms = (flops / FP32_PEAK + tc_flops / (TF32_PEAK / 3)) * 1e3
    bytes_ms = nbytes / HBM_RATE * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def scan_tests(torch, radius, k, xyz, centres):
    """The distance tests of a scan in index order (the bound's count before
    the grid): each centre reads its points up to its k-th hit, or all N."""
    from coda_neurips2023_tpu_torch.ops.grouping import _r2, _sq_dist

    r2 = _r2(radius).to(xyz.device)
    n = xyz.shape[1]
    total = 0
    for bi in range(xyz.shape[0]):
        hit = _sq_dist(centres[bi, :, None, :], xyz[bi, None, :, :]) < r2
        reached = hit.cumsum(1, dtype=torch.int32) >= k
        total += int(torch.where(reached.any(1), reached.int().argmax(1) + 1, n).sum())
    return total


def ball_query_bound(torch, radius, k, xyz, centres, grouped=False):
    """(the grid bound, the scan bound): the larger of the distance tests'
    time and the bytes' (points and centres read once, indices written
    once, for F the coordinates too), with the tests a grid of cell side r
    needs on these inputs (the points of the cells each centre reads), and
    with those of a scan in index order, for comparison with earlier rows."""
    from coda_neurips2023_tpu_torch.ops.grouping import ball_query_grid_candidates

    b, n, _ = xyz.shape
    m = centres.shape[1]
    nbytes = 12 * (b * n + b * m) + 4 * b * m * k + (12 * b * m * k if grouped else 0)
    grid = int(ball_query_grid_candidates(radius, xyz, centres, side_factor=1.0).sum())
    return (bound(BQ_OPS * grid, nbytes),
            bound(BQ_OPS * scan_tests(torch, radius, k, xyz, centres), nbytes))


def load_scan_kernels(lib_path):
    """The scan kernels B, F and G were before the grid (scripts/ball_query_variants.cu,
    a yardstick; not kernels of the path, so never counted) as functions of
    (kernel name, radius, k, xyz, centres)."""
    import ctypes

    import torch

    from coda_neurips2023_tpu_torch.ops.grouping import _r2

    lib = ctypes.CDLL(str(lib_path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bq_scan.argtypes = [p, p, p, i, i, i, i, f, p]
    lib.bq_tile_scan.argtypes = [p, p, p, i, i, i, i, f, p]
    lib.bq_group_scan.argtypes = [p, p, p, p, i, i, i, i, f, p]

    def call(name, radius, k, x, c):
        b, n, _ = x.shape
        m = c.shape[1]
        idx = torch.empty((b, m, k), dtype=torch.int32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        r2 = float(_r2(radius))
        out = None
        if name == "ball_query_group":
            out = torch.empty((b, m, k, 3), dtype=torch.float32, device=x.device)
            err = lib.bq_group_scan(x.data_ptr(), c.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                    b, n, m, k, r2, stream)
        else:
            fn = lib.bq_tile_scan if name == "ball_query_tile" else lib.bq_scan
            err = fn(x.data_ptr(), c.data_ptr(), idx.data_ptr(), b, n, m, k, r2, stream)
        if err != 0:
            fail(f"scan kernel of {name}: CUDA error {err} at launch")
        return idx if out is None else (idx, out)

    return call


def tile_steps(torch, r, k, x, c):
    """Kernel G's steps timed alone (not launches of a path): its whole
    build (the grid and the centres' order), the build's sort of the points'
    and centres' keys as one array and of the points' keys alone, and the
    query on a built grid."""
    from coda_neurips2023_tpu_torch import _kernels
    from coda_neurips2023_tpu_torch.ops import grouping

    b, n, _ = x.shape
    m = c.shape[1]
    sf = grouping.TILE_SIDE_FACTOR
    cap = grouping.grid_cap(n)
    build = lambda: grouping.grid_build(r, x, sf, "ball_query_tile", centres=c)
    f = torch.empty((b, 4), device=x.device)
    i = torch.empty((b, 4), dtype=torch.int32, device=x.device)
    keys = torch.empty((b * (n + m),), dtype=torch.int32, device=x.device)
    _kernels.launch("coda_bq_grid_cells", x, c, f, i, keys, b, n, m, grouping.grid_side(r, sf),
                    cap, count_as="ball_query_tile")
    points = keys[: b * n]
    *grid, ctr = build()
    idx = torch.empty((b, m, k), dtype=torch.int32, device=x.device)
    query = lambda: _kernels.launch(
        "coda_ball_query_tile", *grid, ctr, idx, b, n, m, k, cap + 1,
        float(grouping._r2(r)), grouping.grid_radius(r), grouping.TILE_SIZE)
    return {"build_ms": time_ms(torch, build),
            "sort_ms": time_ms(torch, lambda: torch.sort(keys, stable=True)),
            "points_sort_ms": time_ms(torch, lambda: torch.sort(points, stable=True)),
            "query_ms": time_ms(torch, query)}


def host_us(torch, fn, calls=20):
    """The host's microseconds a call takes to return, calls back to back
    without a synchronise (their enqueue)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def attention_bound(b, h, sq, skv, d, tensor_cores=True):
    """QK and PV (2 x 2D a query-key pair) in 3xTF32 on the tensor cores, and
    the softmax's max, subtract, exp, sum, scale at the fp32 peak; with
    `tensor_cores` False, every operation at the fp32 peak, for comparison."""
    pairs = b * h * sq * skv
    nbytes = 4 * b * h * (2 * sq * d + 2 * skv * d)
    if not tensor_cores:
        return bound(pairs * (4 * d + 5), nbytes)
    return bound(pairs * 5, nbytes, tc_flops=pairs * 4 * d)


def fps_floor(torch, xyz, npoint, cs):
    """Kernel A's loop at cluster size cs without its points' work (not a
    launch of the path, so not counted)."""
    from coda_neurips2023_tpu_torch import _kernels

    b, n, _ = xyz.shape
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    err = _kernels.library().coda_fps_barrier_floor(xyz.data_ptr(), out.data_ptr(), b, n, npoint,
                                                    cs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"coda_fps_barrier_floor: CUDA error {err} at launch")


def gather_sweep(torch):
    """Phase 3: kernel C at every width of GATHER_WIDTHS, each case bit for
    bit against group_points_plain: (B, 2048, C) features aligned and one
    element into their storage, gathered at (B, 1024, 32) indices with the
    ball query's padding, at ragged (B, 1023, 31) ones and as gather_points'
    (B, 1, 1021) view; for C >= 64 kernel and torch.gather ms in turns
    beside the bytes bound (aligned features, the (B, 1024, 32) indices)."""
    from coda_neurips2023_tpu_torch.ops import grouping, sampling

    b, n = 4, 2048
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 18)
    idx = torch.randint(0, n, (b, 1024, 32), device=DEVICE, generator=gen, dtype=torch.int32)
    hits = torch.randint(1, 33, (b, 1024, 1), device=DEVICE, generator=gen)
    idx = torch.where(torch.arange(32, device=DEVICE) < hits, idx, idx[..., :1])
    ragged = idx[:, :1023, :31].contiguous()
    sel = idx[:, :, 0].reshape(-1)[: b * 1021].reshape(b, 1021).contiguous()
    for c in GATHER_WIDTHS:
        feats = torch.randn((b, n, c), device=DEVICE, generator=gen)
        storage = torch.empty(feats.numel() + 1, device=DEVICE)
        storage[1:] = feats.reshape(-1)
        for where, f in (("aligned", feats), ("offset", storage[1:].view(b, n, c))):
            for label, got, want in (
                ("1024x32", lambda: grouping.group_points(f, idx),
                 lambda: grouping.group_points_plain(f, idx)),
                ("1023x31", lambda: grouping.group_points(f, ragged),
                 lambda: grouping.group_points_plain(f, ragged)),
                ("gather_points 1021", lambda: sampling.gather_points(f, sel),
                 lambda: grouping.group_points_plain(f, sel[:, None, :]).reshape(b, 1021, c)),
            ):
                a, w = got(), want()
                torch.cuda.synchronize()
                if a.shape != w.shape or not torch.equal(a, w):
                    fail(f"gather C={c} {where} {label}: kernel differs from plain version")
        line = f"  {'gather':16s} {f'B={b} N={n} C={c} aligned and offset, 3 index shapes':44s}"
        if c >= 64:
            flat = idx.reshape(b, -1, 1).long().expand(-1, -1, c)
            ms, library_ms = time_in_turns(torch, lambda: grouping.group_points(feats, idx),
                                           lambda: torch.gather(feats, 1, flat))
            bnd = bound(0, 4 * (feats.numel() + idx.numel() + idx.numel() * c))
            line += f" kernel_ms={ms!r} library_ms={library_ms!r} bound_ms={bnd[0]!r} ({bnd[1]})"
        print(line + " bit-equal")


def compare_kernels(torch, xyz, xyz40, scan, results):
    """Phase 3: each kernel vs its plain version at the paths' shapes;
    `scan` runs the scan kernels B and F replaced (load_scan_kernels)."""
    from coda_neurips2023_tpu_torch.ops import grouping, sampling
    from coda_neurips2023_tpu_torch.utils.device import multi_processor_count
    from coda_neurips2023_tpu_torch.ops.masked_attention import (
        masked_attention,
        masked_attention_plain,
    )
    from coda_neurips2023_tpu_torch.ops.vit_attention import vit_attention, vit_attention_plain

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def record(name, label, err, ms, plain_ms, main_shape, bnd=None, library_ms=None):
        entry = results.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if main_shape:
            entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                         library_ms=library_ms)
        extra = f" bound_ms={bnd[0]!r} ({bnd[1]})" if bnd else ""
        extra += f" library_ms={library_ms!r}" if library_ms is not None else ""
        print(f"  {name:16s} {label:44s} max_abs_err={err!r} kernel_ms={ms!r} "
              f"plain_ms={plain_ms!r}{extra}")

    def exact(name, label, kern, plain, main_shape=True, bnd=None, library=None):
        a, b = kern(), plain()
        torch.cuda.synchronize()
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            bad = (a != b).sum().item() if a.shape == b.shape else "shape"
            fail(f"{name} {label}: kernel differs from plain version ({bad} entries)")
        if library is not None:
            ms, library_ms = time_in_turns(torch, kern, library)
        else:
            ms, library_ms = time_ms(torch, kern), None
        record(name, label, 0.0, ms, time_ms(torch, plain), main_shape, bnd, library_ms)
        return a

    sm_count = multi_processor_count(xyz.device)

    def fps(x, m, main_shape=False):
        """Kernel A bit for bit at its policy's cluster size, and the floor
        of its loop (the same barriers and merge, no points' work)."""
        nb, nn = x.shape[:2]
        cs = sampling.fps_cluster_size(nb, nn, sm_count,
                                       lambda c: sampling.resident_clusters(x.device, c))
        got = exact("fps", f"B={nb} N={nn} -> {m}, cluster of {cs}",
                    lambda: sampling.furthest_point_sample(x, m),
                    lambda: sampling.furthest_point_sample_plain(x, m), main_shape,
                    bound(FPS_OPS * nb * (m - 1) * nn, 12 * nb * nn + 4 * nb * m))
        floor_ms = time_ms(torch, lambda: fps_floor(torch, x, m, cs))
        print(f"  {'':16s} {'':44s} barrier floor_ms={floor_ms!r} ({m - 1} steps, cluster of {cs})")
        if main_shape:
            results["fps"].update(floor_ms=floor_ms, cluster_size=cs)
        return got

    b, n = xyz.shape[:2]
    inds = fps(xyz, 2048, main_shape=True)
    centres = exact("gather", f"gather_points B={b} N={NUM_POINTS} M=2048",
                    lambda: sampling.gather_points(xyz, inds),
                    lambda: grouping.group_points_plain(xyz, inds[:, None, :]).reshape(b, 2048, 3),
                    main_shape=False)
    q_inds = fps(centres, 128)
    fps(xyz[:TRAIN_BATCH].contiguous(), 2048)
    fps(xyz40, 2048)
    exact("gather", f"gather_points B={b} N=2048 M=128",
          lambda: sampling.gather_points(centres, q_inds),
          lambda: grouping.group_points_plain(centres, q_inds[:, None, :]).reshape(b, 128, 3),
          main_shape=False)
    def grid_row(name, label, r, k, x, c, main):
        """Kernel B (or F) bit for bit against its plain version, timed in
        turns against the scan it replaced (also held against the plain
        version), and its grid build timed on its own."""
        grouped = name == "ball_query_group"
        if grouped:
            kern = lambda: grouping.ball_query_group(r, k, x, c)
            plain = lambda: grouping.ball_query_group_plain(r, k, x, c)
        else:
            kern = lambda: grouping.ball_query(r, k, x, c)
            plain = lambda: grouping.ball_query_plain(r, k, x, c)
        old = lambda: scan(name, r, k, x, c)
        got, want, old_out = kern(), plain(), old()
        torch.cuda.synchronize()
        outs = (got, want, old_out) if grouped else ((got,), (want,), (old_out,))
        for what, ref in (("plain version", outs[1]), ("scan kernel", outs[2])):
            if not all(torch.equal(g, w) for g, w in zip(outs[0], ref)):
                fail(f"{name} {label}: kernel differs from the {what}")
        ms, scan_ms = time_in_turns(torch, kern, old)
        build_ms = time_ms(torch, lambda: grouping.grid_build(r, x, count_as=name))
        bnd, scan_bnd = ball_query_bound(torch, r, k, x, c, grouped)
        record(name, label, 0.0, ms, time_ms(torch, plain), main, bnd)
        print(f"  {'':16s} {'':44s} scan_ms={scan_ms!r} build_ms={build_ms!r} "
              f"scan bound_ms={scan_bnd[0]!r} ({scan_bnd[1]})")
        if main:
            results[name].update(scan_ms=scan_ms, build_ms=build_ms, scan_bound_ms=scan_bnd[0])
        return got

    idx = grid_row("ball_query", f"B={b} N={NUM_POINTS} M=2048 r=0.2 k=64", 0.2, 64, xyz, centres,
                   True)
    flat = idx.reshape(b, -1, 1).long().expand(-1, -1, 3)
    exact("gather", f"group_points B={b} N={NUM_POINTS} M=2048 K=64",
          lambda: grouping.group_points(xyz, idx),
          lambda: grouping.group_points_plain(xyz, idx),
          bnd=bound(0, 4 * (3 * b * n + idx.numel() * 4)),
          library=lambda: torch.gather(xyz, 1, flat))
    two_op = lambda: grouping.group_points(xyz, grouping.ball_query(0.2, 64, xyz, centres))
    for n_scenes in (b, TRAIN_BATCH):
        x, c = xyz[:n_scenes].contiguous(), centres[:n_scenes].contiguous()
        label = f"B={n_scenes} N={NUM_POINTS} M=2048 r=0.2 k=64"
        got = grid_row("ball_query_group", label, 0.2, 64, x, c, n_scenes == TRAIN_BATCH)
        bc = lambda: (lambda i: (i, grouping.group_points(x, i)))(grouping.ball_query(0.2, 64, x, c))
        if not all(torch.equal(g, w) for g, w in zip(got, bc())):
            fail(f"ball_query_group {label}: differs from kernel B then kernel C")
        if n_scenes == b and not torch.equal(got[1], two_op()):
            fail("ball_query_group: differs from group_points(ball_query) of phase 3")
        print(f"  {'':16s} {'':44s} kernels B then C ms={time_ms(torch, bc)!r}")
    half = sampling.gather_points(centres, sampling.furthest_point_sample(centres, 1024))
    grid_row("ball_query", f"B={b} N=2048 M=1024 r=0.4 k=32", 0.4, 32, centres, half, False)
    # a degenerate scene: PLANE_POINTS of each scene's points moved onto one
    # z, a wall that puts hundreds of points into each of its cells
    plane = xyz.clone()
    plane[:, :PLANE_POINTS, 2] = PLANE_Z
    plane_c = sampling.gather_points(plane, sampling.furthest_point_sample(plane, 2048))
    for name, nb in (("ball_query", b), ("ball_query_group", TRAIN_BATCH)):
        grid_row(name, f"plane B={nb} N={NUM_POINTS} M=2048 r=0.2 k=64", 0.2, 64,
                 plane[:nb].contiguous(), plane_c[:nb].contiguous(), False)

    # kernel G against its plain version, kernel B and the old G (a scan),
    # bit for bit, on B's scenes and shapes: the eval SA (main), the stage-1
    # step's 8 scenes, the plane, a uniform cloud, ScanNet's 40,000 points,
    # the masked encoder's interim SA
    box = torch.tensor([8.0, 8.0, 3.0], device=xyz.device)
    uniform = (torch.rand(xyz.shape, device=xyz.device,
                          generator=torch.Generator(device=xyz.device).manual_seed(SEED))
               * box - box * torch.tensor([0.5, 0.5, 0.0], device=xyz.device))
    uniform_c = sampling.gather_points(uniform, sampling.furthest_point_sample(uniform, 2048))
    centres40 = sampling.gather_points(xyz40, sampling.furthest_point_sample(xyz40, 2048))
    nt = TRAIN_BATCH
    for label, x, c, r, k, key in (
        (f"B={b} N={NUM_POINTS} M=2048 r=0.2 k=64", xyz, centres, 0.2, 64, "main"),
        (f"B={nt} N={NUM_POINTS} M=2048 r=0.2 k=64", xyz[:nt].contiguous(),
         centres[:nt].contiguous(), 0.2, 64, "stage1"),
        (f"plane B={b} N={NUM_POINTS} M=2048 r=0.2 k=64", plane, plane_c, 0.2, 64, "plane"),
        (f"uniform B={b} N={NUM_POINTS} M=2048 r=0.2 k=64", uniform, uniform_c, 0.2, 64,
         "uniform"),
        (f"B={xyz40.shape[0]} N={SCANNET_POINTS} M=2048 r=0.2 k=64", xyz40, centres40, 0.2, 64,
         "scannet"),
        (f"B={b} N=2048 M=1024 r=0.4 k=32", centres, half, 0.4, 32, "masked"),
    ):
        kern = lambda: grouping.ball_query_tile(r, k, x, c)
        via_b = lambda: grouping.ball_query(r, k, x, c)
        plain = lambda: grouping.ball_query_plain(r, k, x, c)
        old = lambda: scan("ball_query_tile", r, k, x, c)
        got = kern()
        torch.cuda.synchronize()
        for what, ref in (("plain version", plain), ("kernel B", via_b), ("old kernel G", old)):
            if not torch.equal(got, ref()):
                fail(f"ball_query_tile {label}: differs from the {what}")
        ms, old_ms = time_in_turns(torch, kern, old)
        bnd, scan_bnd = ball_query_bound(torch, r, k, x, c)
        record("ball_query_tile", label, 0.0, ms, time_ms(torch, plain), key == "main", bnd)
        steps = tile_steps(torch, r, k, x, c)
        tested, staged = (t.float() for t in grouping.ball_query_tile_candidates(r, x, c))
        b_ms = time_ms(torch, via_b)
        print(f"  {'':16s} {'':44s} old G ms={old_ms!r} kernel B ms={b_ms!r} "
              + " ".join(f"{name}={v!r}" for name, v in steps.items())
              + f" tested a centre: mean {tested.mean().item()!r} max {int(tested.max())}"
              f" staged a centre: mean {(staged / grouping.TILE_SIZE).mean().item()!r}"
              f" a tile: max {int(staged.max())}"
              f" host_us_a_call={host_us(torch, kern)!r} scan bound_ms={scan_bnd[0]!r}")
        if key == "main":
            results["ball_query_tile"].update(scan_ms=old_ms, b_ms=b_ms, **steps,
                                              scan_bound_ms=scan_bnd[0])
        elif key == "stage1":
            results["ball_query_tile"].update(stage1_ms=ms, stage1_scan_ms=old_ms,
                                              stage1_b_ms=b_ms, stage1_bound_ms=bnd[0])
    del uniform, uniform_c, plane, plane_c

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, device=DEVICE, generator=gen)

    cases = [
        ("encoder self-attention S=2048 H=4 D=64", 2048, 2048, 64, 0.0, "encoder"),
        ("decoder cross-attention Sq=128 Skv=2048 H=4 D=128", 128, 2048, 128, 0.0, "decoder"),
        ("radius-masked S=2048 H=4 D=64 r=1.2**2", 2048, 2048, 64, 1.2 ** 2, None),
    ]
    for label, sq, skv, d, radius, shape in cases:
        q = randn(b, 4, sq, d) / d ** 0.5
        k, v = randn(b, 4, d, skv), randn(b, 4, skv, d)
        qxyz = centres[:, :sq].contiguous()
        kxyz_t = centres.transpose(1, 2).contiguous()
        kern = lambda: masked_attention(q, k, v, qxyz, kxyz_t, radius)
        plain = lambda: masked_attention_plain(q, k, v, qxyz, kxyz_t, radius)
        err = (kern() - plain()).abs().max().item()
        if not err <= ATTN_TOL:
            fail(f"attention {label}: max_abs_err {err!r} > {ATTN_TOL}")
        library_ms = None
        if shape:  # the same function: q arrives scaled, so scale 1
            kt = k.transpose(2, 3).contiguous()
            library = lambda: sdpa(q, kt, v, scale=1.0)
            if not (library() - plain()).abs().max().item() <= ATTN_TOL:
                fail("scaled_dot_product_attention differs from the plain attention")
            ms, library_ms = time_in_turns(torch, kern, library)
        else:
            ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain)
        bnd = attention_bound(b, 4, sq, skv, d)
        record("attention", label, err, ms, plain_ms, shape == "encoder", bnd, library_ms)
        print(f"  {'':16s} {'':44s} fp32-peak bound_ms="
              f"{attention_bound(b, 4, sq, skv, d, tensor_cores=False)[0]!r}")
        if shape == "decoder":
            results["attention"].update(decoder_ms=ms, decoder_plain_ms=plain_ms,
                                        decoder_bound_ms=bnd[0], decoder_library_ms=library_ms)

    # kernel E through a ViT-B/16 layer at one scene's crops (128, the
    # CLIP-crop eval) and at a stage-1 step's (256): B x 12 x 197 x 64
    for crops in (128, 8 * N_SEL):
        q, k, v = (randn(crops, 12, 197, 64) for _ in range(3))
        kern = lambda: vit_attention(q, k, v)
        plain = lambda: vit_attention_plain(q, k, v)
        library = lambda: sdpa(q, k, v)
        err = (kern() - plain()).abs().max().item()
        if not err <= VIT_ATTN_TOL:
            fail(f"vit_attention {crops} crops: max_abs_err {err!r} > {VIT_ATTN_TOL}")
        if not (library() - plain()).abs().max().item() <= VIT_ATTN_TOL:
            fail("scaled_dot_product_attention differs from the plain ViT attention")
        ms, library_ms = time_in_turns(torch, kern, library)
        plain_ms = time_ms(torch, plain)
        bnd = attention_bound(crops, 12, 197, 197, 64)
        record("vit_attention", f"B={crops} crops H=12 S=197 D=64", err, ms, plain_ms, crops == 128,
               bnd, library_ms)
        print(f"  {'':16s} {'':44s} fp32-peak bound_ms="
              f"{attention_bound(crops, 12, 197, 197, 64, tensor_cores=False)[0]!r}")
        if crops != 128:
            results["vit_attention"].update(stage1_ms=ms, stage1_plain_ms=plain_ms,
                                            stage1_bound_ms=bnd[0], stage1_library_ms=library_ms)


def compare_attention_backward(torch):
    """Phase 3, D in training at the training shapes, with and without the
    attention-weight dropout: the output and the q, k and v gradients
    through its autograd Function (kernel forward, plain recompute backward)
    against the plain version and its autograd."""
    from coda_neurips2023_tpu_torch.ops.masked_attention import (
        MaskedAttention,
        masked_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen)

    for label, sq, skv, d, dropout in (
        ("encoder S=2048 H=4 D=64", 2048, 2048, 64, 0.0),
        ("decoder cross Sq=128 Skv=2048 H=4 D=128", 128, 2048, 128, 0.0),
        ("encoder, dropout 0.1", 2048, 2048, 64, 0.1),
        ("decoder cross, dropout 0.1", 128, 2048, 128, 0.1),
    ):
        leaves = [randn(TRAIN_BATCH, 4, sq, d) / d ** 0.5, randn(TRAIN_BATCH, 4, d, skv),
                  randn(TRAIN_BATCH, 4, skv, d)]
        grad_out = randn(TRAIN_BATCH, 4, sq, d)
        seed = torch.randint(0, 2 ** 62, (), device="cuda", generator=gen)
        kq, kk, kv = (t.clone().requires_grad_() for t in leaves)
        pq, pk, pv = (t.clone().requires_grad_() for t in leaves)
        out_k = MaskedAttention.apply(kq, kk, kv, None, None, 0.0, dropout, seed)
        out_p = masked_attention_plain(pq, pk, pv, None, None, 0.0, dropout=dropout,
                                       seed=seed)
        got = torch.autograd.grad(out_k, (kq, kk, kv), grad_out)
        want = torch.autograd.grad(out_p, (pq, pk, pv), grad_out)
        err = max((g - w).abs().max().item() for g, w in zip((out_k, *got), (out_p, *want)))
        if not err <= ATTN_TOL:
            fail(f"attention training {label}: max_abs_err {err!r} > {ATTN_TOL}")
        print(f"  {'attention':16s} {'train B=8 ' + label:44s} max_abs_err={err!r} (out, dq, dk, dv)")


def check_grid_launches(launches, name, steps, path):
    """Kernel B, F or G launched exactly its count a call, once a step: the
    grid build's two kernels and the query (GRID_LAUNCHES for B and F,
    TILE_LAUNCHES for G, whose build also orders the centres)."""
    from coda_neurips2023_tpu_torch.ops.grouping import GRID_LAUNCHES, TILE_LAUNCHES

    per_call = TILE_LAUNCHES if name == "ball_query_tile" else GRID_LAUNCHES
    if launches[name] != steps * per_call:
        fail(f"{name} launched {launches[name]} times on the {path} path, expected "
             f"{steps * per_call} ({per_call} a call: grid cells, pack, query)")
    print(f"  {name}: {per_call} launches a call (grid cells, pack, query), once a step")


def check_eval_outputs(torch, outs, nq, what, zero_rows):
    """Keys, shapes and finite values of eval-step outputs; objectness in
    [0, 1]; sem_cls_prob rows that sum to 1 within 1e-4, or, with
    `zero_rows`, are all zero (an invalid box).  Returns the rows summing to 1."""
    shapes = {
        "box_corners": (BATCH, nq, 8, 3), "sem_cls_prob": (BATCH, nq, EVAL_CLASSES),
        "objectness_prob": (BATCH, nq), "center_unnormalized": (BATCH, nq, 3),
        "size_unnormalized": (BATCH, nq, 3), "angle_continuous": (BATCH, nq),
    }
    n_valid = 0
    for out in outs:
        if set(out) != set(shapes):
            fail(f"{what} step keys {sorted(out)}")
        for key, shape in shapes.items():
            if tuple(out[key].shape) != shape:
                fail(f"{what} {key}: shape {tuple(out[key].shape)} != {shape}")
            if not torch.isfinite(out[key]).all():
                fail(f"{what} {key}: non-finite values")
        if not (0 <= out["objectness_prob"].min() and out["objectness_prob"].max() <= 1):
            fail(f"{what} objectness_prob outside [0, 1]")
        sums = out["sem_cls_prob"].sum(-1)
        ok = (sums - 1).abs().le(1e-4)
        if not (ok | sums.eq(0) if zero_rows else ok).all():
            fail(f"{what} sem_cls_prob rows do not sum to 1" + (" or 0" if zero_rows else ""))
        n_valid += int(ok.sum())
    return n_valid


def clip_eval_phase(torch, ctx, cfg, batches):
    """Phase 6: the baseline detector's CLIP-crop eval step at full width."""
    from coda_neurips2023_tpu_torch import _kernels
    from coda_neurips2023_tpu_torch.models import build_model
    from coda_neurips2023_tpu_torch.models.helpers import reset_parameters

    print(f"phase 6: CLIP-crop eval step (3detrmulticlasshead --if_with_clip), "
          f"{STEPS} batches of {BATCH} scenes with {IMAGE_HW[0]} x {IMAGE_HW[1]} images")
    args = types.SimpleNamespace(**FLAGSHIP_ARGS, **CLIP_ARGS)
    detector, _ = build_model(args, cfg, device="cuda")
    if "text_correlation_head" in detector.mlp_heads:
        fail("the baseline detector has a text head")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    detector = reset_parameters(detector, gen).eval()
    step = ctx.make_clip_eval_step(detector)
    t0 = time.perf_counter()
    step(batches[0])  # warm-up
    torch.cuda.synchronize()
    print(f"  warm-up step {(time.perf_counter() - t0) * 1e3!r} ms")
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    times, outs = [], []
    for batch in batches:
        t0 = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = dict(_kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    nq = detector.nqueries
    n_valid = check_eval_outputs(torch, outs, nq, "CLIP eval", zero_rows=True)
    if n_valid == 0:
        fail("CLIP eval: no valid box in any step")
    print(f"  launches in the {STEPS} timed steps: {launches}")
    for name in ("fps", "ball_query", "gather", "attention", "vit_attention"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the CLIP eval path")
    check_grid_launches(launches, "ball_query", STEPS, "CLIP eval")
    if launches["vit_attention"] != STEPS * BATCH * CLIP_LAYERS:
        fail(f"vit_attention launched {launches['vit_attention']} times, expected "
             f"{STEPS * BATCH * CLIP_LAYERS} (every image-tower layer of every scene)")
    if launches["crop"] != STEPS:
        fail(f"crop launched {launches['crop']} times, expected {STEPS} (one a batch)")
    med = statistics.median(times)
    print(f"  valid boxes (rows summing to 1): {n_valid} of {STEPS * BATCH * nq}")
    print(f"  CLIP eval step ms: median {med!r} min {min(times)!r} max {max(times)!r}")
    print(f"  scenes/s (median step): {BATCH / med * 1e3!r}; crops/s: {BATCH * nq / med * 1e3!r}")
    print(f"  peak memory allocated: {peak_gb!r} GB")
    return launches, detector


def clip_cpu_phase(torch, ctx, detector, batch):
    """Phase 7: the CLIP-crop part of the step for one scene, GPU vs CPU, on
    the GPU detector's last-layer boxes."""
    from coda_neurips2023_tpu_torch.engine import last_layer
    from coda_neurips2023_tpu_torch.models.distillation import clip_crop_scores, crop_rects
    from coda_neurips2023_tpu_torch.ops.projection import (
        project_upright_depth_to_image,
        unaugment_corners,
    )

    print("phase 7: the CLIP-crop scores of one scene on the CPU (plain PyTorch)")
    one = {k: v[:1] for k, v in batch.items()}
    text = ctx.text_banks["test"]
    with torch.inference_mode():
        last = last_layer(detector(one))
        rects_gpu, _ = crop_rects(last, one)
        gpu = clip_crop_scores(last, one, ctx.clip_image_fn, text, ctx.logit_scale)
        ctx.clip_model.to("cpu")
        last_cpu = {k: v.cpu() for k, v in last.items()}
        one_cpu = {k: v.cpu() for k, v in one.items()}
        rects_cpu, _ = crop_rects(last_cpu, one_cpu)
        cpu = clip_crop_scores(last_cpu, one_cpu, ctx.clip_image_fn, text.cpu(), ctx.logit_scale)
        # rows whose unclipped projected coordinates lie within 1e-3 of an
        # integer truncate by the last bits of the projection's sums
        un = unaugment_corners(last_cpu["box_corners_xyz"], one_cpu["scale_array"],
                               one_cpu["rot_array"], one_cpu["flip_array"])
        uv, _ = project_upright_depth_to_image(un.reshape(1, -1, 3), one_cpu["K"], one_cpu["Rtilt"])
        uv = uv.reshape(un.shape[1], 8, 2).double()
        bounds = torch.stack([one_cpu["ori_width"], one_cpu["ori_height"]], -1).double() - 1
        inside = (uv > 0) & (uv < bounds)
        near = (((uv - uv.round()).abs() < 1e-3) & inside).flatten(1).any(1)
    same = (rects_gpu[0].cpu() == rects_cpu[0]).all(-1)
    if not (same | near).all():
        fail(f"rects differ between GPU and CPU away from integer boundaries: "
             f"{int((~same & ~near).sum())} boxes")
    err = (gpu[0].cpu() - cpu[0])[same].abs().max().item()
    print(f"  rects equal on {int(same.sum())} of {same.numel()} boxes "
          f"({int(near.sum())} at an integer boundary); sem_cls_prob max_abs_err={err!r} "
          f"(valid rows {int((cpu[0].sum(-1) > 0).sum())})")
    if not err <= CLIP_TOL:
        fail(f"GPU vs CPU CLIP crop scores differ by {err!r} > {CLIP_TOL}")


def crop_ops(torch, dist, rects, h, w, size):
    """The separable sums' operations for `rects` (n, 4) of an h x w frame: a
    multiply and an add for each nonzero tap of the vertical sums over the
    crop's columns and of the horizontal sums over the output's."""
    xmin, ymin, xmax, ymax = rects.unbind(-1)
    len_y, len_x = ymax - ymin, xmax - xmin
    edge = torch.maximum(len_y, len_x)
    taps = dist._crop_max_taps(h, w, size)
    ky, _ = dist._bicubic_matrix(edge, ymin, ((edge - len_y) // 2).to(torch.float32), len_y, h,
                                 size, taps)
    kx, _ = dist._bicubic_matrix(edge, xmin, ((edge - len_x) // 2).to(torch.float32), len_x, w,
                                 size, taps)
    cols = (torch.clamp(xmax, max=w) - torch.clamp(xmin, min=0)).clamp(min=0) * 3
    vertical = ((ky != 0).sum((-1, -2)) * cols).sum().item()
    horizontal = (kx != 0).sum().item() * size * 3
    return 2 * (vertical + horizontal)


def crop_phase(torch, images, results):
    """Phase 22: the crop kernel against the plain path at the cells' shapes."""
    import numpy as np

    from coda_neurips2023_tpu_torch import _kernels
    from coda_neurips2023_tpu_torch.models import distillation as dist

    h, w = images.shape[1:3]
    rng = np.random.default_rng(SEED + 22)
    row = {}
    for b, n in CROP_CASES:
        print(f"phase 22: the crop kernel, {b} x {n} rects on {h} x {w} frames -> "
              f"{CROP_SIZE} x {CROP_SIZE}")
        frames = images[:b].contiguous()
        x0, y0 = rng.integers(0, w, (b, n)), rng.integers(0, h, (b, n))
        rects = np.stack([x0, y0, np.minimum(x0 + rng.integers(0, w * 3 // 4, (b, n)), w),
                          np.minimum(y0 + rng.integers(0, h * 3 // 4, (b, n)), h)], -1)
        rects[:, 0] = [0, 0, w, h]  # the whole frame
        rects[:, 1] = [5, 5, 5, 40]  # zero width: all white
        rects = torch.from_numpy(rects.astype(np.int32)).cuda()
        flat = rects.reshape(b * n, 4)
        scene = torch.arange(b, dtype=torch.int32, device="cuda").repeat_interleave(n)
        _kernels.reset_launches()
        got = dist.clip_crops(frames, rects, CROP_SIZE)
        torch.cuda.synchronize()
        if _kernels.LAUNCHES["crop"] != 1:
            fail(f"clip_crops launched the crop kernel {_kernels.LAUNCHES['crop']} times, not once")
        ints = dist._crop_kernel(frames, flat, scene, CROP_SIZE, normalize=False)
        err = flips = near = ops = 0
        for i in range(b):
            image = frames[i].to(torch.float32)
            raw = torch.clamp(dist._crop_unrounded(image, rects[i], CROP_SIZE), 0.0, 255.0)
            want = torch.round(raw)
            mine = ints[i * n:(i + 1) * n]
            boundary = (raw - torch.floor(raw) - 0.5).abs() < 1e-3
            differ = mine != want
            if (differ & ~boundary).any():
                fail(f"crop kernel, scene {i}: {int((differ & ~boundary).sum())} integers differ "
                     "from the plain path away from a rounding boundary")
            err = max(err, (mine - want).abs().max().item())
            flips += int(differ.sum())
            near += int(boundary.sum())
            if not torch.equal(got[i * n:(i + 1) * n], dist.preprocess_crops(mine)):
                fail(f"crop kernel, scene {i}: the normalised crops are not the plain "
                     "normalisation of its integers, bit for bit")
            ops += crop_ops(torch, dist, rects[i], h, w, CROP_SIZE)
        if err > 1:
            fail(f"crop kernel: an integer {err} from the plain path's")
        if not (ints.view(b, n, -1)[:, 1] == 255).all():
            fail("crop kernel: the zero-width rect is not all white")
        del ints

        def plain():
            return torch.cat([dist.preprocess_crops(dist.crop_square_resize_white_plain(
                frames[i].to(torch.float32), rects[i], CROP_SIZE)) for i in range(b)])

        ms, plain_ms = time_in_turns(
            torch, lambda: dist._crop_kernel(frames, flat, scene, CROP_SIZE, normalize=True), plain)
        nbytes = got.numel() * 4 + frames.numel() + flat.numel() * 4 + scene.numel() * 4
        bound_ms, bounded_by = bound(ops, nbytes)
        print(f"  {b * n} crops: integers equal but {flips} ({flips / got.numel():.2e}), all "
              f"within 1e-3 of a half ({near} such sums); max_abs_err {err!r}")
        print(f"  kernel {ms!r} ms, plain {plain_ms!r} ms, bound {bound_ms!r} ms ({bounded_by}: "
              f"{nbytes / 1e9:.3f} GB, {ops / 1e9:.2f} GFLOP), "
              f"{100 * bound_ms / ms:.1f}% of the bound")
        tag = "" if (b, n) == CROP_CASES[0] else "stage1_"
        row.update({f"{tag}ms": ms, f"{tag}plain_ms": plain_ms, f"{tag}bound_ms": bound_ms,
                    f"{tag}flips": flips})
        row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)
        del got
    results["crop"] = row


def train_objects(torch, cfg, dropout: bool, device, seed, flags=None):
    """The baseline detector (or, with STAGE1_ARGS as `flags`, the CoDA
    detector), its criterion and optimizer on `device`, built as a training
    run builds them; `flags` may also be a whole parsed namespace (a
    script's).  The random weights are drawn on the card from `seed`, so
    every device gets the same ones."""
    from coda_neurips2023_tpu_torch.criterion import build_criterion
    from coda_neurips2023_tpu_torch.models import build_model
    from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
    from coda_neurips2023_tpu_torch.optimizer import build_optimizer

    if isinstance(flags, types.SimpleNamespace) or hasattr(flags, "_get_kwargs"):
        args = copy.copy(flags)
    else:
        args = types.SimpleNamespace(**{**FLAGSHIP_ARGS, **TRAIN_ARGS, **(flags or {})})
    if not dropout:
        args.mlp_dropout = args.enc_dropout = args.dec_dropout = 0.0
    model, _ = build_model(args, cfg, device=DEVICE)
    reset_parameters(model, torch.Generator(device=DEVICE).manual_seed(seed))
    model.to(device)
    optimizer, schedule = build_optimizer(args, model, num_iters_per_epoch=600)
    return model, build_criterion(args, cfg), optimizer, schedule


def train_phase(torch, cfg, batches):
    """Phase 8: the baseline training step at full width, kernel F on."""
    from coda_neurips2023_tpu_torch import _kernels
    from coda_neurips2023_tpu_torch.engine import make_train_step

    print(f"phase 8: baseline training step (3detrmulticlasshead), {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {NUM_POINTS} points, CODA_BQ_FUSED_GATHER=1")
    model, criterion, optimizer, schedule = train_objects(torch, cfg, True, "cuda", SEED + 4)
    step = make_train_step(model, criterion, optimizer, lr_schedule=schedule)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    t0 = time.perf_counter()
    step(batches[0], gen)  # warm-up
    torch.cuda.synchronize()
    print(f"  warm-up step {(time.perf_counter() - t0) * 1e3!r} ms")
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    times, losses, matcher_ms = [], [], []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        metrics = step(batch, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times.append((t1 - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        matcher_ms.append(matcher_solve_ms(t0, t1))
    launches = dict(_kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  losses {losses!r}; lr {float(metrics['lr'])!r}")
    if not all(map(math.isfinite, losses)):
        fail(f"training loss not finite: {losses}")
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        fail("parameters not finite after the training steps")
    print(f"  launches in the {TRAIN_STEPS} timed steps: {launches}")
    print("  (kernel B is not on this path: F takes its place)")
    for name in ("fps", "ball_query_group", "attention", "gather"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the training path")
    check_grid_launches(launches, "ball_query_group", TRAIN_STEPS, "training")
    med = statistics.median(times)
    STEP_TIMES["phase 8"] = dict(median=med, peak_gb=peak_gb)
    print(f"  train step ms: median {med!r} min {min(times)!r} max {max(times)!r}")
    print(f"  scenes/s (median step): {TRAIN_BATCH / med * 1e3!r}")
    print(f"  matcher host ms a step: median {statistics.median(matcher_ms)!r} "
          f"(the host's time from the cost's arrival to the assignments' copy back)")
    print(f"  peak memory allocated: {peak_gb!r} GB")
    return launches


def train_cpu_phase(torch, cfg, batch):
    """Phase 9: one training step, dropout 0, from the same weights on the GPU
    and on the CPU."""
    from coda_neurips2023_tpu_torch.engine import make_train_step

    print("phase 9: the training step on 2 scenes, GPU vs CPU (plain PyTorch), dropout 0")
    small = {k: v[:2] for k, v in batch.items()}
    runs = {}
    for device in ("cuda", "cpu"):
        model, criterion, optimizer, schedule = train_objects(torch, cfg, False, device, SEED + 6)
        step = make_train_step(model, criterion, optimizer, lr_schedule=schedule)
        t0 = time.perf_counter()
        metrics = step({k: v.to(device) for k, v in small.items()})
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        asg = {k: v.cpu() for k, v in criterion.last_assignments.items()}
        runs[device] = (float(metrics["loss"]), grads, asg)
        print(f"  {device}: loss {runs[device][0]!r} in {(time.perf_counter() - t0):.2f} s")
    (gl, gg, ga), (cl, cg, ca) = runs["cuda"], runs["cpu"]
    for key in ga:
        if not torch.equal(ga[key], ca[key]):
            fail(f"matcher {key} differs between GPU and CPU")
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in cg.values())).item()
    worst = max(((gg[n] - cg[n]).abs().max().item() / norm, n) for n in cg)
    print(f"  assignments equal ({int(ga['proposal_matched_mask'].sum())} matches over all "
          f"layers); loss |diff| {abs(gl - cl)!r}; gradient max |diff| / global norm "
          f"{worst[0]!r} ({worst[1]}), norm {norm!r}")
    if not abs(gl - cl) <= STEP_TOL:
        fail(f"GPU vs CPU training loss differs by {abs(gl - cl)!r} > {STEP_TOL}")
    if not worst[0] <= GRAD_TOL:
        fail(f"GPU vs CPU gradient of {worst[1]} differs by {worst[0]!r} of the norm > {GRAD_TOL}")


@contextlib.contextmanager
def bq_env(**values):
    """CODA_BQ_* variables set for one phase (they are cleared at the start)."""
    os.environ.update(values)
    try:
        yield
    finally:
        for var in values:
            os.environ.pop(var, None)


def fused_step_keeping_targets(ctx, store, *args, **kw):
    """ctx.make_fused_train_step(*args, **kw), whose steps also leave their
    distillation targets in `store` (the step returns only its metrics)."""
    fn = ctx.extra_targets_fn()

    def keep(outputs, batch, generator):
        store.clear()
        store.update(fn(outputs, batch, generator))
        return store

    ctx.extra_targets_fn = lambda: keep
    try:
        return ctx.make_fused_train_step(*args, **kw)
    finally:
        del ctx.extra_targets_fn


def stage1_phase(torch, cfg, batches, stage_args=None, bank_cfg=None, bq="ball_query_tile",
                 title=None, steps=TRAIN_STEPS, sa_calls=1):
    """Phase 10: the stage-1 distillation training step at full width, G on;
    phase 15 runs it with ScanNet's script flags (`stage_args`, a parsed
    namespace), the text banks of `bank_cfg` and kernel `bq`; phase 19 with
    the masked encoder's flags, `steps` timed steps and `sa_calls` set
    abstractions a step."""
    from coda_neurips2023_tpu_torch import _kernels
    from coda_neurips2023_tpu_torch.stages import StageContext

    print(title or (
        f"phase 10: stage-1 training step (3detr_predictedbox_distillation), {TRAIN_STEPS} steps "
        f"of {TRAIN_BATCH} x {NUM_POINTS} points with {IMAGE_HW[0]} x {IMAGE_HW[1]} images, "
        f"{N_SEL} crops a scene, CODA_BQ_ALGO=adaptive"))
    flags = stage_args or STAGE1_ARGS
    t0 = time.perf_counter()
    ctx = StageContext(flags if stage_args else types.SimpleNamespace(**STAGE1_ARGS),
                       bank_cfg or cfg, device=DEVICE,
                       generator=torch.Generator(device=DEVICE).manual_seed(SEED + 7))
    print(f"  CLIP and the text bank {tuple(ctx.train_text_features.shape)} in "
          f"{time.perf_counter() - t0:.2f} s (once, outside the timed steps)")
    model, criterion, optimizer, schedule = train_objects(torch, cfg, True, DEVICE, SEED + 8,
                                                          flags)
    targets = {}
    step = fused_step_keeping_targets(ctx, targets, model, criterion, optimizer,
                                      lr_schedule=schedule)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    t0 = time.perf_counter()
    step(batches[0], gen)  # warm-up
    torch.cuda.synchronize()
    print(f"  warm-up step {(time.perf_counter() - t0) * 1e3!r} ms")
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    times, losses, l1, crops, matcher_ms = [], [], [], [], []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        metrics = step(batch, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times.append((t1 - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        l1.append(float(metrics["loss_predicted_region_embed_l1"]))
        crops.append(int(targets["gt_text_correlation_embedding_mask"].sum()))
        matcher_ms.append(matcher_solve_ms(t0, t1))
    launches = dict(_kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  losses {losses!r}")
    print(f"  loss_predicted_region_embed_l1 {l1!r}")
    print(f"  valid crops a step (of {TRAIN_BATCH * N_SEL}): {crops!r}")
    if not all(map(math.isfinite, losses)):
        fail(f"stage-1 loss not finite: {losses}")
    if not all(x > 0 for x in l1):
        fail(f"the distillation loss is not above 0: {l1}")
    if not all(p.isfinite().all() for p in model.parameters()):
        fail("parameters not finite after the stage-1 steps")
    print(f"  launches in the {steps} timed steps: {launches}")
    for name in ("fps", bq, "gather", "attention", "vit_attention"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the stage-1 path")
    for name in {"ball_query", "ball_query_group", "ball_query_tile"} - {bq}:
        if launches[name] != 0:
            fail(f"kernel {name} was launched on the stage-1 path in {bq}'s place")
    check_grid_launches(launches, bq, steps * sa_calls, "stage-1")
    if launches["vit_attention"] != steps * CLIP_LAYERS:
        fail(f"vit_attention launched {launches['vit_attention']} times, expected "
             f"{steps * CLIP_LAYERS} (one tower call of every step's crops)")
    if launches["crop"] != steps:
        fail(f"crop launched {launches['crop']} times, expected {steps} (one a step)")
    med = statistics.median(times)
    if title is None:
        STEP_TIMES["phase 10"] = dict(median=med, peak_gb=peak_gb)
    print(f"  stage-1 step ms: median {med!r} min {min(times)!r} max {max(times)!r}")
    print(f"  scenes/s (median step): {TRAIN_BATCH / med * 1e3!r}; crops/s: "
          f"{TRAIN_BATCH * N_SEL / med * 1e3!r}")
    print(f"  matcher host ms a step: median {statistics.median(matcher_ms)!r}")
    print(f"  peak memory allocated: {peak_gb!r} GB")
    return launches, ctx


def safe_selection(torch, last, batch, gen):
    """(B, N_SEL) boxes to crop, those whose rect coordinates all lie at least
    RECT_MARGIN px from an integer first (in random order from `gen`), and
    how many such boxes each scene has."""
    from coda_neurips2023_tpu_torch.ops.projection import (
        project_upright_depth_to_image,
        project_world_to_image_scannet,
        unaugment_corners,
    )

    un = unaugment_corners(last["box_corners_xyz"], batch["scale_array"], batch["rot_array"],
                           batch["flip_array"], batch.get("zx_flip_array"))
    b, q = un.shape[:2]
    project = (project_world_to_image_scannet if batch["K"].shape[-1] == 4
               else project_upright_depth_to_image)
    uv, _ = project(un.reshape(b, q * 8, 3), batch["K"], batch["Rtilt"])
    hi = torch.stack([batch["ori_width"], batch["ori_height"]], -1).double()[:, None, None, :] - 1
    uv = torch.minimum(uv.reshape(b, q, 8, 2).double().clamp(min=0), hi)
    ext = torch.cat([uv.amin(2), uv.amax(2)], -1)  # the rect before truncation
    hi4 = hi[:, :, 0, [0, 1, 0, 1]]
    near = ((ext - ext.round()).abs() < RECT_MARGIN) & (ext > 0) & (ext < hi4)
    risky = near.any(-1).cpu()
    key = torch.rand((b, q), generator=gen) + risky.double()
    return torch.argsort(key, dim=1)[:, :N_SEL], (~risky).sum(1).tolist()


def stage1_cpu_phase(torch, cfg, ctx, batch, stage_args=None, title=None):
    """Phase 11: the stage-1 step, dropout 0, GPU vs CPU, same weights and
    crops; phase 15 runs it with ScanNet's `stage_args`."""
    from coda_neurips2023_tpu_torch.engine import last_layer
    from coda_neurips2023_tpu_torch.models.distillation import crop_rects

    print(title or "phase 11: the stage-1 step on 2 scenes, GPU vs CPU (plain PyTorch), dropout 0")
    flags = stage_args or STAGE1_ARGS
    small = {k: v[:2] for k, v in batch.items()}
    model, criterion, optimizer, schedule = train_objects(torch, cfg, False, DEVICE, SEED + 10,
                                                          flags)
    with torch.no_grad():  # the boxes the step will crop, from a copy's training forward
        last = last_layer(copy.deepcopy(model)(small))
    sel, n_safe = safe_selection(torch, last, small, torch.Generator().manual_seed(SEED + 11))
    print(f"  boxes a scene whose rects lie {RECT_MARGIN} px from integer boundaries: {n_safe}")
    runs = {}
    for name, device, c in (("gpu", DEVICE, ctx), ("cpu", "cpu", ctx.to("cpu"))):
        if name == "cpu":
            model, criterion, optimizer, schedule = train_objects(torch, cfg, False, "cpu",
                                                                  SEED + 10, flags)
        targets = {}
        step = fused_step_keeping_targets(c, targets, model, criterion, optimizer,
                                          return_last_outputs=True, lr_schedule=schedule)
        t0 = time.perf_counter()
        on_device = {k: v.to(device) for k, v in small.items()}
        on_device["distillation_sel"] = sel.to(device)
        metrics, last = step(on_device)
        rects, _ = crop_rects(last, on_device)
        runs[name] = dict(
            loss=float(metrics["loss"]), grads={n: p.grad.detach().cpu()
                                                for n, p in model.named_parameters()},
            asg={k: v.cpu() for k, v in criterion.last_assignments.items()},
            targets={k: v.cpu() for k, v in targets.items()},
            rects=torch.gather(rects.cpu(), 1, sel[..., None].expand(-1, -1, 4)))
        print(f"  {name}: loss {runs[name]['loss']!r} in {(time.perf_counter() - t0):.2f} s")
    g, c = runs["gpu"], runs["cpu"]
    same = (g["rects"] == c["rects"]).all(-1)
    if not same.all():
        fail(f"{int((~same).sum())} selected crop rects differ between GPU and CPU")
    mask_g = g["targets"]["gt_text_correlation_embedding_mask"]
    if not torch.equal(mask_g, c["targets"]["gt_text_correlation_embedding_mask"]):
        fail("the valid-crop mask differs between GPU and CPU")
    err = (g["targets"]["gt_text_correlation_embedding"]
           - c["targets"]["gt_text_correlation_embedding"]).abs().max().item()
    print(f"  mask equal ({int(mask_g.sum())} valid crops of {sel.numel()}); targets max_abs_err={err!r}")
    if not err <= CLIP_TOL:
        fail(f"GPU vs CPU distillation targets differ by {err!r} > {CLIP_TOL}")
    for key in g["asg"]:
        if not torch.equal(g["asg"][key], c["asg"][key]):
            fail(f"matcher {key} differs between GPU and CPU")
    norm = torch.sqrt(sum((x.double() ** 2).sum() for x in c["grads"].values())).item()
    worst = max(((g["grads"][n] - c["grads"][n]).abs().max().item() / norm, n) for n in c["grads"])
    print(f"  assignments equal ({int(g['asg']['proposal_matched_mask'].sum())} matches over all "
          f"layers); loss |diff| {abs(g['loss'] - c['loss'])!r}; gradient max |diff| / global norm "
          f"{worst[0]!r} ({worst[1]}), norm {norm!r}")
    if not abs(g["loss"] - c["loss"]) <= STEP_TOL:
        fail(f"GPU vs CPU stage-1 loss differs by {abs(g['loss'] - c['loss'])!r} > {STEP_TOL}")
    if not worst[0] <= GRAD_TOL:
        fail(f"GPU vs CPU gradient of {worst[1]} differs by {worst[0]!r} of the norm > {GRAD_TOL}")


def mxu_phase(torch, model, text, batch, want):
    """Phase 12: phase 4's eval step on one batch with CODA_BQ_MXU=1."""
    from coda_neurips2023_tpu_torch import _kernels
    from coda_neurips2023_tpu_torch.engine import make_eval_step

    print("phase 12: phase 4's eval step on one batch with CODA_BQ_MXU=1 (kernel G for the "
          "MXU kernel's row)")
    step = make_eval_step(model, eval_text_features=text, eval_logit_scale=100.0)
    with bq_env(CODA_BQ_MXU="1"):
        _kernels.reset_launches()
        out = step(batch)
        torch.cuda.synchronize()
        launches = dict(_kernels.LAUNCHES)
    print(f"  launches: {launches}")
    if launches["ball_query_tile"] <= 0 or launches["ball_query"] != 0:
        fail("CODA_BQ_MXU=1: kernel G did not take kernel B's place")
    check_grid_launches(launches, "ball_query_tile", 1, "MXU eval")
    err = max((out[k] - want[k]).abs().max().item() for k in want)
    print(f"  outputs vs phase 4's on that batch: max_abs_err={err!r}")
    if not err <= MXU_TOL:
        fail(f"CODA_BQ_MXU=1 changed the eval outputs by {err!r} > {MXU_TOL}")


def expected_metric_keys(ncls):
    """The keys compute_metrics gives a threshold when the AP dict has
    classes 0 .. ncls-1 (the JAX package's utils/ap_calculator.py:396-485;
    the buckets where ncls > 2)."""
    names = [str(c) for c in range(ncls)]
    keys = {f"{c} Average Precision" for c in names} | {f"{c} Prec" for c in names}
    keys |= {f"{c} Recall" for c in names} | {"mAP", "Prec", "AR"}
    if ncls > 2:
        for stem in ("mAP", "Prec", "AR"):
            keys |= {f"{stem}_{b}" for b in ("fre", "common", "base", "novel")}
    return keys


@contextlib.contextmanager
def recording_eval_step(engine, store):
    """engine.make_eval_step wrapped so that the text bank it is given, its
    step's first batch and outputs, and every batch it steps land in
    `store`."""
    make = engine.make_eval_step

    def wrapped(model, eval_text_features=None, **kw):
        store["bank"] = eval_text_features
        step = make(model, eval_text_features=eval_text_features, **kw)

        def recorded(batch):
            out = step(batch)
            if "first" not in store:
                store["first"] = (dict(batch), {k: v.clone() for k, v in out.items()})
            store.setdefault("batches", []).append(dict(batch))
            return out

        return recorded

    engine.make_eval_step = wrapped
    try:
        yield store
    finally:
        engine.make_eval_step = make


@contextlib.contextmanager
def recording_meter(store):
    """APCalculator.step_meter wrapped so that each batch the eval loop
    meters (the rows it kept: their outputs and ground truth) lands in the
    list `store`: the EVAL_KEYS outputs as arrays, the ground truth as a
    digest."""
    import numpy as np

    from coda_neurips2023_tpu_torch import engine
    from coda_neurips2023_tpu_torch.utils.ap_calculator import APCalculator

    step_meter = APCalculator.step_meter

    def wrapped(self, outputs, targets):
        host = outputs.get("outputs", outputs)
        store.append(({k: np.array(host[k]) for k in engine.EVAL_KEYS}, batch_digest(targets)))
        return step_meter(self, outputs, targets)

    APCalculator.step_meter = wrapped
    try:
        yield store
    finally:
        APCalculator.step_meter = step_meter


def cli_run(torch, argv, workers):
    """One `main(argv)` on the card with CODA_AP_WORKERS=workers: (metrics,
    launches, EVAL_STATS, ap METER, seconds)."""
    from coda_neurips2023_tpu_torch import _kernels, engine
    from coda_neurips2023_tpu_torch.main import main as cli_main
    from coda_neurips2023_tpu_torch.utils import ap_calculator

    ap_calculator.close_pool()
    os.environ["CODA_AP_WORKERS"] = str(workers)
    ap_calculator.reset_meter()
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    metrics = cli_main(argv)
    seconds = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    ap_calculator.close_pool()
    return metrics, launches, dict(engine.EVAL_STATS), dict(ap_calculator.METER), seconds


def check_cli_metrics(metrics, scans, stats, meter, what, ncls_expected=EVAL_CLASSES):
    if stats["scans"] != scans or meter["scans"] != scans:
        fail(f"{what}: metered {stats['scans']} scans (parsed {meter['scans']}), expected {scans}")
    if meter["native_nms_scans"] != scans:
        fail(f"{what}: NMS ran in the host library for {meter['native_nms_scans']} of {scans} scans")
    if set(metrics) != {0.25, 0.5}:
        fail(f"{what}: metric thresholds {sorted(metrics)}")
    for thresh, ret in metrics.items():
        ncls = sum(1 for k in ret if k.endswith(" Average Precision"))
        if ncls not in (1, ncls_expected) or set(ret) != expected_metric_keys(ncls):
            fail(f"{what}: IoU {thresh} keys differ from the JAX package's: {sorted(ret)[:12]}")
        bad = [k for k, v in ret.items() if not math.isfinite(float(v))]
        if bad:
            fail(f"{what}: non-finite metrics {bad[:5]}")
    print(f"  {what}: {scans} scans; mAP@0.25 {float(metrics[0.25]['mAP'])!r}, "
          f"mAP@0.5 {float(metrics[0.5]['mAP'])!r}, AR@0.25 {float(metrics[0.25]['AR'])!r}; "
          f"{ncls} classes in the AP dict; NMS in the host library for every scan")


def report_loop(stats, meter, seconds, workers):
    """Print the eval loop's numbers of one CLI run."""
    n = stats["batches"]
    device_ms = stats["device_ms"]
    busy_ms = sum(device_ms)
    wall_ms = stats["wall_s"] * 1e3
    curve_ms = meter["ap_curve_s"] * 1e3
    scans = stats["scans"]
    print(f"  CODA_AP_WORKERS={workers}: main() {seconds!r} s; loop (loader to last meter) "
          f"{wall_ms!r} ms for {n} batches; AP curves {curve_ms!r} ms")
    print(f"    scenes/s loader to metrics: {scans / (wall_ms + curve_ms) * 1e3!r}; "
          f"device ms a batch {[round(x, 3) for x in device_ms]} (median {statistics.median(device_ms)!r})")
    print(f"    waiting for the loader ms a batch: {[round(x * 1e3, 3) for x in stats['load_s']]}")
    print(f"    host meter ms a batch: {[round(x * 1e3, 3) for x in stats['meter_s']]}; "
          f"blocked on the outputs' copy {[round(x * 1e3, 3) for x in stats['wait_s']]}")
    print(f"    of it, a batch: parse_predictions {meter['parse_s'] * 1e3 / n!r} ms wall, in-hull "
          f"{meter['in_hull_s'] * 1e3 / n!r} ms and NMS {meter['nms_s'] * 1e3 / n!r} ms "
          f"(summed over the processes that ran them)")
    print(f"    device idle share over the loop: {1 - busy_ms / wall_ms!r} "
          f"(busy {busy_ms!r} of {wall_ms!r} ms)")


def cli_phase(torch, model, launches4):
    """Phase 13: the eval entry point end to end on the card.  Returns the
    launches, and of the first run a dict of its metrics, its metered
    batches (recording_meter), the batches its step took and its text bank
    (recording_eval_step)."""
    from coda_neurips2023_tpu_torch import _kernels, engine
    from coda_neurips2023_tpu_torch.engine import make_eval_step

    scans = CLI_SCENES // 4
    print(f"phase 13: main --test_only --test_ckpt on {scans} synthetic scenes "
          f"(batches of {BATCH}, the last padded), the flagship at full width")
    out_dir = _kernels.BUILD_DIR.parent / "phase13"
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt = out_dir / "model.pth"
    torch.save({"model": model.state_dict()}, ckpt)
    argv = CLI_ARGS + ["--synthetic_num_scenes", str(CLI_SCENES), "--test_ckpt", str(ckpt),
                       "--log_file", str(out_dir / "eval.lst")]
    steps = -(-scans // BATCH)
    cli_launches, first = {}, None
    for workers in CLI_WORKERS:
        with recording_eval_step(engine, {}) as store, recording_meter([]) as metered:
            metrics, launches, stats, meter, seconds = cli_run(torch, argv, workers)
        check_cli_metrics(metrics, scans, stats, meter, f"CODA_AP_WORKERS={workers}")
        if first is None:
            first = dict(metrics=metrics, metered=metered, batches=store["batches"],
                         bank=store["bank"])
        print(f"    launches: {launches}")
        for name in ("fps", "ball_query", "gather", "attention"):
            if launches[name] != launches4[name] // STEPS * steps:
                fail(f"{name} launched {launches[name]} times in {steps} CLI steps, phase 4 "
                     f"{launches4[name]} in {STEPS}")
        others = {k: v for k, v in launches.items()
                  if k not in ("fps", "ball_query", "gather", "attention") and v}
        if others:
            fail(f"kernels off the detector eval path launched: {others}")
        cli_launches.update(launches)
        batch, got = store["first"]
        want = make_eval_step(model, eval_text_features=store["bank"], eval_logit_scale=100.0)(batch)
        err = max((got[k] - want[k]).abs().max().item() for k in want)
        print(f"    first batch vs phase 4's eval step (its model, the CLI's bank): "
              f"max_abs_err={err!r}")
        if not err <= MXU_TOL:
            fail(f"the CLI's first batch differs from phase 4's eval step by {err!r} > {MXU_TOL}")
        report_loop(stats, meter, seconds, workers)

    # one batch: CLIP_SCENES scenes padded to BATCH rows (E runs on every row)
    clip_argv = list(CLI_ARGS) + ["--synthetic_num_scenes", str(4 * CLIP_SCENES),
                                         "--if_with_clip", "--if_input_image",
                                         "--log_file", str(out_dir / "eval_clip.lst")]
    clip_argv[clip_argv.index("3detr_predictedbox_distillation")] = "3detrmulticlasshead"
    metrics, launches, stats, meter, seconds = cli_run(torch, clip_argv, CLI_WORKERS[0])
    print("  3detrmulticlasshead --if_with_clip, one batch:")
    check_cli_metrics(metrics, CLIP_SCENES, stats, meter, "CLIP-crop eval")
    print(f"    launches: {launches}")
    for name in ("fps", "ball_query", "gather", "attention", "vit_attention"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the CLIP-crop CLI path")
    if launches["vit_attention"] != BATCH * CLIP_LAYERS:
        fail(f"vit_attention launched {launches['vit_attention']} times, expected "
             f"{BATCH * CLIP_LAYERS}")
    cli_launches["vit_attention"] = launches["vit_attention"]
    report_loop(stats, meter, seconds, CLI_WORKERS[0])
    os.environ.pop("CODA_AP_WORKERS", None)
    return cli_launches, first


# phase 14: the training entry point (scripts/coda_sunrgbd_stage{1,2}.sh) on
# the synthetic split of TRAIN_CLI_SCENES scenes: 4 steps an epoch at B=8
TRAIN_CLI_SCENES = 32
# what the data, the time limit and one card force on the scripts' flags
SCRIPT_DROPS = ("--dataset_root_dir", "--calib_dir", "--image_dir", "--clip_model_path")
STAGE1_CUTS = {"--ngpus": "1", "--max_epoch": "1"}
STAGE2_CUTS = {"--ngpus": "1", "--max_epoch": "3", "--reset_epoch_periodically": "2",
               "--online_nms_update_save_epoch": "2", "--real_eval_every_epoch": "2",
               "--save_separate_checkpoint_every_epoch": "1"}
# the artifacts of the JAX package's do_train for the stage-2 call, its
# checkpoint directories as the port's .pth files
STAGE2_ARTIFACTS = {
    "checkpoint.pth", "checkpoint_0000.pth", "checkpoint_0001.pth", "checkpoint_0002.pth",
    "checkpoint_best.pth", "last_checkpoint.pth", "eval_0002.lst", "final_eval.txt",
    "final_eval.pkl", "metrics.jsonl", "synthetic_pseudo_labels_setting0",
}
TRAIN_CLI_KERNELS = ("fps", "ball_query", "gather", "attention", "vit_attention")
DISCOVERY_SCENES = 2  # phase 14's discovery batch on the CPU
NOVEL_ROW = 20  # a superset class that is not seen, for the pinned tower


def script_argv(root, name, cuts, drops=SCRIPT_DROPS):
    """The flags of scripts/<name> after `-m coda_neurips2023_tpu.main`, without
    `drops` (flag and value), with each flag of `cuts` set to its value."""
    import shlex

    text = open(os.path.join(root, "scripts", name)).read().replace("\\\n", " ")
    line = next(l for l in text.splitlines() if "coda_neurips2023_tpu.main" in l)
    tokens = shlex.split(line)
    tokens = tokens[tokens.index("coda_neurips2023_tpu.main") + 1:]
    out, i = [], 0
    while i < len(tokens):
        tok = tokens[i]
        has_value = i + 1 < len(tokens) and not tokens[i + 1].startswith("--")
        if tok in drops:
            i += 2 if has_value else 1
            continue
        out.append(tok)
        if has_value:
            out.append(cuts.get(tok, tokens[i + 1]))
            i += 2
        else:
            i += 1
    for flag, value in cuts.items():
        if flag not in out:
            out += [flag, value]
    return out


class TrainCliProbe:
    """Instrumentation of one training CLI call: for every step the CUDA
    events around it, its loss tensor, learning rate, epochs, launches and
    the ground truth it saw; for every discovery batch its events, the
    tower's and the NMS loop's events, its gate counts; every checkpoint's
    bytes and save ms; every eval's loop ms; each epoch loop's wall time and
    its wait for its first batch."""

    def __init__(self, torch, pseudo_dir=None):
        self.torch = torch
        self.pseudo_dir = pseudo_dir
        self.steps, self.discoveries, self.saves, self.evals, self.rounds = [], [], [], [], []
        self.loop_s, self.first_batch_s, self.first_count = [], [], None
        self.ctx = self.captured = None
        self._in_discovery = None

    def event(self):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    @contextlib.contextmanager
    def installed(self):
        from coda_neurips2023_tpu_torch import _kernels, engine, stages
        from coda_neurips2023_tpu_torch.models import discovery
        from coda_neurips2023_tpu_torch.utils import io

        probe, torch = self, self.torch
        saved = (engine.train_one_epoch, engine.evaluate, io.save_checkpoint,
                 stages.StageContext.run_discovery_and_write, stages.StageContext.clip_image_fn,
                 discovery.nms_2d_greedy_mask)
        train_one_epoch, evaluate, save, run_discovery, clip_image_fn, nms = saved

        def one_epoch(train_step, batches, **kw):
            def step(batch, generator):
                if len(probe.first_batch_s) < len(probe.loop_s) + 1:
                    probe.first_batch_s.append(time.perf_counter() - t0)
                before = dict(_kernels.LAUNCHES)
                if probe.first_count is None:
                    probe.first_count = kw["optimizer"].count
                start = probe.event()
                out = train_step(batch, generator)
                end = probe.event()
                metrics = out[0] if isinstance(out, tuple) else out
                probe.steps.append(dict(
                    events=(start, end), loss=metrics["loss"], lr=batch["lr"],
                    curr=kw["curr_epoch"], epoch=kw["all_epoch"],
                    launches={k: v - before[k] for k, v in _kernels.LAUNCHES.items()},
                    present=batch["gt_box_present"].sum(1),
                    ori=[int(x) for x in batch.get("gt_ori_box_num", [])]))
                return out

            t0 = time.perf_counter()
            metrics = train_one_epoch(step, batches, **kw)
            torch.cuda.synchronize()
            probe.loop_s.append(time.perf_counter() - t0)
            if probe.pseudo_dir is not None and os.path.isdir(probe.pseudo_dir):
                probe.rounds.append(sum(
                    int(__import__("numpy").load(os.path.join(probe.pseudo_dir, n)).shape[0])
                    for n in os.listdir(probe.pseudo_dir)))
            return metrics

        def run_and_write(ctx, disc, last, batch):
            if probe.captured is None:
                probe.ctx = ctx
                probe.captured = ({k: v.clone() for k, v in last.items()},
                                  {k: v.clone() if isinstance(v, torch.Tensor) else v
                                   for k, v in batch.items()})
            before = dict(_kernels.LAUNCHES)
            probe._in_discovery = {"tower": [], "nms": []}
            start = probe.event()
            n = run_discovery(ctx, disc, last, batch)
            end = probe.event()
            probe.discoveries.append(dict(
                events=(start, end), parts=probe._in_discovery, found=dict(ctx.last_discovery),
                launches={k: v - before[k] for k, v in _kernels.LAUNCHES.items()}))
            probe._in_discovery = None
            return n

        def tower(ctx, images):
            if probe._in_discovery is None:
                return clip_image_fn(ctx, images)
            start = probe.event()
            out = clip_image_fn(ctx, images)
            probe._in_discovery["tower"].append((start, probe.event()))
            return out

        def nms_loop(*a, **kw):
            start = probe.event()
            out = nms(*a, **kw)
            if probe._in_discovery is not None:
                probe._in_discovery["nms"].append((start, probe.event()))
            return out

        def save_checkpoint(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = save(*a, **kw)
            probe.saves.append((os.path.getsize(path), (time.perf_counter() - t0) * 1e3))
            return path

        def eval_loop(*a, **kw):
            ap = evaluate(*a, **kw)
            probe.evals.append(engine.EVAL_STATS["wall_s"] * 1e3)
            return ap

        engine.train_one_epoch, engine.evaluate, io.save_checkpoint = (
            one_epoch, eval_loop, save_checkpoint)
        stages.StageContext.run_discovery_and_write = run_and_write
        stages.StageContext.clip_image_fn = tower
        discovery.nms_2d_greedy_mask = nms_loop
        try:
            yield self
        finally:
            (engine.train_one_epoch, engine.evaluate, io.save_checkpoint,
             stages.StageContext.run_discovery_and_write, stages.StageContext.clip_image_fn,
             discovery.nms_2d_greedy_mask) = saved

    def report(self, what, smi):
        torch = self.torch
        torch.cuda.synchronize()
        ms = [s["events"][0].elapsed_time(s["events"][1]) for s in self.steps]
        losses = [float(s["loss"]) for s in self.steps]
        if not all(map(math.isfinite, losses)):
            fail(f"{what}: a training loss is not finite: {losses}")
        disc = [d["events"][0].elapsed_time(d["events"][1]) for d in self.discoveries]
        busy = sum(ms) + sum(disc)
        wall = sum(self.loop_s) * 1e3
        print(f"  {what} [{smi}]: {len(ms)} steps; step ms median {statistics.median(ms)!r} "
              f"min {min(ms)!r} max {max(ms)!r}; scenes/s (median step) "
              f"{TRAIN_BATCH / statistics.median(ms) * 1e3!r}; losses {[round(x, 4) for x in losses]}")
        if disc:
            tower = [sum(a.elapsed_time(b) for a, b in d["parts"]["tower"]) for d in self.discoveries]
            nms = [sum(a.elapsed_time(b) for a, b in d["parts"]["nms"]) for d in self.discoveries]
            print(f"    discovery ms a batch {[round(x, 3) for x in disc]} (median "
                  f"{statistics.median(disc)!r}); the tower's part {[round(x, 3) for x in tower]}; "
                  f"the NMS loop's device ms {[round(x, 3) for x in nms]}")
        print(f"    epoch loop wall {wall!r} ms over {len(self.loop_s)} epochs, device spans "
              f"{busy!r} ms: idle share {1 - busy / wall!r}; of the wall, waiting for each "
              f"epoch's first batch (the loader's worker pool starting) "
              f"{[round(x * 1e3, 3) for x in self.first_batch_s]} ms")
        print(f"    checkpoints (bytes, save ms): {self.saves}")
        print(f"    eval loop ms: {[round(x, 3) for x in self.evals]}")
        return ms


def check_train_launches(probe, what, discovery_batches):
    """A, B, C, D and E launch on every step of the CLI's path, B its grid's
    GRID_LAUNCHES, E once a layer; a discovery batch launches E once a layer
    more."""
    for i, s in enumerate(probe.steps):
        for name in TRAIN_CLI_KERNELS:
            if s["launches"][name] <= 0:
                fail(f"{what} step {i}: kernel {name} was not launched ({s['launches']})")
        if s["launches"]["vit_attention"] != CLIP_LAYERS:
            fail(f"{what} step {i}: vit_attention launched {s['launches']['vit_attention']} "
                 f"times, expected {CLIP_LAYERS}")
    for d in probe.discoveries:
        if d["launches"]["vit_attention"] != CLIP_LAYERS:
            fail(f"{what}: a discovery batch launched vit_attention "
                 f"{d['launches']['vit_attention']} times, expected {CLIP_LAYERS}")
    if len(probe.discoveries) != discovery_batches:
        fail(f"{what}: {len(probe.discoveries)} discovery batches, expected {discovery_batches}")
    print(f"    launches a step: {probe.steps[0]['launches']}; a discovery batch: "
          f"{probe.discoveries[0]['launches'] if probe.discoveries else None}")


def check_lr(probe, argv, what, parse):
    from coda_neurips2023_tpu_torch.optimizer import make_lr_schedule

    args = parse(argv)
    ipe = TRAIN_CLI_SCENES // TRAIN_BATCH
    host = make_lr_schedule(args, ipe, host=True)
    it = 0
    for i, s in enumerate(probe.steps):
        it = it + 1 if i and probe.steps[i - 1]["epoch"] == s["epoch"] else 0
        want = host(s["curr"] * ipe + it)
        if s["lr"] != want:
            fail(f"{what} step {i}: lr {s['lr']!r} != the schedule's {want!r} at reset epoch "
                 f"{s['curr']}, iteration {it}")
    print(f"    lr of every step equals the host schedule replayed on the reset epoch "
          f"({[s['curr'] for s in probe.steps][::ipe]} by epoch)")


def discovery_cpu_check(torch, probe):
    """The captured discovery batch (DISCOVERY_SCENES scenes) on the GPU and on
    the CPU, with the random tower and with one pinned to a superset row that
    is not seen: masks equal on the boxes whose rects lie RECT_MARGIN px from
    integers and whose CLIP top-two probabilities (and top one and the keep
    threshold) differ by more than 1e-4; rows within CLIP_TOL there."""
    from coda_neurips2023_tpu_torch.models.distillation import clip_crop_scores, crop_rects
    from coda_neurips2023_tpu_torch.ops.projection import (
        project_upright_depth_to_image,
        unaugment_corners,
    )

    ctx = probe.ctx
    last, batch = probe.captured
    last = {k: v[:DISCOVERY_SCENES] for k, v in last.items()}
    batch = {k: v[:DISCOVERY_SCENES] for k, v in batch.items() if isinstance(v, torch.Tensor)}
    args = ctx.args
    bank = ctx.text_banks["superset"] if args.if_clip_superset else ctx.text_banks["test"]
    # which boxes rounding may decide: rects near integers, CLIP near a tie
    un = unaugment_corners(last["box_corners_xyz"], batch["scale_array"], batch["rot_array"],
                           batch["flip_array"], batch.get("zx_flip_array"))
    b, q = un.shape[:2]
    uv, _ = project_upright_depth_to_image(un.reshape(b, q * 8, 3).double(), batch["K"].double(),
                                           batch["Rtilt"].double())
    hi = torch.stack([batch["ori_width"], batch["ori_height"]], -1).double()[:, None, None, :] - 1
    uv = torch.minimum(uv.reshape(b, q, 8, 2).clamp(min=0), hi)
    ext = torch.cat([uv.amin(2), uv.amax(2)], -1)
    rect_risky = (((ext - ext.round()).abs() < RECT_MARGIN) & (ext > 0)
                  & (ext < hi[:, :, 0, [0, 1, 0, 1]])).any(-1)
    with torch.no_grad():
        probs = clip_crop_scores(last, batch, ctx.clip_image_fn, bank, ctx.logit_scale,
                                 ctx.crop_size)
    # the keep gate is decided by rounding only where the top probability
    # lies at the threshold, or above it with a near tie for the class
    top2 = probs.topk(2, dim=-1).values
    thres = args.clip_driven_keep_thres
    clip_risky = (((top2[..., 0] - thres).abs() <= 1e-4)
                  | ((top2[..., 0] > thres) & ((top2[..., 0] - top2[..., 1]) <= 1e-4)))
    safe = (~rect_risky & ~clip_risky).cpu()
    cpu_ctx = ctx.to("cpu")
    key = "superset" if args.if_clip_superset else "test"
    # the pinned variant: a seeded bank of random unit rows (near orthogonal
    # in 512-d) and a tower that returns its row NOVEL_ROW for every crop, so
    # CLIP's gate passes every box the gates before it keep
    gen = torch.Generator().manual_seed(SEED + 14)
    bank = torch.randn(tuple(ctx.text_banks[key].shape), generator=gen)
    bank = bank / torch.linalg.vector_norm(bank, dim=-1, keepdim=True)
    for name, pin in (("random tower", False), ("tower pinned to a novel class", True)):
        outs = {}
        for device, c in (("gpu", ctx), ("cpu", cpu_ctx)):
            saved_bank = c.text_banks[key]
            if pin:
                c.text_banks[key] = bank.to(c.device)
                c.clip_image_fn = lambda images, _r=c.text_banks[key][NOVEL_ROW]: _r.expand(
                    images.shape[0], -1)
            try:
                t0 = time.perf_counter()
                out = c.discovery_fn()({k: v.to(c.device) for k, v in last.items()},
                                       {k: v.to(c.device) for k, v in batch.items()})
                outs[device] = {k: v.cpu() for k, v in out.items()}
            finally:
                c.__dict__.pop("clip_image_fn", None)
                c.text_banks[key] = saved_bank
            print(f"    {name}, {device}: gates "
                  f"{dict(zip(('valid', 'nms', 'not_seen_gt', 'objectness', 'clip'), outs[device]['gates'][:5].tolist()))} "
                  f"in {time.perf_counter() - t0:.2f} s")
        g, c = outs["gpu"], outs["cpu"]
        differ = g["novel_mask"] != c["novel_mask"]
        if (differ & safe).any():
            fail(f"discovery ({name}): novel_mask differs between GPU and CPU on "
                 f"{int((differ & safe).sum())} boxes away from rounding boundaries")
        keep = (~differ)[..., None]
        err = ((g["save_box_info"] - c["save_box_info"]).abs() * keep).max().item()
        print(f"    {name}: novel boxes gpu {int(g['novel_mask'].sum())} cpu "
              f"{int(c['novel_mask'].sum())}, masks differ on {int(differ.sum())} boxes "
              f"({int((~safe).sum())} of {safe.numel()} near a rounding boundary); rows "
              f"max_abs_err={err!r}")
        if not err <= CLIP_TOL:
            fail(f"discovery ({name}): rows differ between GPU and CPU by {err!r} > {CLIP_TOL}")
        if pin and int(g["novel_mask"].sum()) == 0:
            fail("discovery with the pinned tower found no box: the gates before CLIP emptied it")


def train_cli_phase(torch, root, smi):
    """Phase 14: the training entry point end to end on the card."""
    from coda_neurips2023_tpu_torch import _kernels
    from coda_neurips2023_tpu_torch.main import main as cli_main
    from coda_neurips2023_tpu_torch.main import make_args_parser

    def parse(argv):
        return make_args_parser().parse_args(argv)

    out_dir = _kernels.BUILD_DIR.parent / "phase14"
    if out_dir.exists():
        import shutil

        shutil.rmtree(out_dir)
    stage1_dir, stage2_dir = out_dir / "stage1", out_dir / "stage2"
    data = ["--synthetic_num_scenes", str(TRAIN_CLI_SCENES)]
    stage1 = script_argv(root, "coda_sunrgbd_stage1.sh", STAGE1_CUTS) + data + [
        "--checkpoint_dir", str(stage1_dir)]
    stage2 = script_argv(root, "coda_sunrgbd_stage2.sh", dict(
        STAGE2_CUTS, **{"--checkpoint_dir": str(stage2_dir),
                        "--checkpoint_file": str(stage1_dir / "last_checkpoint")})) + data
    resume = script_argv(root, "coda_sunrgbd_stage2.sh", dict(
        STAGE2_CUTS, **{"--max_epoch": "4", "--checkpoint_dir": str(stage2_dir),
                        "--checkpoint_file": str(stage1_dir / "last_checkpoint")}),
        drops=SCRIPT_DROPS + ("--set_epoch",)) + data
    print(f"phase 14: the training entry point (scripts/coda_sunrgbd_stage1.sh, then "
          f"coda_sunrgbd_stage2.sh from stage 1's last_checkpoint, then its resume) on "
          f"{TRAIN_CLI_SCENES} synthetic scenes at B={TRAIN_BATCH}, the flagship at full width")
    print(f"  stage 1: {' '.join(stage1)}")
    print(f"  stage 2: {' '.join(stage2)}")
    total = {k: 0 for k in _kernels.LAUNCHES}
    pseudo = stage2_dir / "synthetic_pseudo_labels_setting0"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    for what, argv, probe in (("stage 1", stage1, TrainCliProbe(torch)),
                              ("stage 2", stage2, TrainCliProbe(torch, str(pseudo))),
                              ("resume", resume, TrainCliProbe(torch, str(pseudo)))):
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        with probe.installed():
            cli_main(argv)
        seconds = time.perf_counter() - t0
        for k, v in _kernels.LAUNCHES.items():
            total[k] += v
        print(f"  {what}: main() {seconds!r} s")
        probe.report(what, smi)
        n_disc = {"stage 1": 0, "stage 2": 2 * TRAIN_CLI_SCENES // TRAIN_BATCH, "resume": 0}[what]
        check_train_launches(probe, what, n_disc)
        check_lr(probe, argv, what, parse)
        if what == "stage 1":
            if not (stage1_dir / "last_checkpoint.pth").is_file():
                fail("stage 1 wrote no last_checkpoint.pth")
        elif what == "stage 2":
            stage2_probe = probe
            names = set(os.listdir(stage2_dir))
            extra = {n for n in names - STAGE2_ARTIFACTS
                     if not (n.startswith("events.out") or n == "final_eval.xlsx")}
            if not STAGE2_ARTIFACTS <= names or extra:
                fail(f"stage 2 artifacts {sorted(names)} differ from the JAX do_train's "
                     f"{sorted(STAGE2_ARTIFACTS)}")
            print(f"    artifacts: {sorted(names)}")
            for i, d in enumerate(probe.discoveries):
                print(f"    discovery batch {i}: survivors {d['found']['gates']}, novel rows "
                      f"{d['found']['rows']}, written {d['found']['written']}")
            if sum(d["found"]["gates"]["valid"] for d in probe.discoveries) <= 0:
                fail("discovery found no valid box in any batch")
            print(f"    pseudo-label rows on disk after each epoch: {probe.rounds}")
            first_round = probe.rounds[0] if probe.rounds else 0
            if first_round > 0:
                if not probe.rounds[2] > probe.rounds[0]:
                    fail(f"the pseudo-label files did not grow from round 1 to round 2: {probe.rounds}")
                epoch1 = [(p, o) for s in probe.steps if s["epoch"] == 1
                          for p, o in zip(s["present"].tolist(), s["ori"])]
                if not any(p > o for p, o in epoch1):
                    fail("no scene of epoch 1 trained on merged pseudo labels")
                print(f"    epoch 1 scenes with merged rows: {sum(p > o for p, o in epoch1)}")
            else:
                tops = [d["found"]["gates"]["clip_top_prob"] for d in probe.discoveries]
                print(f"    no row reached the writer: CLIP's gate emptied every batch "
                      f"(top class probability at most {max(tops)!r} against the keep "
                      f"threshold {parse(argv).clip_driven_keep_thres}; random weights give "
                      f"near-uniform probabilities over the bank's classes)")
            discovery_cpu_check(torch, probe)
        else:
            first = probe.steps[0]
            if first["epoch"] != 3:
                fail(f"the resumed run started at epoch {first['epoch']}, not 3")
            want_count = 3 * TRAIN_CLI_SCENES // TRAIN_BATCH
            if probe.first_count != want_count:
                fail(f"the resumed run's optimizer count starts at {probe.first_count}, "
                     f"not {want_count}")
            print(f"    resumed at epoch {first['epoch']} with the optimizer's count "
                  f"{probe.first_count}; first lr {first['lr']!r}")
    from coda_neurips2023_tpu_torch.utils import ap_calculator

    ap_calculator.close_pool()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  phase 14: {time.perf_counter() - t_phase:.1f} s; peak memory allocated {peak_gb!r} GB "
          f"[{smi}]")
    return total


# phase 15: ScanNet on the card.  The fixture: scans in ScanNet's on-disk
# layout (datasets/scannet.py), written from a seed under build/phase15/
SCANNET_TRAIN_SCANS = 16
SCANNET_VAL_SCANS = 64  # the eval split: 2 batches of 32
SCANNET_SCAN_POINTS = 50000  # points a scan on disk, as ScanNet's frames
SCANNET_ROOM = (7.0, 7.0, 3.0)  # metres
SCANNET_IMAGE_HW = (968, 1296)  # ScanNet's colour frame, the scripts' --image_size_*
SCANNET_CLASSES = 60
SCANNET_EVAL_POINTS = (None, 40000)  # the CLI's default (20000), then the dataset class's own
SCANNET_FPS_BATCHES = (32, 48)  # test_release_models.sh's and coda_baseline_scannet.sh's test batch
SCANNET_CLI_WORKERS = 8
# the scannet_stage1 row of test_release_models.sh on the fixture
SCANNET_CLI_ARGS = [
    "--test_only", "--dataset_name", "scannet_anonymous_aligned_image",
    "--model_name", "3detr_predictedbox_distillation", "--calib_dir", "", "--image_dir", "",
    "--test_num_semcls", "60", "--enc_dim", "256", "--dec_dim", "512", "--nqueries", "128",
    "--num_semcls", "2", "--batchsize_per_gpu_test", "32", "--if_use_v1",
    "--test_range_max", "60", "--seed", str(SEED),
]
# the angle heads' last layers: one bin on ScanNet, 12 on SUN RGB-D
ANGLE_HEAD_OUT = ("mlp_heads.angle_cls_head.layers.8", "mlp_heads.angle_residual_head.layers.8")
# phase 16: the modes through main on the synthetic split of MODE_SCENES // 4
# scenes (one batch of 32), with phase 4's weights
MODE_SCENES = 4 * BATCH
MODE_CPU_SCENES = 2  # the first batch's scenes the CPU runs each mode on
MODE_TOL = 1e-3  # GPU vs CPU: the files' numbers, as MODEL_TOL
MODES = (
    ("show_only", [], "show"),
    ("show_box_points", [], "box_points"),
    ("save_novel_with_class_only",
     ["--online_nms_update_save_novel_label_clip_driven_with_cate_confidence",
      "--if_input_image"], None),
    ("save_seen_feat_only", ["--if_input_image"], "seen_feats"),
    ("cal_class_only", [], None),
)


def script_lists(root, name):
    """A script's flags (script_argv, the data paths dropped) with its
    $TEST_RANGE_LIST expanded from the line that sets it."""
    import shlex

    text = open(os.path.join(root, "scripts", name)).read()
    line = next(l for l in text.splitlines() if l.startswith("TEST_RANGE_LIST="))
    values = shlex.split(line.split("=", 1)[1])[0].split()
    out = []
    for tok in script_argv(root, name, {"--ngpus": "1"}):
        out += values if tok == "$TEST_RANGE_LIST" else [tok]
    return out


def write_scannet_fixture(root, args, seed):
    """ScanNet's layout under `root`: scannet_frames_train (the scripts'
    --dataset_root_dir) and the derived scannet_frames_val, each scan a
    {scene}_{seq}_pc.npy of SCANNET_SCAN_POINTS x 6 (xyz on the floor, the
    walls and the boxes' faces of a SCANNET_ROOM room, rgb), _bbox.npy
    (centre, half extents, angle 0, a raw ScanNet-200 id from the script's
    lists or one in neither), {scene}/pose/{seq}.txt (a 4 x 4
    camera-to-world pose looking into the room) and
    {scene}/intrinsic/intrinsic_color.txt (4 x 4).  Returns the train dir."""
    import numpy as np

    rng = np.random.default_rng(seed)
    novel = [c for c in args.test_range_list if c not in args.train_range_list]
    ids = np.array(list(args.train_range_list) + novel[:60] + [1, 3])
    lx, ly, lz = SCANNET_ROOM
    h, w = SCANNET_IMAGE_HW
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 1170.0
    k[0, 2], k[1, 2] = w / 2 - 0.5, h / 2 - 0.5
    for split, n in (("train", SCANNET_TRAIN_SCANS), ("val", SCANNET_VAL_SCANS)):
        d = os.path.join(root, f"scannet_frames_{split}")
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            scene, seq = f"scene{i:04d}_{split == 'val':02d}", str(100 * i)
            nb = int(rng.integers(4, 25))
            boxes = np.zeros((nb, 8))
            boxes[:, 3:6] = rng.uniform(0.15, 0.9, (nb, 3))
            boxes[:, 0] = rng.uniform(-lx / 2 + 1, lx / 2 - 1, nb)
            boxes[:, 1] = rng.uniform(-ly / 2 + 1, ly / 2 - 1, nb)
            boxes[:, 2] = boxes[:, 5] + rng.uniform(0, 0.8, nb)
            boxes[:, 7] = rng.choice(ids, nb)
            m = SCANNET_SCAN_POINTS
            which = rng.choice(3, m, p=(0.35, 0.3, 0.35))  # floor, walls, boxes
            pts = np.stack([rng.uniform(-lx / 2, lx / 2, m), rng.uniform(-ly / 2, ly / 2, m),
                            rng.uniform(0, lz, m)], 1)
            pts[which == 0, 2] = 0.0
            wall = which == 1
            side = rng.integers(0, 4, m)
            pts[wall & (side == 0), 0] = -lx / 2
            pts[wall & (side == 1), 0] = lx / 2
            pts[wall & (side == 2), 1] = -ly / 2
            pts[wall & (side == 3), 1] = ly / 2
            on_box = np.flatnonzero(which == 2)
            b = rng.integers(0, nb, on_box.size)
            u = rng.uniform(-1, 1, (on_box.size, 3))
            face = rng.integers(0, 3, on_box.size)
            u[np.arange(on_box.size), face] = rng.choice([-1.0, 1.0], on_box.size)
            pts[on_box] = boxes[b, 0:3] + u * boxes[b, 3:6]
            pc = np.concatenate([pts, rng.uniform(0, 255, (m, 3))], 1).astype(np.float32)
            np.save(os.path.join(d, f"{scene}_{seq}_pc.npy"), pc)
            np.save(os.path.join(d, f"{scene}_{seq}_bbox.npy"), boxes)
            a = rng.uniform(-0.3, 0.3)
            pose = np.eye(4)
            pose[:3, :3] = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                                     [0, 0, 1]]) @ np.array([[1.0, 0, 0], [0, 0, 1], [0, -1, 0]])
            pose[:3, 3] = [rng.uniform(-0.5, 0.5), -ly / 2 - 1.0, 1.5]
            for sub, fname, mat in (("pose", f"{seq}.txt", pose),
                                    ("intrinsic", "intrinsic_color.txt", k)):
                os.makedirs(os.path.join(d, scene, sub), exist_ok=True)
                np.savetxt(os.path.join(d, scene, sub, fname), mat, fmt="%.6f")
    return os.path.join(root, "scannet_frames_train")


def seeded_image_scannet():
    """The port's ScannetDetectionDataset with `_load_image` alone replaced:
    a seeded SCANNET_IMAGE_HW BGR frame (by the scan's name) turned to RGB,
    in place of the .jpg that OpenCV would decode, so that a GPU machine
    without cv2 runs the phase all the same.
    Everything else is the package's."""
    import zlib

    import numpy as np

    from coda_neurips2023_tpu_torch.datasets.scannet import ScannetDetectionDataset

    class SeededImageScannet(ScannetDetectionDataset):
        def _load_image(self, data_name):
            rng = np.random.default_rng(zlib.crc32(data_name.encode()))
            bgr = rng.integers(0, 256, (*SCANNET_IMAGE_HW, 3), dtype=np.uint8)
            name = os.path.join(self.data_path, data_name) + ".jpg"
            return np.ascontiguousarray(bgr[..., ::-1]), name, SCANNET_IMAGE_HW, (0, 0)

    return SeededImageScannet


def scannet_kernel_rows(torch, train_dir, results):
    """Kernels A and B against their plain versions on ScanNet scans at
    40000 points: A at 32 and 48 scenes (2048 centres, the cluster size its
    policy takes and whether the card runs that many clusters at once), B at
    32 scenes (r 0.2, k 64 on A's centres); kernel and plain ms, the bound."""
    import numpy as np

    from coda_neurips2023_tpu_torch.datasets.config import ScannetAnonymousConfig
    from coda_neurips2023_tpu_torch.datasets.scannet import ScannetDetectionDataset
    from coda_neurips2023_tpu_torch.ops import grouping, sampling
    from coda_neurips2023_tpu_torch.utils.device import multi_processor_count

    ds = ScannetDetectionDataset(ScannetAnonymousConfig(), "val", root_dir=train_dir,
                                 num_points=SCANNET_POINTS, seed=SEED)
    n = max(SCANNET_FPS_BATCHES)
    xyz = np.stack([ds[i % len(ds)]["point_clouds"][:, :3] for i in range(n)])
    xyz = torch.from_numpy(xyz).cuda().contiguous()
    sm = multi_processor_count(xyz.device)
    for b in SCANNET_FPS_BATCHES:
        x = xyz[:b].contiguous()
        cs = sampling.fps_cluster_size(b, SCANNET_POINTS, sm,
                                       lambda c: sampling.resident_clusters(x.device, c))
        resident = sampling.resident_clusters(x.device, cs)
        got = sampling.furthest_point_sample(x, 2048)
        want = sampling.furthest_point_sample_plain(x, 2048)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"fps B={b} N={SCANNET_POINTS}: kernel differs from the plain version")
        if resident < b:
            fail(f"fps B={b} N={SCANNET_POINTS}: the card runs {resident} clusters of {cs} at "
                 f"once, fewer than the {b} scenes")
        ms = time_ms(torch, lambda: sampling.furthest_point_sample(x, 2048))
        plain = time_ms(torch, lambda: sampling.furthest_point_sample_plain(x, 2048), reps=3)
        bnd = bound(FPS_OPS * b * 2047 * SCANNET_POINTS, 12 * b * SCANNET_POINTS + 4 * b * 2048)
        print(f"  fps              B={b} N={SCANNET_POINTS} -> 2048, cluster of {cs} "
              f"({resident} such clusters run at once) max_abs_err=0.0 kernel_ms={ms!r} "
              f"plain_ms={plain!r} bound_ms={bnd[0]!r} ({bnd[1]})")
        results["fps"][f"scannet_b{b}"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd[0],
                                               bound_by=bnd[1], cluster_size=cs,
                                               resident_clusters=resident)
        if b == 32:
            centres = sampling.gather_points(x, got)
    b = 32
    x = xyz[:b].contiguous()
    got = grouping.ball_query(0.2, 64, x, centres)
    want = grouping.ball_query_plain(0.2, 64, x, centres)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"ball_query B={b} N={SCANNET_POINTS}: kernel differs from the plain version")
    ms = time_ms(torch, lambda: grouping.ball_query(0.2, 64, x, centres))
    plain = time_ms(torch, lambda: grouping.ball_query_plain(0.2, 64, x, centres), reps=3)
    bnd, _ = ball_query_bound(torch, 0.2, 64, x, centres)
    cap = grouping.grid_cap(SCANNET_POINTS)
    print(f"  ball_query       B={b} N={SCANNET_POINTS} M=2048 r=0.2 k=64 (cells capped at "
          f"{cap}) max_abs_err=0.0 kernel_ms={ms!r} plain_ms={plain!r} bound_ms={bnd[0]!r} "
          f"({bnd[1]})")
    results["ball_query"][f"scannet_b{b}"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd[0],
                                                  bound_by=bnd[1])


def scannet_eval_phase(torch, root, ckpt4, launches4, results):
    """Phase 15 (a): the eval entry point on ScanNet fixture scans."""
    from coda_neurips2023_tpu_torch import _kernels, engine
    from coda_neurips2023_tpu_torch.datasets.config import ScannetAnonymousConfig
    from coda_neurips2023_tpu_torch.engine import make_eval_step
    from coda_neurips2023_tpu_torch.main import make_args_parser
    from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR

    out_dir = _kernels.BUILD_DIR.parent / "phase15"
    args = make_args_parser().parse_args(script_lists(root, "coda_scannet_stage1.sh"))
    t0 = time.perf_counter()
    train_dir = write_scannet_fixture(str(out_dir), args, SEED)
    print(f"phase 15: ScanNet fixture ({SCANNET_TRAIN_SCANS} train and {SCANNET_VAL_SCANS} val "
          f"scans of {SCANNET_SCAN_POINTS} points, 4 x 4 poses) written in "
          f"{time.perf_counter() - t0:.2f} s under {out_dir}")
    # phase 4's weights with the angle heads cut to ScanNet's one bin
    sd = torch.load(ckpt4, map_location="cpu")["model"]
    for prefix in ANGLE_HEAD_OUT:
        for suffix in (".weight", ".bias"):
            sd[prefix + suffix] = sd[prefix + suffix][:1].clone()
    ckpt = out_dir / "model.pth"
    torch.save({"model": sd}, ckpt)
    model = CoDA3DETR(ScannetAnonymousConfig(), device="cuda")
    model.load_state_dict(sd, strict=True)
    model.eval()
    scenes_per_step = -(-SCANNET_VAL_SCANS // BATCH)
    per_step = {name: launches4[name] // STEPS for name in ("fps", "ball_query", "gather",
                                                            "attention")}
    for points in SCANNET_EVAL_POINTS:
        what = f"--num_points {points}" if points else "the CLI's --num_points (20000)"
        print(f"  (a) main --test_only, the scannet_stage1 row of test_release_models.sh, "
              f"{SCANNET_VAL_SCANS} val scans at {what}, B={BATCH}, {SCANNET_CLASSES} classes")
        argv = SCANNET_CLI_ARGS + ["--dataset_root_dir", train_dir, "--test_ckpt", str(ckpt),
                                   "--log_file", str(out_dir / f"eval_{points or 20000}.lst")]
        if points:
            argv += ["--num_points", str(points)]
        with recording_eval_step(engine, {}) as store:
            metrics, launches, stats, meter, seconds = cli_run(torch, argv, SCANNET_CLI_WORKERS)
        check_cli_metrics(metrics, SCANNET_VAL_SCANS, stats, meter, what, SCANNET_CLASSES)
        batch, got = store["first"]
        n_pts = batch["point_clouds"].shape[1]
        if n_pts != (points or NUM_POINTS):
            fail(f"ScanNet eval at {what} read {n_pts} points a scan")
        print(f"    launches: {launches}")
        for name, n in per_step.items():
            if launches[name] != n * scenes_per_step:
                fail(f"{name} launched {launches[name]} times in {scenes_per_step} ScanNet "
                     f"steps, phase 4 {n} a step")
        others = {k: v for k, v in launches.items() if k not in per_step and v}
        if others:
            fail(f"kernels off the detector eval path launched: {others}")
        results.setdefault("scannet_cli_launches", {})[points or NUM_POINTS] = launches
        want = make_eval_step(model, eval_text_features=store["bank"],
                              eval_logit_scale=100.0)(batch)
        err = max((got[k] - want[k]).abs().max().item() for k in want)
        print(f"    first batch ({tuple(batch['point_clouds'].shape)}) vs the eval step on it: "
              f"max_abs_err={err!r}")
        if not err <= MXU_TOL:
            fail(f"ScanNet CLI's first batch differs from the eval step by {err!r} > {MXU_TOL}")
        report_loop(stats, meter, seconds, SCANNET_CLI_WORKERS)
    os.environ.pop("CODA_AP_WORKERS", None)
    print(f"  (a) kernels A and B at ScanNet's {SCANNET_POINTS} points, against their plain "
          "versions")
    with torch.inference_mode():
        scannet_kernel_rows(torch, train_dir, results)
    return train_dir, args


def scannet_stage1_phase(torch, train_dir, args):
    """Phase 15 (b): the ScanNet stage-1 training step, and GPU vs CPU."""
    import numpy as np

    from coda_neurips2023_tpu_torch.datasets import build_dataset
    from coda_neurips2023_tpu_torch.datasets.loader import collate

    args.dataset_root_dir = train_dir
    _, cfg, real_cfg, _ = build_dataset(args)
    print("phase 15 (b): the ScanNet stage-1 step: scripts/coda_scannet_stage1.sh's flags "
          f"(--ngpus 1), {TRAIN_STEPS} steps of {TRAIN_BATCH} x {args.num_points} points with "
          f"{SCANNET_IMAGE_HW[0]} x {SCANNET_IMAGE_HW[1]} images, {args.distillation_box_num} "
          "crops a scene, the 4 x 4 pose projection, the default ball query (kernel B)")
    print("  no OpenCV needed: the batches come from ScannetDetectionDataset with "
          "_load_image alone replaced by a seeded 968 x 1296 frame (chip_smoke.py)")
    ds = seeded_image_scannet()(
        cfg, "train", root_dir=train_dir, num_points=args.num_points, use_color=args.use_color,
        augment=True, if_input_image=True, if_image_augment=args.if_image_augment,
        anonymous=True, confidence_type_in_datalayer=args.confidence_type_in_datalayer,
        pseudo_setting=args.pseudo_setting, seed=SEED)
    t0 = time.perf_counter()
    batches = []
    for i in range(TRAIN_STEPS + 1):
        host = collate([ds[(i * TRAIN_BATCH + j) % len(ds)] for j in range(TRAIN_BATCH)])
        batches.append({k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
                        for k, v in host.items() if not isinstance(v, list)})
    print(f"  {len(batches)} batches from the dataset in {time.perf_counter() - t0:.2f} s; "
          f"K {tuple(batches[0]['K'].shape)}, Rtilt (the pose) {tuple(batches[0]['Rtilt'].shape)}, "
          f"XZ flips {int((batches[0]['zx_flip_array'] < 0).sum())} of {TRAIN_BATCH}")
    launches, ctx = stage1_phase(
        torch, cfg, batches, stage_args=args, bank_cfg=real_cfg, bq="ball_query",
        title="  the stage-1 step (3detr_predictedbox_distillation at the script's widths)")
    stage1_cpu_phase(torch, cfg, ctx, batches[0], stage_args=args,
                     title="  the ScanNet stage-1 step on 2 scenes, GPU vs CPU (plain PyTorch), "
                           "dropout 0")
    return launches


def mode_files(directory, scans):
    """{name: path} of a mode's files for the scan indices `scans`."""
    if directory is None or not os.path.isdir(directory):
        return {}
    keys = [f"{s:06d}" for s in scans]
    return {f: os.path.join(directory, f) for f in sorted(os.listdir(directory))
            if any(k in f for k in keys)}


def only_face_points(got, want, row):
    """Whether the points one device's in-hull test kept and the other's did
    not all lie within MODE_TOL of the faces of the box `row` (centre, size,
    heading, objectness): the two devices' boxes differ by about 1e-5 m, so
    a point on a face may fall on either side.  The heading's sign is the
    one that puts every kept point inside the box."""
    import numpy as np

    diff = np.array(sorted({tuple(p) for p in got} ^ {tuple(p) for p in want}), np.float64)
    centre, half, angle = row[:3], row[3:6] / 2, row[6]
    for sign in (1.0, -1.0):
        c, s = np.cos(sign * angle), np.sin(sign * angle)

        def local(p):
            d = np.asarray(p, np.float64).reshape(-1, 3) - centre
            return np.stack([c * d[:, 0] - s * d[:, 1], s * d[:, 0] + c * d[:, 1], d[:, 2]], 1)

        if (np.abs(local(want)) <= half + MODE_TOL).all():
            excess = np.abs(local(diff)) - half  # > 0 outside a face's plane
            return bool((excess.max(1) <= MODE_TOL).all()
                        and (np.abs(excess).min(1) <= MODE_TOL).all())
    return False


def compare_mode_files(got, want, what):
    """The GPU's files for the CPU's scenes: the same names, numbers within
    MODE_TOL (text numbers, .npy arrays); a box's points (`_pred_pc.npy`)
    the same but for points on its faces (only_face_points)."""
    import re

    import numpy as np

    if sorted(got) != sorted(want):
        fail(f"{what}: the GPU wrote {sorted(got)[:6]}, the CPU {sorted(want)[:6]}")
    number = re.compile(r"-?\d+\.\d+")
    worst, face_points = 0.0, 0
    for name in want:
        if name.endswith("_pred_pc.npy"):
            g, w = np.load(got[name]), np.load(want[name])
            if g.shape != w.shape or not np.array_equal(g, w):
                row = np.load(want[name].replace("_pred_pc.npy", "_pred_box.npy"))[0]
                if not only_face_points(g, w, row):
                    fail(f"{what}: {name} holds other points on the GPU ({len(g)}) than on "
                         f"the CPU ({len(w)}), not only points on the box's faces")
                face_points += abs(len(g) - len(w))
            continue
        if name.endswith(".npy"):
            g, w = np.load(got[name]), np.load(want[name])
        else:
            gt, wt = open(got[name]).read(), open(want[name]).read()
            if number.sub("#", gt) != number.sub("#", wt):
                fail(f"{what}: {name} differs beyond its numbers")
            g = np.array(number.findall(gt), np.float64)
            w = np.array(number.findall(wt), np.float64)
        if g.shape != w.shape:
            fail(f"{what}: {name} shape {g.shape} on the GPU, {w.shape} on the CPU")
        if g.size:
            worst = max(worst, float(np.abs(g - w).max()))
    if not worst <= MODE_TOL:
        fail(f"{what}: the GPU's files differ from the CPU's by {worst!r} > {MODE_TOL}")
    if face_points:
        print(f"    {face_points} point(s) on a box's face kept by one device only")
    return worst


def modes_phase(torch, ckpt4):
    """Phase 16: the secondary modes through main on the card, and each
    mode's first scenes on the CPU."""
    import numpy as np

    from coda_neurips2023_tpu_torch import _kernels, modes
    from coda_neurips2023_tpu_torch.datasets import build_dataset
    from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
    from coda_neurips2023_tpu_torch.datasets.loader import collate
    from coda_neurips2023_tpu_torch.engine import make_eval_step
    from coda_neurips2023_tpu_torch.main import main as cli_main
    from coda_neurips2023_tpu_torch.main import make_args_parser
    from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
    from coda_neurips2023_tpu_torch.stages import StageContext
    from coda_neurips2023_tpu_torch.utils.io import restore_params_only

    scenes = MODE_SCENES // 4
    out_dir = _kernels.BUILD_DIR.parent / "phase16"
    print(f"phase 16: the secondary modes through main --test_ckpt (phase 4's weights) on "
          f"{scenes} synthetic scenes, B={BATCH}, the flagship at full width; each mode's first "
          f"{MODE_CPU_SCENES} scenes also on the CPU")
    print("  --crop_only writes PNGs with OpenCV, which a GPU machine may lack: the CPU tests "
          "(tests/test_torch_port_modes.py) hold it")
    base = [a for a in CLI_ARGS if a != "--test_only"]
    for mode, extra, sub in MODES:
        run_dir = out_dir / mode
        argv = ["--test_only", f"--{mode}", *extra, *base, "--synthetic_num_scenes",
                str(MODE_SCENES), "--test_ckpt", str(ckpt4), "--checkpoint_dir", str(run_dir)]
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        result = cli_main(argv)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in _kernels.LAUNCHES.items() if v}
        files = sorted(os.listdir(run_dir / sub)) if sub else []
        shown = result.sum() if mode == "cal_class_only" else result
        print(f"  --{mode}: {ms!r} ms (main, the split's build included); returned "
              f"{'a confusion matrix of ' if mode == 'cal_class_only' else ''}{shown!r}; "
              f"{len(files)} files {files[:4]}{' ...' if len(files) > 4 else ''}; "
              f"launches {launches}")
        # the seen features crop the ground truth's boxes: no detector forward
        needed = {"save_seen_feat_only": ("vit_attention",),
                  "save_novel_with_class_only": ("fps", "ball_query", "gather", "attention",
                                                 "vit_attention")}
        for name in needed.get(mode, ("fps", "ball_query", "gather", "attention")):
            if launches.get(name, 0) <= 0:
                fail(f"--{mode}: kernel {name} was not launched")
        if sub and not files:
            fail(f"--{mode} wrote no file")

        # the same mode on the CPU, on the first scenes of the first batch
        args = make_args_parser().parse_args(argv)
        datasets, _, real_cfg, _ = build_dataset(args)
        host = collate([datasets["test"][i] for i in range(MODE_CPU_SCENES)])
        cpu_model = restore_params_only(str(ckpt4), CoDA3DETR(SunrgbdAnonymousConfig(),
                                                              device="cpu"))
        cpu_dir = out_dir / f"{mode}_cpu"
        if mode == "show_only":
            got = modes.show_boxes(cpu_model, [host], str(cpu_dir), device="cpu")
        elif mode == "show_box_points":
            got = modes.save_box_points(cpu_model, [host], str(cpu_dir), device="cpu")
        elif mode == "cal_class_only":
            gpu_model = restore_params_only(str(ckpt4), CoDA3DETR(SunrgbdAnonymousConfig(),
                                                                  device="cuda"))
            bank = StageContext(args, real_cfg, device="cuda").text_banks["test"]
            want = modes.calculate_class_confusion(
                make_eval_step(gpu_model, eval_text_features=bank), [host], args.test_num_semcls,
                device="cuda")
            got = modes.calculate_class_confusion(
                make_eval_step(cpu_model, eval_text_features=bank.cpu()), [host],
                args.test_num_semcls, device="cpu")
            if not np.array_equal(got, want):
                fail(f"--{mode}: the confusion of the first {MODE_CPU_SCENES} scenes differs "
                     "between GPU and CPU")
            print(f"    CPU, first {MODE_CPU_SCENES} scenes: the confusion matrix equal to the "
                  f"GPU's ({int(got.sum())} boxes counted)")
            continue
        else:
            ctx = StageContext(args, real_cfg, device="cuda").to("cpu")
            if mode == "save_seen_feat_only":
                got = modes.save_seen_feats(cpu_model, [host], ctx, str(cpu_dir), device="cpu")
            else:
                got = modes.save_novel_boxes(cpu_model, [host], ctx, device="cpu")
                print(f"    CPU, first {MODE_CPU_SCENES} scenes: {got} novel rows (the test "
                      "split has no pseudo-label paths, so neither writes a file)")
                continue
        scans = [int(s) for s in host["scan_idx"]]
        worst = compare_mode_files(mode_files(run_dir / sub, scans), mode_files(cpu_dir, scans),
                                   f"--{mode}")
        print(f"    CPU, first {MODE_CPU_SCENES} scenes: {got} written, the same files as the "
              f"GPU's, numbers max_abs_err={worst!r}")


# phase 17: data parallelism (parallel/ddp.py).  (a) DDP_WORLD ranks on the
# one card over gloo (NCCL takes one card a rank) with
# scripts/coda_sunrgbd_stage1.sh's flags at batchsize_per_gpu DDP_PER_RANK,
# against one process at the global batch; (b) the CLI at the scripts'
# --ngpus 8, and (a) over NCCL where two or more cards are visible
DDP_WORLD = 2
DDP_PER_RANK = 4
DDP_STEPS = 4
DDP_TOL = 1e-3  # phase 11's STEP_TOL for the losses; the weights as a share of their norm
DDP_METRIC_TOL = 5e-3  # tests/test_torch_port_eval.py's METRIC_TOL
DDP_KERNELS = ("fps", "ball_query", "gather", "attention", "vit_attention")


def batch_digest(batch):
    """A digest of a host batch's arrays and list fields."""
    import hashlib

    import numpy as np

    h = hashlib.sha1()
    for k in sorted(batch):
        v = batch[k]
        h.update(k.encode())
        h.update(repr(v).encode() if isinstance(v, list) else np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def state_digest(model):
    import hashlib

    h = hashlib.sha1()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def ddp_probe(torch, record, split=1):
    """While installed: the crop selection pinned to each scene's first
    --distillation_box_num proposals (runs over any number of ranks crop the
    same boxes), and for every training step of this process, in `record`:
    its host batch's scans and the digests of its `split` row blocks, its
    loss, its device span, its kernel launches, and the gradient
    all-reduce's bytes and ms (synchronized on both sides)."""
    from coda_neurips2023_tpu_torch import _kernels, engine, stages
    from coda_neurips2023_tpu_torch.parallel import ddp

    saved = (engine.train_one_epoch, stages.StageContext.select_boxes, ddp.all_reduce_gradients)
    train_one_epoch, _, all_reduce = saved

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def one_epoch(train_step, batches, **kw):
        def host(batches):
            for b in batches:
                record["rows"].append((b["scan_idx"].tolist(),
                                       [batch_digest(ddp.rows(b, r, split)) for r in range(split)]))
                yield b

        def step(batch, generator):
            before = dict(_kernels.LAUNCHES)
            start = event()
            out = train_step(batch, generator)
            end = event()
            metrics = out[0] if isinstance(out, tuple) else out
            record["steps"].append(dict(events=(start, end), loss=metrics["loss"], launches={
                k: v - before[k] for k, v in _kernels.LAUNCHES.items()}))
            return out

        return train_one_epoch(step, host(batches), **kw)

    def pinned(self, last, batch, generator=None):
        b = last["objectness_prob"].shape[0]
        n = self.args.distillation_box_num
        return torch.arange(n, device=last["objectness_prob"].device).expand(b, n)

    def timed(params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = all_reduce(params)
        torch.cuda.synchronize()
        record["allreduce"].append((n, (time.perf_counter() - t0) * 1e3))
        return n

    engine.train_one_epoch, stages.StageContext.select_boxes, ddp.all_reduce_gradients = (
        one_epoch, pinned, timed)
    try:
        yield record
    finally:
        engine.train_one_epoch, stages.StageContext.select_boxes, ddp.all_reduce_gradients = saved


def finish_record(torch, record):
    torch.cuda.synchronize()
    steps = record.pop("steps")
    record["losses"] = [float(s["loss"]) for s in steps]
    record["step_ms"] = [s["events"][0].elapsed_time(s["events"][1]) for s in steps]
    record["launches"] = [s["launches"] for s in steps]
    return record


def ddp_rank(out_dir, train_argv, eval_argv):
    """One rank of phase 17: the training CLI under ddp_probe, then the eval
    CLI under recording_meter (only rank 0 meters); writes what it saw to
    <out_dir>/rank<r>.pkl and returns the eval's metrics (rank 0's; None on
    the others)."""
    import pickle

    import torch

    from coda_neurips2023_tpu_torch import engine
    from coda_neurips2023_tpu_torch.main import main as cli_main
    from coda_neurips2023_tpu_torch.parallel import dist as pdist

    record = {"rows": [], "steps": [], "allreduce": []}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with ddp_probe(torch, record):
        model = cli_main(train_argv)
    record["train_s"] = time.perf_counter() - t0
    record["digest"] = state_digest(model)
    del model
    finish_record(torch, record)
    t0 = time.perf_counter()
    with recording_meter([]) as metered:
        metrics = cli_main(eval_argv)
    record.update(metered=metered, eval_s=time.perf_counter() - t0, scans=engine.EVAL_STATS["scans"],
                  peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    with open(os.path.join(out_dir, f"rank{pdist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(record, f)
    return metrics


def ddp_checks(torch, root, smi, world, backend, devices, ckpt13, eval13, tag):
    """Phase 17's run of `world` ranks on `devices` over `backend` against
    one process at the same global batch, then their eval against phase
    13's (`eval13`, cli_phase's): each batch rank 0 metered (the ranks' rows
    gathered in rank order, the padding dropped) against the same batch of
    phase 13's one process, its ground truth bit for bit, and its outputs
    within MXU_TOL of phase 13's model and bank stepping that global batch
    a rank's rows at a time (a step's fp32 rounding follows its batch: kernel
    D's key splits and the GEMMs' tiling); returns rank 0's launches over
    its training steps."""
    import pickle
    import shutil

    from coda_neurips2023_tpu_torch import _kernels
    from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
    from coda_neurips2023_tpu_torch.engine import make_eval_step
    from coda_neurips2023_tpu_torch.main import main as cli_main
    from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
    from coda_neurips2023_tpu_torch.parallel import ddp
    from coda_neurips2023_tpu_torch.utils.io import restore_params_only

    out_dir = _kernels.BUILD_DIR.parent / "phase17" / tag
    if out_dir.exists():
        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    scenes = DDP_STEPS * DDP_PER_RANK * world

    def train_argv(ranks, per_rank, name):
        return script_argv(root, "coda_sunrgbd_stage1.sh", {
            "--ngpus": str(ranks), "--max_epoch": "1", "--batchsize_per_gpu": str(per_rank)}) + [
            "--synthetic_num_scenes", str(scenes), "--batchsize_per_gpu_test", str(per_rank),
            "--enc_dropout", "0", "--dec_dropout", "0", "--mlp_dropout", "0",
            "--checkpoint_dir", str(out_dir / name)]

    per_rank_test = max(BATCH // world, 1)
    eval_argv = list(CLI_ARGS) + [
        "--synthetic_num_scenes", str(CLI_SCENES), "--test_ckpt", str(ckpt13),
        "--log_file", str(out_dir / "eval.lst"), "--ngpus", str(world)]
    eval_argv[eval_argv.index("--batchsize_per_gpu_test") + 1] = str(per_rank_test)
    print(f"phase 17 ({tag}): {world} ranks on {sorted(set(devices))} over {backend}: "
          f"scripts/coda_sunrgbd_stage1.sh's flags, the flagship at full width, "
          f"--batchsize_per_gpu {DDP_PER_RANK} (global {DDP_PER_RANK * world}), {DDP_STEPS} steps "
          f"on {scenes} synthetic scenes, dropout 0, the crops pinned; then --test_only on "
          f"phase 13's {CLI_SCENES // 4} scenes at --batchsize_per_gpu_test {per_rank_test}")
    torch.cuda.empty_cache()
    os.environ["CODA_AP_WORKERS"] = str(CLI_WORKERS[0])
    t0 = time.perf_counter()
    url = ddp.free_url()
    metrics = ddp.launch(ddp_rank, world, str(out_dir), train_argv(world, DDP_PER_RANK, "ranks"),
                         eval_argv, devices=devices, backend=backend, dist_url=url)
    launch_s = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    one = {"rows": [], "steps": [], "allreduce": []}
    t0 = time.perf_counter()
    with ddp_probe(torch, one, split=world):
        cli_main(train_argv(1, DDP_PER_RANK * world, "one"))
    one_s = time.perf_counter() - t0
    finish_record(torch, one)
    os.environ.pop("CODA_AP_WORKERS", None)

    for r, rec in enumerate(ranks):
        if len(rec["rows"]) != DDP_STEPS or len(one["rows"]) != DDP_STEPS:
            fail(f"rank {r} took {len(rec['rows'])} steps, one process {len(one['rows'])}, "
                 f"expected {DDP_STEPS}")
        for k, ((scans, digest), (all_scans, digests)) in enumerate(zip(rec["rows"], one["rows"])):
            b = len(scans)
            if scans != all_scans[r * b:(r + 1) * b] or digest[0] != digests[r]:
                fail(f"step {k}: rank {r}'s rows are not rows {r * b}..{(r + 1) * b - 1} of one "
                     f"process's batch (scans {scans} against {all_scans})")
        for k, launched in enumerate(rec["launches"]):
            missing = [n for n in DDP_KERNELS if launched[n] <= 0]
            if missing or launched["vit_attention"] != CLIP_LAYERS:
                fail(f"rank {r} step {k}: kernels {missing} not launched, vit_attention "
                     f"{launched['vit_attention']} times ({launched})")
    print(f"  every rank's rows are its block of one process's batch, bit for bit; A-E launched "
          f"on every rank's every step")
    losses = [rec["losses"] for rec in ranks]
    if any(l != losses[0] for l in losses):
        fail(f"the ranks' all-reduced losses differ: {losses}")
    err = max(abs(a - b) for a, b in zip(losses[0], one["losses"]))
    print(f"  losses, {world} ranks {losses[0]!r}; one process {one['losses']!r}; max |diff| {err!r}")
    if not err <= DDP_TOL:
        fail(f"{world} ranks' losses differ from one process's by {err!r} > {DDP_TOL}")
    digests = {rec["digest"] for rec in ranks}
    if len(digests) != 1:
        fail("the ranks' parameters and buffers differ after the steps")
    got, want = (torch.load(out_dir / d / "last_checkpoint.pth", weights_only=True)["model"]
                 for d in ("ranks", "one"))
    names = [k for k in want if not k.endswith("num_batches_tracked")]
    diff = math.sqrt(sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in names))
    norm = math.sqrt(sum(float((want[k].double() ** 2).sum()) for k in names))
    print(f"  weights and BatchNorm statistics after {DDP_STEPS} steps: |diff| / |one| "
          f"{diff / norm!r}; the ranks' states bit-equal")
    if not diff / norm <= DDP_TOL:
        fail(f"{world} ranks' weights differ from one process's by {diff / norm!r} of their norm")
    files = {name: sorted(n for n in os.listdir(out_dir / name) if not n.startswith("events.out"))
             for name in ("ranks", "one")}
    if files["ranks"] != files["one"]:
        fail(f"{world} ranks wrote {files['ranks']}, one process {files['one']}")
    print(f"  one set of files, rank 0's: {files['ranks']}")
    rec0 = ranks[0]
    if rec0["scans"] != CLI_SCENES // 4:
        fail(f"the {world}-rank eval metered {rec0['scans']} scans, not {CLI_SCENES // 4}")
    metered13 = eval13["metered"]
    if any(rec["metered"] for rec in ranks[1:]) or len(rec0["metered"]) != len(metered13):
        fail(f"the ranks metered {[len(rec['metered']) for rec in ranks]} batches, phase 13's "
             f"one process {len(metered13)}")
    model = restore_params_only(str(ckpt13), CoDA3DETR(SunrgbdAnonymousConfig(), device="cuda"))
    step = make_eval_step(model, eval_text_features=eval13["bank"], eval_logit_scale=100.0)
    rows_err, whole_err = 0.0, 0.0
    for k, ((got, got_truth), (whole, want_truth), batch) in enumerate(
            zip(rec0["metered"], metered13, eval13["batches"])):
        if got_truth != want_truth or any(got[n].shape != whole[n].shape for n in whole):
            fail(f"eval batch {k}: rank 0 metered other rows (or another order, or other "
                 f"padding) than phase 13's one process: {got['box_corners'].shape} against "
                 f"{whole['box_corners'].shape}")
        # a padded batch holds its real rows first, as many as phase 13 metered
        real = len(whole["box_corners"])
        blocks = [step({n: v[r * per_rank_test:(r + 1) * per_rank_test] for n, v in batch.items()})
                  for r in range(world)]
        want = {n: torch.cat([b[n] for b in blocks])[:real].cpu().numpy() for n in whole}
        rows_err = max([rows_err] + [float(abs(got[n] - want[n]).max()) for n in want])
        whole_err = max([whole_err] + [float(abs(got[n] - whole[n]).max()) for n in whole])
    del model, step
    print(f"  --test_only over {world} ranks: rank 0 metered {len(metered13)} batches, the ranks' "
          f"rows gathered in rank order and the padding dropped: the ground truth phase 13's "
          f"batches' bit for bit; the outputs within max_abs_err={rows_err!r} of phase 13's "
          f"model stepping its batches {per_rank_test} rows at a time ({whole_err!r} of its "
          f"one process at {BATCH})")
    if not rows_err <= MXU_TOL:
        fail(f"the {world}-rank eval's outputs differ from one process's by {rows_err!r} > "
             f"{MXU_TOL}")
    metrics13 = eval13["metrics"]
    worst = max(abs(float(metrics[t][k]) - float(metrics13[t][k]))
                for t in metrics13 for k in metrics13[t])
    print(f"  --test_only over {world} ranks: {rec0['scans']} scans metered by rank 0, metrics "
          f"vs phase 13's one process max |diff| {worst!r}; mAP@0.25 {float(metrics[0.25]['mAP'])!r}")
    if set(metrics) != set(metrics13) or not worst <= DDP_METRIC_TOL:
        fail(f"the {world}-rank eval's metrics differ from phase 13's by {worst!r}")
    note = ("gloo over one card's shared SMs: not a scaling number" if backend == "gloo"
            else f"NCCL, one card a rank")
    for r, rec in enumerate(ranks):
        ar = rec["allreduce"]
        print(f"  rank {r} [{smi}] ({note}): step ms {[round(x, 3) for x in rec['step_ms']]}; "
              f"gradient all-reduce {ar[0][0]} bytes a step, ms {[round(ms, 3) for _, ms in ar]}; "
              f"train CLI {rec['train_s']:.1f} s, eval CLI {rec['eval_s']:.1f} s; peak memory "
              f"allocated {rec['peak_gb']!r} GB")
    print(f"  one process at batch {DDP_PER_RANK * world} [{smi}]: step ms "
          f"{[round(x, 3) for x in one['step_ms']]}; train CLI {one_s:.1f} s; the {world}-rank "
          f"launch {launch_s:.1f} s")
    return {n: sum(l[n] for l in rec0["launches"]) for n in rec0["launches"][0]}


class _Tee:
    """A stdout that also keeps what is written."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def ddp_phase(torch, root, smi, ckpt13, eval13):
    """Phase 17: (a) two ranks on the one card; (b) the CLI at --ngpus 8 and,
    with two or more cards, (a) over NCCL.  Returns (a)'s launches of rank 0."""
    from coda_neurips2023_tpu_torch import _kernels
    from coda_neurips2023_tpu_torch.main import main as cli_main
    from coda_neurips2023_tpu_torch.parallel import ddp

    t_phase = time.perf_counter()
    launches = ddp_checks(torch, root, smi, DDP_WORLD, "gloo", ["cuda:0"] * DDP_WORLD, ckpt13,
                          eval13, "a")
    cards = torch.cuda.device_count()
    world = min(8, cards)
    argv = list(CLI_ARGS) + ["--synthetic_num_scenes", str(4 * BATCH), "--test_ckpt", str(ckpt13),
                             "--log_file", str(_kernels.BUILD_DIR.parent / "phase17" / "b.lst"),
                             "--ngpus", "8", "--dist_url", ddp.free_url()]
    argv[argv.index("--batchsize_per_gpu_test") + 1] = str(max(BATCH // world, 1))
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        metrics = cli_main(argv)
    said = f"data parallel: {world} rank(s) (--ngpus 8, {cards} cards)"
    if said not in "".join(tee.text) or set(metrics) != {0.25, 0.5}:
        fail(f"main --ngpus 8 with {cards} card(s) did not say {said!r} or gave no metrics")
    print(f"phase 17 (b): main --test_only --ngpus 8 (the scripts' value) with {cards} card(s) "
          f"visible ran {world} rank(s)")
    if cards >= 2:
        ddp_checks(torch, root, smi, world, "nccl", [f"cuda:{r}" for r in range(world)], ckpt13,
                   eval13, "b")
    else:
        print("  (a)'s checks over NCCL did not run: one card is visible, and NCCL takes one "
              "card a rank (it refuses two ranks on one card); this run is no pass of NCCL")
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return launches


# phase 18: the bf16 paths.  The card's dense bf16 tensor-core rate for the
# bound of kernels D-bf16 and E-bf16 (NVIDIA's H100 SXM data sheet, 700 W)
BF16_PEAK = 989e12  # FLOP/s
BF16_KERNELS = {
    "attention_bf16": ("coda_neurips2023_tpu_torch/csrc/attention_bf16.cuh",
                       "coda_neurips2023_tpu/ops/pallas_masked_attention.py:121"),
    "vit_attention_bf16": ("coda_neurips2023_tpu_torch/csrc/vit_attention_bf16.cu",
                           "coda_neurips2023_tpu/ops/pallas_vit_attention.py:109"),
}
# bf16 detector vs its plain bf16 path on the card, and the CLIP-crop scores
# of the bf16 tower: both round the same products to bf16 but take their own
# exp and sum in their own orders, so a p or an activation at a rounding
# boundary lands on the neighbouring bf16 value and moves what follows
# (the CPU tests measure 0.4-5% of an output's largest magnitude against the
# JAX package's bf16 model); held to 3e-2 of each output's largest magnitude,
# 6e-2 for the small sem logits
BF16_MODEL_TOL = 3e-2
BF16_SEM_LOGITS_TOL = 6e-2
# phase 18 (a): a bf16 kernel and its plain version round p at the same
# place, so they differ only where a p lies at a rounding boundary; below
# this share of bit-equal elements something else differs
BF16_BIT_EQUAL = 0.995


def bf16_ulp(torch, x):
    """One bf16 ulp (8 significant bits) at |x|, 0 at 0."""
    mag = x.abs().float()
    exp = torch.floor(torch.log2(torch.where(mag > 0, mag, torch.ones_like(mag))))
    return torch.where(mag > 0, torch.exp2(exp - 7), torch.zeros_like(mag))


def bf16_attention_check(torch, got, want, p_abs_v, label):
    """A bf16 kernel against its plain version: both round p to bf16 at the
    same place, so they differ where a p lies at a rounding boundary (its
    exp2f and sum against torch's): at most one bf16 ulp of each p, at most
    2^-7 of it, so 2^-7 sum_j p_j |v_j| before the output's rounding, which
    adds one ulp of the row's largest magnitude.  Returns the max abs
    error."""
    err = (got.float() - want.float()).abs()
    bound = 2.0 ** -7 * p_abs_v + bf16_ulp(torch, want.float().abs().amax(-1, keepdim=True))
    own = (err > bf16_ulp(torch, torch.maximum(got.float().abs(), want.float().abs()))).sum()
    if not (err <= bound).all():
        fail(f"{label}: {int((err > bound).sum())} elements beyond the bf16 rounding bound "
             f"(max_abs_err {err.max().item()!r})")
    equal = (got == want).float().mean().item()
    print(f"  {'':16s} {'':44s} bit-equal {equal!r}; "
          f"{int(own)} elements over one ulp of their own magnitude")
    if equal < BF16_BIT_EQUAL:
        fail(f"{label}: only {equal!r} of the elements bit-equal (< {BF16_BIT_EQUAL})")
    return err.max().item()


def kernel_instance(mangled):
    """`kernel<args>` for a mangled kernel name (its last length-prefixed
    identifier that ends in "kernel", then its integer, float/bf16 and bool
    template arguments, the bool as "drop" or "nodrop"), else the mangled
    name."""
    import re

    for m in reversed(list(re.finditer(r"(?=(\d+))", mangled))):
        end = m.start() + len(m.group(1))
        ident = mangled[end:end + int(m.group(1))]
        if ident.endswith("kernel") and re.fullmatch(r"[A-Za-z_]\w*", ident):
            t = re.match(r"I((?:Li\d+E)+)(f|13__nv_bfloat16)?(Lb[01]E)?E",
                         mangled[end + len(ident):])
            if t is None:
                return ident
            args = re.findall(r"Li(\d+)E", t.group(1))
            args += {"f": ["f32"], "13__nv_bfloat16": ["bf16"]}.get(t.group(2), [])
            args += {"Lb0E": ["nodrop"], "Lb1E": ["drop"]}.get(t.group(3), [])
            return f"{ident}<{','.join(args)}>"
    return mangled


def ptxas_report(log_lines):
    """{kernel instance: {"registers": n, "spill_bytes": n, "stack_bytes": n}}
    from a build's ptxas log (-Xptxas=-v); spill bytes are the stores."""
    import re

    report, name = {}, None
    for line in log_lines:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_instance(m.group(1))
            report[name] = {"registers": None, "spill_bytes": None, "stack_bytes": None}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            report[name]["stack_bytes"] = int(m.group(1))
            report[name]["spill_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
    return report


def bf16_ptxas(torch):
    """Each bf16 kernel instance's registers and spill bytes (phase 2's
    ptxas log), and ptxas's warnings on them (notes C7510-C7515: it
    serialized D-bf16's wgmma); a spill fails."""
    from coda_neurips2023_tpu_torch import _kernels

    log = (_kernels.BUILD_DIR / "build.log").read_text().splitlines()
    for line in log:
        if "bf16" in line and ("warning" in line or "Performance" in line):
            print(f"  ptxas: {line.strip()}")
    report = {k: v for k, v in ptxas_report(log).items() if "bf16" in k and "kernel" in k}
    for name, info in report.items():
        print(f"  ptxas {name}: {info['registers']} registers, {info['spill_bytes']} bytes "
              f"spilled, {info['stack_bytes']} bytes of stack")
        if info["spill_bytes"]:
            fail(f"{name} spills {info['spill_bytes']} bytes")
    if not report:
        fail("no bf16 kernel in the build's ptxas log")


def bf16_division_check(torch, q, k):
    """D-bf16's division (a correctly rounded reciprocal of l a row, then
    q0 = e r, q = fma(fma(-q0, l, e), r, q0), or fp64 for e below 2^-80)
    against __fdiv_rn, bit for bit: on the (e, l) pairs of the encoder's
    scores (two of its scenes) and on a ladder of e = m 2^-x (x to 149)
    against ten sums."""
    from coda_neurips2023_tpu_torch import _kernels

    s = torch.matmul(q[:2].float(), k[:2].float())
    e = torch.exp(s - s.amax(-1, keepdim=True))
    l = e.sum(-1, keepdim=True).expand_as(e)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 180)
    ladder = torch.exp2(-torch.arange(0, 150, device=DEVICE, dtype=torch.float32))
    mant = 1.0 + torch.rand(256, device=DEVICE, generator=gen)
    el = (ladder[:, None] * mant[None, :]).clamp(max=1.0).reshape(-1)
    sums = torch.tensor([1.0, 1.0 + 2 ** -23, 1.5, 2.0, 3.0, 7.0, 100.3, 1000.7, 2047.9, 2048.0],
                        device=DEVICE)
    el, ll = (x.reshape(-1) for x in torch.broadcast_tensors(el[:, None], sums[None, :]))
    import ctypes

    lib = _kernels.library()
    ptr, n = ctypes.c_void_p, ctypes.c_int
    lib.coda_attention_bf16_div_check.argtypes = [ptr, ptr, ptr, ptr, n, ptr]
    lib.coda_attention_bf16_div_check.restype = ctypes.c_int
    for name, ev, lv in (("encoder", e.reshape(-1), l.reshape(-1)), ("ladder", el, ll)):
        ev, lv = ev.contiguous(), lv.contiguous()
        fast, ieee = torch.empty_like(ev), torch.empty_like(ev)
        if lib.coda_attention_bf16_div_check(ev.data_ptr(), lv.data_ptr(), fast.data_ptr(),
                                             ieee.data_ptr(), ev.numel(),
                                             torch.cuda.current_stream().cuda_stream):
            fail("the division check did not launch")
        torch.cuda.synchronize()
        differ = int((fast.view(torch.int32) != ieee.view(torch.int32)).sum())
        print(f"  division check, {name}: {ev.numel()} pairs (e, l), {differ} quotients differ "
              f"from __fdiv_rn")
        if differ:
            fail(f"D-bf16's division differs from __fdiv_rn on {differ} {name} pairs")


def bf16_bound(b, h, sq, skv, d):
    """QK and PV (4D flops a query-key pair) at the dense bf16 rate, the
    softmax's max, subtract, exp, sum, scale at the fp32 peak, and bf16 q,
    k, v and output read or written once."""
    pairs = b * h * sq * skv
    ops_ms = (pairs * 4 * d / BF16_PEAK + pairs * 5 / FP32_PEAK) * 1e3
    bytes_ms = 2 * b * h * (2 * sq * d + 2 * skv * d) / HBM_RATE * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def bf16_kernel_phase(torch, centres, results):
    """Phase 18 (a): D-bf16 and E-bf16 against their plain bf16 versions at
    the paths' shapes, timed beside SDPA in bf16."""
    from coda_neurips2023_tpu_torch.ops import masked_attention as ma
    from coda_neurips2023_tpu_torch.ops.vit_attention import vit_attention, vit_attention_plain
    from coda_neurips2023_tpu_torch.utils.device import multi_processor_count

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 18)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, device=DEVICE, generator=gen).to(bf16)

    def record(name, label, err, ms, plain_ms, bnd, library_ms, main, extra_prefix=None):
        entry = results.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if main:
            entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                         library_ms=library_ms)
        elif extra_prefix:
            entry.update({f"{extra_prefix}_ms": ms, f"{extra_prefix}_plain_ms": plain_ms,
                          f"{extra_prefix}_bound_ms": bnd[0],
                          f"{extra_prefix}_library_ms": library_ms})
        lib = f" library_ms={library_ms!r}" if library_ms is not None else ""
        print(f"  {name:16s} {label:44s} max_abs_err={err!r} kernel_ms={ms!r} "
              f"plain_ms={plain_ms!r} bound_ms={bnd[0]!r} ({bnd[1]}){lib}")

    bf16_ptxas(torch)
    b = centres.shape[0]
    sms = multi_processor_count(centres.device)
    cases = [
        ("encoder S=2048 H=4 D=64", 2048, 2048, 64, 0.0, "main"),
        ("decoder Sq=128 Skv=2048 H=4 D=128", 128, 2048, 128, 0.0, "decoder"),
        ("radius-masked S=2048 H=4 D=64 r=1.2**2", 2048, 2048, 64, 1.2 ** 2, "radius"),
    ]
    for label, sq, skv, d, radius, key in cases:
        q = (randn(b, 4, sq, d).float() / d ** 0.5).to(bf16)
        k, v = randn(b, 4, d, skv), randn(b, 4, skv, d)
        qxyz = centres[:, :sq].contiguous()
        kxyz_t = centres.transpose(1, 2).contiguous()
        splits, chunk = ma.attention_splits(b, 4, sq, skv, d, sms, bf16=True)
        kern = lambda: ma.masked_attention(q, k, v, qxyz, kxyz_t, radius, "bfloat16")
        if splits > 1:
            plain = lambda: ma.masked_attention_split_plain(q, k, v, qxyz, kxyz_t, radius, chunk,
                                                            "bfloat16")
        else:
            plain = lambda: ma.masked_attention_plain(q, k, v, qxyz, kxyz_t, radius, "bfloat16")
        got = kern()
        if got.dtype != bf16:
            fail(f"attention_bf16 {label}: output dtype {got.dtype}")
        p = torch.softmax(ma._bf16_scores(q, k, qxyz, kxyz_t, radius), dim=-1)
        p_abs_v = torch.matmul(p, v.float().abs())
        del p
        err = bf16_attention_check(torch, got, plain(), p_abs_v, f"attention_bf16 {label}")
        del got, p_abs_v
        if key == "main":
            bf16_division_check(torch, q, k)
        # the same function: q arrives scaled, so scale 1; the radius case's
        # allowed keys as a boolean mask (B, 1, Sq, Skv), made here, outside
        # the timed window (a row with no allowed key is NaN in SDPA; the
        # synthetic scenes' centres each hold themselves)
        kt = k.transpose(2, 3).contiguous()
        if radius > 0:
            allowed = (ma._scores(q[:, :1].float(), k[:, :1].float(), qxyz, kxyz_t, radius)
                       != torch.finfo(torch.float32).min)
            library = lambda: sdpa(q, kt, v, attn_mask=allowed, scale=1.0)
        else:
            library = lambda: sdpa(q, kt, v, scale=1.0)
        ms, library_ms = time_in_turns(torch, kern, library)
        plain_ms = time_ms(torch, plain, reps=3)
        record("attention_bf16", f"{label} splits={splits}", err, ms, plain_ms,
               bf16_bound(b, 4, sq, skv, d), library_ms, key == "main", key)
        fp32 = (q.float(), k.float(), v.float())
        print(f"  {'':16s} {'':44s} kernel D (fp32) ms="
              f"{time_ms(torch, lambda: ma.masked_attention(*fp32, qxyz, kxyz_t, radius))!r}")
        del q, k, v, fp32
    for crops in (128, 8 * N_SEL):
        q, k, v = (randn(crops, 12, 197, 64) for _ in range(3))
        kern = lambda: vit_attention(q, k, v)
        plain = lambda: vit_attention_plain(q, k, v)
        got = kern()
        if got.dtype != bf16:
            fail(f"vit_attention_bf16: output dtype {got.dtype}")
        p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) / 8.0, dim=-1)
        err = bf16_attention_check(torch, got, plain(), torch.matmul(p, v.float().abs()),
                                   f"vit_attention_bf16 {crops} crops")
        del p, got
        ms, library_ms = time_in_turns(torch, kern, lambda: sdpa(q, k, v))
        plain_ms = time_ms(torch, plain, reps=3)
        record("vit_attention_bf16", f"B={crops} crops H=12 S=197 D=64", err, ms, plain_ms,
               bf16_bound(crops, 12, 197, 197, 64), library_ms, crops == 128,
               None if crops == 128 else "stage1")
        del q, k, v
    # short sequences over 40 crops x 12 heads: every persistent block walks
    # three or more heads, and at S <= 112 a head has fewer query tiles than
    # a block has warps
    for s in (1, 16, 33, 48, 100):
        q, k, v = (randn(40, 12, s, 64) for _ in range(3))
        p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) / 8.0, dim=-1)
        err = bf16_attention_check(torch, vit_attention(q, k, v), vit_attention_plain(q, k, v),
                                   torch.matmul(p, v.float().abs()),
                                   f"vit_attention_bf16 40 x 12 heads S={s}")
        results["vit_attention_bf16"]["max_abs_err"] = max(
            results["vit_attention_bf16"]["max_abs_err"], err)
        print(f"  {'vit_attention_bf16':16s} {f'B=40 crops H=12 S={s} D=64':44s} "
              f"max_abs_err={err!r}")
        del q, k, v, p


def bf16_forward_plain(torch):
    """A context in which the bf16 detector's attention runs its plain bf16
    version (with kernel D-bf16's key split) instead of kernel D-bf16."""
    from coda_neurips2023_tpu_torch.models import transformer
    from coda_neurips2023_tpu_torch.ops import masked_attention as ma
    from coda_neurips2023_tpu_torch.utils.device import multi_processor_count

    kernel = transformer.masked_attention

    def plain(q, k, v, qxyz, kxyz_t, radius, compute_dtype, dropout=0.0, seed=None):
        b, h, sq, d = q.shape
        skv = v.shape[2]
        splits, chunk = ma.attention_splits(b, h, sq, skv, d, multi_processor_count(q.device),
                                            bf16=True)
        if splits > 1:
            return ma.masked_attention_split_plain(q, k, v, qxyz, kxyz_t, radius, chunk,
                                                   compute_dtype, dropout, seed)
        return ma.masked_attention_plain(q, k, v, qxyz, kxyz_t, radius, compute_dtype,
                                         dropout, seed)

    @contextlib.contextmanager
    def ctx():
        transformer.masked_attention = plain
        try:
            yield
        finally:
            transformer.masked_attention = kernel

    return ctx()


# outputs that follow the angle class: a row whose class differs jumps by a bin
ANGLE_KEYS = ("angle_continuous", "box_corners", "box_corners_xyz")


def compare_bf16_outputs(torch, got, want, what):
    """Float outputs within BF16_MODEL_TOL of each output's largest
    magnitude (BF16_SEM_LOGITS_TOL for sem_cls_logits), those of ANGLE_KEYS
    on the rows whose angle classes agree (at least 95% of them); returns
    the worst share of that magnitude."""
    same_bin = got["angle_logits"].argmax(-1) == want["angle_logits"].argmax(-1)
    share_same = same_bin.float().mean().item()
    print(f"  {what}: angle classes differ on {int((~same_bin).sum())} of {same_bin.numel()} rows")
    if share_same < 0.95:
        fail(f"{what}: angle classes agree on only {share_same!r} of the rows")
    worst = (0.0, "")
    for key, w in want.items():
        if not w.is_floating_point():
            continue
        g = got[key]
        if key in ANGLE_KEYS:
            g, w = g[same_bin], w[same_bin]
        scale = w.abs().max().item()
        share = (g.float() - w.float()).abs().max().item() / max(scale, 1e-30)
        tol = BF16_SEM_LOGITS_TOL if key == "sem_cls_logits" else BF16_MODEL_TOL
        if not share <= tol:
            fail(f"{what}: {key} differs by {share!r} of its largest magnitude > {tol}")
        worst = max(worst, (share, key))
    print(f"  {what}: worst {worst[1]} at {worst[0]!r} of its largest magnitude")
    return worst


def bf16_detector_phase(torch, cfg, batch, text, ckpt):
    """Phase 18 (b): the bf16 flagship detector's eval step at B=32 x 20000
    from phase 4's weights."""
    from coda_neurips2023_tpu_torch import _kernels
    from coda_neurips2023_tpu_torch.engine import make_eval_step
    from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR

    print(f"phase 18 (b): the bf16 detector (--compute_dtype bf16) eval step, {BATCH} x "
          f"{NUM_POINTS} points, phase 4's weights")
    state = torch.load(ckpt, map_location="cuda")["model"]
    model32 = CoDA3DETR(cfg, device="cuda")
    model32.load_state_dict(state)
    model16 = CoDA3DETR(cfg, device="cuda", compute_dtype=torch.bfloat16)
    model16.load_state_dict(state)
    model32.eval(), model16.eval()
    step = make_eval_step(model16, eval_text_features=text, eval_logit_scale=100.0)
    t0 = time.perf_counter()
    step(batch)  # warm-up
    torch.cuda.synchronize()
    print(f"  warm-up step {(time.perf_counter() - t0) * 1e3!r} ms")
    _kernels.reset_launches()
    times, outs = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        outs.append(step(batch))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_kernels.LAUNCHES)
    check_eval_outputs(torch, outs, model16.nqueries, "bf16 eval", zero_rows=False)
    print(f"  launches in the {STEPS} timed steps: {launches}")
    for name in ("fps", "ball_query", "gather", "attention_bf16"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the bf16 detector's eval path")
    others = {k: v for k, v in launches.items()
              if k not in ("fps", "ball_query", "gather", "attention_bf16") and v}
    if others:
        fail(f"kernels off the bf16 eval path launched: {others}")
    # D-bf16 in the 3 encoder layers' self-attention and the 8 decoder layers'
    # cross-attention, and its combine where the policy splits the keys
    from coda_neurips2023_tpu_torch.ops.masked_attention import attention_splits
    from coda_neurips2023_tpu_torch.utils.device import multi_processor_count

    a, sms = FLAGSHIP_ARGS, multi_processor_count(batch["point_clouds"].device)
    npts = a["preenc_npoints"]
    per_call = [1 + (attention_splits(BATCH, heads, sq, npts, dim // heads, sms, bf16=True)[0] > 1)
                for sq, dim, heads in ((npts, a["enc_dim"], a["enc_nhead"]),
                                       (a["nqueries"], a["dec_dim"], a["dec_nhead"]))]
    want = STEPS * (a["enc_nlayers"] * per_call[0] + a["dec_nlayers"] * per_call[1])
    if launches["attention_bf16"] != want:
        fail(f"attention_bf16 launched {launches['attention_bf16']} times in {STEPS} steps, "
             f"its split policy says {want}")
    med = statistics.median(times)
    print(f"  bf16 eval step ms: median {med!r} min {min(times)!r} max {max(times)!r}; "
          f"scenes/s (median step): {BATCH / med * 1e3!r}")
    with torch.inference_mode():
        got = model16(batch)
        fp32 = model32(batch)
        with bf16_forward_plain(torch):
            _kernels.reset_launches()
            plain = model16(batch)
            if _kernels.LAUNCHES["attention_bf16"]:
                fail("the plain bf16 forward launched kernel D-bf16")
    for key in ("enc_inds", "query_xyz", "enc_xyz"):
        if not torch.equal(got[key], fp32[key]):
            fail(f"bf16 eval: {key} differs from the fp32 step's")
    print("  enc_inds, enc_xyz, query_xyz equal to the fp32 step's")
    compare_bf16_outputs(torch, got, plain, "bf16 vs its plain bf16 path on the card")
    same_bin = got["angle_logits"].argmax(-1) == fp32["angle_logits"].argmax(-1)
    dist = {k: ((got[k] if k not in ANGLE_KEYS else got[k][same_bin]).float()
                - (fp32[k] if k not in ANGLE_KEYS else fp32[k][same_bin])).abs().max().item()
            / fp32[k].abs().max().item() for k in fp32 if fp32[k].is_floating_point()}
    worst = max((v, k) for k, v in dist.items())
    print(f"  bf16 vs fp32 (phase 4's model): angle classes differ on "
          f"{int((~same_bin).sum())} of {same_bin.numel()} rows; worst {worst[1]} at "
          f"{worst[0]!r} of its largest magnitude; {dist}")
    return launches


def bf16_clip_phase(torch, cfg, batch):
    """Phase 18 (c): the CLIP-crop eval step and one stage-1 step with the
    bf16 tower (--clip_dtype bf16), at phases 6 and 10's shapes."""
    from coda_neurips2023_tpu_torch import _kernels
    from coda_neurips2023_tpu_torch.datasets.config import SunrgbdImageConfig
    from coda_neurips2023_tpu_torch.models import build_model
    from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
    from coda_neurips2023_tpu_torch.stages import StageContext

    print(f"phase 18 (c): --clip_dtype bf16: the CLIP-crop eval step ({BATCH} scenes) and one "
          f"stage-1 step ({TRAIN_BATCH} scenes, {N_SEL} crops a scene)")
    towers = {}
    for dtype in ("float32", "bf16"):
        towers[dtype] = StageContext(
            types.SimpleNamespace(**CLIP_ARGS, clip_dtype=dtype), SunrgbdImageConfig(),
            device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    ctx = towers["bf16"]
    if ctx.clip_model.dtype != torch.bfloat16:
        fail(f"--clip_dtype bf16: the tower is {ctx.clip_model.dtype}")
    bank_err = (ctx.text_banks["test"] - towers["float32"].text_banks["test"]).abs().max().item()
    print(f"  text bank of the bf16 tower vs the fp32 tower's: max_abs_err {bank_err!r}")
    args = types.SimpleNamespace(**FLAGSHIP_ARGS, **CLIP_ARGS)
    detector, _ = build_model(args, cfg, device="cuda")
    detector = reset_parameters(detector, torch.Generator(device="cuda").manual_seed(SEED + 2))
    detector.eval()
    step = ctx.make_clip_eval_step(detector)
    step(batch)  # warm-up
    torch.cuda.synchronize()
    _kernels.reset_launches()
    times, outs = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        outs.append(step(batch))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_kernels.LAUNCHES)
    nq = detector.nqueries
    check_eval_outputs(torch, outs, nq, "bf16-tower CLIP eval", zero_rows=True)
    print(f"  launches in the {STEPS} timed steps: {launches}")
    if launches["vit_attention_bf16"] != STEPS * BATCH * CLIP_LAYERS or launches["vit_attention"]:
        fail(f"vit_attention_bf16 launched {launches['vit_attention_bf16']} times (expected "
             f"{STEPS * BATCH * CLIP_LAYERS}), vit_attention {launches['vit_attention']}")
    med = statistics.median(times)
    print(f"  CLIP eval step ms: median {med!r} min {min(times)!r} max {max(times)!r}; "
          f"crops/s: {BATCH * nq / med * 1e3!r}")
    want = towers["float32"].make_clip_eval_step(detector)(batch)["sem_cls_prob"]
    dist = (outs[0]["sem_cls_prob"] - want).abs().max().item()
    print(f"  sem_cls_prob, bf16 tower vs fp32 tower (same weights, same crops): "
          f"max_abs_err {dist!r}")
    del towers["float32"], want, outs

    train = {k: v[:TRAIN_BATCH] for k, v in batch.items()}
    flags = types.SimpleNamespace(**STAGE1_ARGS, clip_dtype="bf16")
    ctx1 = StageContext(flags, cfg, device=DEVICE,
                        generator=torch.Generator(device=DEVICE).manual_seed(SEED + 7))
    model, criterion, optimizer, schedule = train_objects(torch, cfg, True, DEVICE, SEED + 8,
                                                          STAGE1_ARGS)
    step1 = ctx1.make_fused_train_step(model, criterion, optimizer, lr_schedule=schedule)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    step1(train, gen)  # warm-up
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    metrics = step1(train, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    STEP_TIMES["phase 18 (c)"] = dict(median=ms, peak_gb=None)
    launches1 = dict(_kernels.LAUNCHES)
    loss, l1 = float(metrics["loss"]), float(metrics["loss_predicted_region_embed_l1"])
    print(f"  stage-1 step: loss {loss!r}, loss_predicted_region_embed_l1 {l1!r}, {ms!r} ms, "
          f"crops/s {TRAIN_BATCH * N_SEL / ms * 1e3!r}; launches {launches1}")
    if not (math.isfinite(loss) and l1 > 0):
        fail(f"stage-1 step with the bf16 tower: loss {loss}, distillation {l1}")
    if launches1["vit_attention_bf16"] != CLIP_LAYERS or launches1["vit_attention"]:
        fail(f"stage-1 step: vit_attention_bf16 launched {launches1['vit_attention_bf16']} "
             f"times, expected {CLIP_LAYERS}")
    for name in ("fps", "ball_query", "gather", "attention"):
        if launches1[name] <= 0:
            fail(f"kernel {name} was not launched on the bf16-tower stage-1 step")
    return launches, launches1


def bf16_cli_phase(torch, ckpt):
    """Phase 18 (d): `main --test_only --compute_dtype bf16` on phase 13's
    data and weights."""
    from coda_neurips2023_tpu_torch import _kernels

    scans = CLI_SCENES // 4
    out_dir = _kernels.BUILD_DIR.parent / "phase13"
    argv = CLI_ARGS + ["--synthetic_num_scenes", str(CLI_SCENES), "--test_ckpt", str(ckpt),
                       "--compute_dtype", "bf16", "--log_file", str(out_dir / "eval_bf16.lst")]
    print(f"phase 18 (d): main --test_only --compute_dtype bf16 on phase 13's {scans} scenes")
    metrics, launches, stats, meter, seconds = cli_run(torch, argv, CLI_WORKERS[0])
    check_cli_metrics(metrics, scans, stats, meter, "bf16 CLI")
    print(f"    launches: {launches}")
    for name in ("fps", "ball_query", "gather", "attention_bf16"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the bf16 CLI path")
    if launches["attention"]:
        fail("kernel D (fp32) launched on the bf16 CLI path")
    report_loop(stats, meter, seconds, CLI_WORKERS[0])
    os.environ.pop("CODA_AP_WORKERS", None)
    return launches


def bf16_phase(torch, cfg, ckpt, results):
    """Phase 18: the bf16 paths; returns each bf16 kernel's launches on its
    path (D-bf16: (b)'s timed steps, E-bf16: (c)'s CLIP eval steps) and on
    the CLI."""
    from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset, make_batch
    from coda_neurips2023_tpu_torch.stages import StageContext

    t0 = time.perf_counter()
    ds = SyntheticDetectionDataset(cfg, num_scenes=BATCH, num_points=NUM_POINTS, seed=SEED,
                                   with_images=True, image_hw=IMAGE_HW)
    batch = {k: torch.from_numpy(v).cuda() for k, v in make_batch(ds, 0, BATCH).items()}
    print("phase 18 (a): kernels D-bf16 and E-bf16 vs their plain bf16 versions")
    with torch.inference_mode():
        bf16_kernel_phase(torch, batch["point_clouds"][:, :2048, :3].contiguous(), results)
    from coda_neurips2023_tpu_torch.datasets.config import SunrgbdImageConfig

    ctx = StageContext(types.SimpleNamespace(**CLIP_ARGS), SunrgbdImageConfig(), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    text = ctx.text_banks["test"]
    del ctx
    launches_b = bf16_detector_phase(torch, cfg, batch, text, ckpt)
    launches_c, launches_stage1 = bf16_clip_phase(torch, cfg, batch)
    del batch
    launches_d = bf16_cli_phase(torch, ckpt)
    print(f"phase 18 took {time.perf_counter() - t0:.1f} s")
    return {
        "attention_bf16": dict(launches=launches_b["attention_bf16"],
                               cli_launches=launches_d["attention_bf16"]),
        "vit_attention_bf16": dict(launches=launches_c["vit_attention_bf16"],
                                   stage1_launches=launches_stage1["vit_attention_bf16"]),
    }


# phase 19: the radius-masked encoder (--enc_type masked), point features
# and the sine embedding on the card
MASKED_TRAIN_STEPS = 2


def masked_attention_launches(torch, bf16_decoder=False):
    """Kernel D's launches an eval step of the masked flagship: the three
    encoder layers over 2048, 1024 and 1024 tokens (D = 64), the eight
    decoder layers' cross-attention over 1024 keys (D = 128), each with a
    combine where `attention_splits` splits the keys.  Returns (D's
    launches, D-bf16's): with `bf16_decoder` (--compute_dtype bf16) the
    decoder's go to D-bf16."""
    from coda_neurips2023_tpu_torch.ops.masked_attention import attention_splits
    from coda_neurips2023_tpu_torch.utils.device import multi_processor_count

    sm = multi_processor_count(torch.device(DEVICE))

    def calls(sq, skv, d, bf16=False):
        return 1 + (attention_splits(BATCH, 4, sq, skv, d, sm, bf16)[0] > 1)

    enc = calls(2048, 2048, 64) + 2 * calls(1024, 1024, 64)
    dec = 8 * calls(128, 1024, 128, bf16_decoder)
    return (enc, dec) if bf16_decoder else (enc + dec, 0)


def radius_mask(torch, xyz, radius):
    """(B, S, S) bool: the keys kernel D's radius mode allows, decided as it
    and its plain version decide them (elementwise, in the kernel's order:
    sqrt(max(|q|^2 + |k|^2 - 2 q.k, 0)) < radius), so a library call given
    this mask computes the same function."""
    q = [xyz[:, :, i, None] for i in range(3)]
    k = [xyz[:, None, :, i] for i in range(3)]
    cross = (q[0] * k[0] + q[1] * k[1]) + q[2] * k[2]
    sq_q = (q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]
    sq_k = (k[0] * k[0] + k[1] * k[1]) + k[2] * k[2]
    return torch.sqrt(torch.clamp((sq_q + sq_k) - 2.0 * cross, min=0.0)) < radius


def masked_attention_bound(torch, b, h, s, d, mask):
    """The least ms kernel D's radius mode needs on these points: the
    distance test of every pair (BQ_OPS at the fp32 peak), and QK, PV (3xTF32
    on the tensor cores) and the softmax only for the allowed pairs of
    `mask` (the data decides how many), against q, k, v and the output read
    or written once with the coordinates.  Returns (bound, allowed share)."""
    allowed = int(mask.sum())
    pairs = b * s * s
    nbytes = 4 * b * h * 4 * s * d + 24 * b * s
    return bound(BQ_OPS * pairs + 5 * h * allowed, nbytes, tc_flops=4 * d * h * allowed), \
        allowed / pairs


def masked_kernel_rows(torch, model, batch, results):
    """Phase 19 (a), second part: kernels D, B and C against their plain
    versions at the masked path's own shapes and points, with kernel, plain,
    bound and library ms, written into `results` beside each kernel's main
    row."""
    from coda_neurips2023_tpu_torch.models.transformer import MASKING_RADIUS
    from coda_neurips2023_tpu_torch.ops import grouping, sampling
    from coda_neurips2023_tpu_torch.ops.masked_attention import (
        masked_attention,
        masked_attention_plain,
    )

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 40)
    xyz = batch["point_clouds"][..., :3].contiguous()
    b = xyz.shape[0]
    with torch.inference_mode():
        pre_xyz, pre_feat, _ = model.pre_encoder(xyz)
        feats = model.encoder.layers[0](pre_feat, xyz=pre_xyz, radius=MASKING_RADIUS[0])
        half = sampling.gather_points(pre_xyz, sampling.furthest_point_sample(pre_xyz, 1024))

    def row(name, label, err, ms, plain_ms, bnd, library_ms, key):
        results[name].update({f"{key}_ms": ms, f"{key}_plain_ms": plain_ms,
                              f"{key}_bound_ms": bnd[0], f"{key}_bound_by": bnd[1],
                              f"{key}_library_ms": library_ms})
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        lib = f" library_ms={library_ms!r}" if library_ms is not None else ""
        print(f"  {name:16s} {label:44s} max_abs_err={err!r} kernel_ms={ms!r} "
              f"plain_ms={plain_ms!r} bound_ms={bnd[0]!r} ({bnd[1]}){lib}")

    # D's radius mode at the encoder's three layers, the library fp32 SDPA
    # with a boolean mask made outside the timed window
    for radius, pts, key in zip(MASKING_RADIUS, (pre_xyz, half, half),
                                ("masked_enc0", "masked_enc1", "masked_enc2")):
        s = pts.shape[1]
        q = torch.randn((b, 4, s, 64), device=DEVICE, generator=gen) / 8.0
        k = torch.randn((b, 4, 64, s), device=DEVICE, generator=gen)
        v = torch.randn((b, 4, s, 64), device=DEVICE, generator=gen)
        kxyz_t = pts.transpose(1, 2).contiguous()
        kern = lambda: masked_attention(q, k, v, pts, kxyz_t, radius)
        plain = lambda: masked_attention_plain(q, k, v, pts, kxyz_t, radius)
        want = plain()
        err = (kern() - want).abs().max().item()
        if not err <= ATTN_TOL:
            fail(f"attention S={s} r^2={radius!r}: max_abs_err {err!r} > {ATTN_TOL}")
        mask = radius_mask(torch, pts, radius)[:, None]
        kt = k.transpose(2, 3).contiguous()
        library = lambda: sdpa(q, kt, v, attn_mask=mask, scale=1.0)
        lib_err = (library() - want).abs().max().item()
        if not lib_err <= ATTN_TOL:
            fail(f"fp32 SDPA with the mask differs from the plain radius attention by {lib_err!r}")
        ms, library_ms = time_in_turns(torch, kern, library)
        bnd, share = masked_attention_bound(torch, b, 4, s, 64, mask)
        del mask
        row("attention", f"radius S={s} H=4 D=64 r^2={radius:.2f} (allowed {share:.4f})", err,
            ms, time_ms(torch, plain), bnd, library_ms, key)
    # D at the decoder's cross-attention over the 1,024 tokens left
    q = torch.randn((b, 4, 128, 128), device=DEVICE, generator=gen) / 128 ** 0.5
    k = torch.randn((b, 4, 128, 1024), device=DEVICE, generator=gen)
    v = torch.randn((b, 4, 1024, 128), device=DEVICE, generator=gen)
    kern = lambda: masked_attention(q, k, v)
    plain = lambda: masked_attention_plain(q, k, v, None, None, 0.0)
    err = (kern() - plain()).abs().max().item()
    if not err <= ATTN_TOL:
        fail(f"attention decoder over 1024 keys: max_abs_err {err!r} > {ATTN_TOL}")
    kt = k.transpose(2, 3).contiguous()
    ms, library_ms = time_in_turns(torch, kern, lambda: sdpa(q, kt, v, scale=1.0))
    row("attention", "decoder Sq=128 Skv=1024 H=4 D=128", err, ms, time_ms(torch, plain),
        attention_bound(b, 4, 128, 1024, 128), library_ms, "masked_dec")
    del q, k, v, kt
    # B at the interim SA's 32 x 1024 centres over 2048 points, bit for bit
    kern = lambda: grouping.ball_query(0.4, 32, pre_xyz, half)
    plain = lambda: grouping.ball_query_plain(0.4, 32, pre_xyz, half)
    idx = kern()
    if not torch.equal(idx, plain()):
        fail("ball_query at the interim SA's shape differs from its plain version")
    bnd, scan_bnd = ball_query_bound(torch, 0.4, 32, pre_xyz, half)
    row("ball_query", f"interim B={b} N=2048 M=1024 r=0.4 k=32", 0.0, time_ms(torch, kern),
        time_ms(torch, plain), bnd, None, "interim")
    print(f"  {'':16s} {'':44s} scan bound_ms={scan_bnd[0]!r}")
    # C on the interim SA's 256-d features, against torch.gather
    c = feats.shape[-1]
    kern = lambda: grouping.group_points(feats, idx)
    plain = lambda: grouping.group_points_plain(feats, idx)
    flat = idx.reshape(b, -1, 1).long().expand(-1, -1, c)
    got = kern()
    if not torch.equal(got, plain()):
        fail(f"gather of the interim SA's {c}-d features differs from its plain version")
    ms, library_ms = time_in_turns(torch, kern, lambda: torch.gather(feats, 1, flat))
    nbytes = 4 * (feats.numel() + idx.numel() + got.numel())
    row("gather", f"features B={b} N=2048 M=1024 K=32 C={c}", 0.0, ms, time_ms(torch, plain),
        bound(0, nbytes), library_ms, f"interim_c{c}")
    # the concat after C in query_and_group (grouping.py), at its shapes
    grouped_xyz = grouping.group_points_plain(pre_xyz, idx) - half[:, :, None, :]
    cat_ms = time_ms(torch, lambda: torch.cat([grouped_xyz, got], dim=-1))
    results["gather"][f"interim_c{c}_cat_ms"] = cat_ms
    print(f"  {'':16s} {'':44s} output {got.numel() * 4 / 1e9!r} GB; the torch.cat after it "
          f"(B, 1024, 32, 3 + {c}) ms={cat_ms!r}")


def masked_eval_phase(torch, cfg, text, results):
    """Phase 19 (a) and (b): the masked flagship's eval step on the card,
    its kernels at its shapes, then the same weights on the CPU."""
    from coda_neurips2023_tpu_torch import _kernels
    from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset, make_batch
    from coda_neurips2023_tpu_torch.engine import make_eval_step
    from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
    from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
    from coda_neurips2023_tpu_torch.ops.grouping import GRID_LAUNCHES

    print(f"phase 19 (a): the masked flagship (--enc_type masked) eval step, {STEPS} batches of "
          f"{BATCH} x {NUM_POINTS} points")
    ds = SyntheticDetectionDataset(cfg, num_scenes=STEPS * BATCH, num_points=NUM_POINTS, seed=SEED)
    batches = [{k: torch.from_numpy(v).to(DEVICE) for k, v in make_batch(ds, i * BATCH, BATCH).items()
                if k in ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")}
               for i in range(STEPS)]
    model = CoDA3DETR(cfg, enc_type="masked", device=DEVICE)
    reset_parameters(model, torch.Generator(device=DEVICE).manual_seed(SEED + 30)).eval()
    if model.encoder.interim_downsampling.npoint != 1024:
        fail("the masked encoder's interim SA does not keep 1024 points")
    step = make_eval_step(model, eval_text_features=text, eval_logit_scale=100.0)
    step(batches[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    times, outs = [], []
    for batch in batches:
        t0 = time.perf_counter()
        outs.append(step(batch))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_eval_outputs(torch, outs, model.nqueries, "masked eval", zero_rows=False)
    with torch.inference_mode():
        full = model(batches[0])
    if tuple(full["enc_inds"].shape) != (BATCH, 1024) or tuple(full["enc_xyz"].shape) != (
            BATCH, 1024, 3):
        fail(f"enc_inds {tuple(full['enc_inds'].shape)} / enc_xyz {tuple(full['enc_xyz'].shape)}")
    inds = full["enc_inds"].long()
    if not (0 <= inds.min() and inds.max() < NUM_POINTS):
        fail("enc_inds outside the 20000 input points")
    picked = torch.gather(batches[0]["point_clouds"][..., :3], 1, inds[..., None].expand(-1, -1, 3))
    if not torch.equal(picked, full["enc_xyz"]):
        fail("enc_inds do not name the points of enc_xyz")
    attn, _ = masked_attention_launches(torch)
    want = {"fps": 3 * STEPS, "ball_query": 2 * GRID_LAUNCHES * STEPS, "gather": 6 * STEPS,
            "attention": attn * STEPS}
    print(f"  launches in the {STEPS} timed steps: {launches}")
    print(f"  expected: {want} (FPS 20000->2048, 2048->1024, 1024->128; two ball queries of "
          f"{GRID_LAUNCHES} launches; C for 2 + 3 gathers of the SAs and the queries; D in 3 "
          f"encoder and 8 decoder layers with their combines)")
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        fail(f"masked eval launches {got} != {want}")
    med = statistics.median(times)
    print(f"  masked eval step ms: median {med!r} min {min(times)!r} max {max(times)!r}")
    print(f"  scenes/s (median step): {BATCH / med * 1e3!r}; peak memory allocated: {peak_gb!r} GB")
    masked_kernel_rows(torch, model, batches[0], results)

    print("phase 19 (b): the same masked model on the CPU (plain PyTorch) on 2 scenes")
    small = {k: v[:2] for k, v in batches[0].items()}
    with torch.inference_mode():
        gpu = model(small)
        cpu_model = copy.deepcopy(model).to("cpu")
        cpu = cpu_model({k: v.cpu() for k, v in small.items()})
    compare_gpu_cpu(torch, gpu, cpu, "masked")
    return model, batches[0], launches


def compare_gpu_cpu(torch, gpu, cpu, what):
    """A detector's outputs on the card and on the CPU (phases 5 and 19):
    integer outputs and angle classes equal, floats within MODEL_TOL."""
    for key in ("enc_inds", "query_xyz", "enc_xyz"):
        if not torch.equal(gpu[key].cpu(), cpu[key]):
            fail(f"{what} {key}: GPU and CPU differ")
    if not torch.equal(gpu["angle_logits"].argmax(-1).cpu(), cpu["angle_logits"].argmax(-1)):
        fail(f"{what}: angle classes differ between GPU and CPU")
    worst = max(((gpu[k].cpu() - cpu[k]).abs().max().item(), k)
                for k in cpu if cpu[k].is_floating_point())
    print(f"  {what} GPU vs CPU: indices equal, worst float key {worst[1]} "
          f"max_abs_err={worst[0]!r}")
    if not worst[0] <= MODEL_TOL:
        fail(f"{what} GPU vs CPU: {worst[1]} differs by {worst[0]!r} > {MODEL_TOL}")


def masked_cli_phase(torch, model, batch, batch_launches):
    """Phase 19 (c): `main --test_only --enc_type masked --test_ckpt` on
    phase 13's scenes from (a)'s weights, then one batch with
    --compute_dtype bf16."""
    from coda_neurips2023_tpu_torch import _kernels, engine
    from coda_neurips2023_tpu_torch.engine import make_eval_step
    from coda_neurips2023_tpu_torch.models import build_model
    from coda_neurips2023_tpu_torch.ops.grouping import GRID_LAUNCHES

    scans = CLI_SCENES // 4
    out_dir = _kernels.BUILD_DIR.parent / "phase19"
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt = out_dir / "masked.pth"
    sd = model.state_dict()
    if not any(k.startswith("encoder.interim_downsampling.mlp_module.") for k in sd):
        fail("the masked state dict has no encoder.interim_downsampling.* entries")
    torch.save({"model": sd}, ckpt)
    print(f"phase 19 (c): main --test_only --enc_type masked --test_ckpt on {scans} synthetic "
          f"scenes (the .pth has {sum(k.startswith('encoder.interim_downsampling.') for k in sd)} "
          f"encoder.interim_downsampling.* entries)")
    argv = CLI_ARGS + ["--synthetic_num_scenes", str(CLI_SCENES), "--test_ckpt", str(ckpt),
                       "--enc_type", "masked", "--log_file", str(out_dir / "eval.lst")]
    steps = -(-scans // BATCH)
    with recording_eval_step(engine, {}) as store:
        metrics, launches, stats, meter, seconds = cli_run(torch, argv, CLI_WORKERS[0])
    check_cli_metrics(metrics, scans, stats, meter, "masked CLI")
    print(f"    launches: {launches}")
    want = {k: v // STEPS * steps for k, v in batch_launches.items() if v}
    if {k: v for k, v in launches.items() if v} != want:
        fail(f"masked CLI launches {launches}, expected {want}")
    first_batch, got = store["first"]
    ref = make_eval_step(model, eval_text_features=store["bank"], eval_logit_scale=100.0)(
        first_batch)
    err = max((got[k] - ref[k]).abs().max().item() for k in ref)
    print(f"    first batch vs (a)'s eval step (its model, the CLI's bank): max_abs_err={err!r}")
    if not err <= MXU_TOL:
        fail(f"the masked CLI's first batch differs from (a)'s eval step by {err!r} > {MXU_TOL}")
    report_loop(stats, meter, seconds, CLI_WORKERS[0])

    os.environ.pop("CODA_AP_WORKERS", None)
    cli_launches = dict(launches)

    # --compute_dtype bf16 from the same weights, one batch through the
    # build_model and eval step that main takes (tests/test_torch_port_masked.py runs
    # the flag through main on the CPU)
    print("  --enc_type masked --compute_dtype bf16, one batch of (a)'s scenes through "
          "build_model and make_eval_step")
    args = types.SimpleNamespace(**{**FLAGSHIP_ARGS, "enc_type": "masked", "compute_dtype": "bf16",
                                    "model_name": "3detr_predictedbox_distillation"})
    bf16_model, _ = build_model(args, model.dataset_config, device=DEVICE)
    bf16_model.load_state_dict(model.state_dict(), strict=True)
    bf16_model.eval()
    if any(m.dtype != torch.float32 for m in bf16_model.encoder.modules()
           if hasattr(m, "dtype") and isinstance(m.dtype, torch.dtype)):
        fail("the masked encoder is not fp32 under --compute_dtype bf16")
    step = make_eval_step(bf16_model, eval_text_features=store["bank"], eval_logit_scale=100.0)
    step(batch)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    out = step(batch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    check_eval_outputs(torch, [out], bf16_model.nqueries, "masked bf16 eval", zero_rows=False)
    enc, dec = masked_attention_launches(torch, bf16_decoder=True)
    want = {"fps": 3, "ball_query": 2 * GRID_LAUNCHES, "gather": 6, "attention": enc,
            "attention_bf16": dec}
    print(f"    launches: {launches}; expected {want} (fp32 D with the radius in the "
          f"encoder, D-bf16 in the decoder)")
    if launches != want:
        fail(f"masked bf16 eval launches {launches}, expected {want}")
    with torch.inference_mode():
        got, ref = bf16_model(batch), model(batch)
    for key in ("enc_inds", "enc_xyz", "query_xyz"):
        if not torch.equal(got[key], ref[key]):
            fail(f"masked bf16 {key} differs from the fp32 model's")
    print(f"    enc_inds, enc_xyz and query_xyz equal to the fp32 model's; box_corners "
          f"max |bf16 - fp32| {(got['box_corners'] - ref['box_corners']).abs().max().item()!r}")
    return cli_launches


def masked_train_phase(torch, cfg):
    """Phase 19 (d): the stage-1 training step with --enc_type masked, then
    at dropout 0 with and without --remat, then GPU vs CPU."""
    from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset, make_batch

    ds = SyntheticDetectionDataset(cfg, num_scenes=(MASKED_TRAIN_STEPS + 1) * TRAIN_BATCH,
                                   num_points=NUM_POINTS, seed=SEED + 3, with_images=True,
                                   image_hw=IMAGE_HW)
    batches = [{k: torch.from_numpy(v).to(DEVICE)
                for k, v in make_batch(ds, i * TRAIN_BATCH, TRAIN_BATCH).items()}
               for i in range(MASKED_TRAIN_STEPS + 1)]
    flags = types.SimpleNamespace(**{**FLAGSHIP_ARGS, **TRAIN_ARGS, **STAGE1_ARGS,
                                     "enc_type": "masked", "remat": False})
    with bq_env(CODA_BQ_ALGO="adaptive"):
        launches, ctx = stage1_phase(
            torch, cfg, batches, stage_args=flags, steps=MASKED_TRAIN_STEPS, sa_calls=2,
            title=(f"phase 19 (d): the stage-1 training step with --enc_type masked, "
                   f"{MASKED_TRAIN_STEPS} steps of {TRAIN_BATCH} x {NUM_POINTS} points, "
                   f"CODA_BQ_ALGO=adaptive"))
        print("  the same step at dropout 0 from the same weights, without and with --remat")

        def one_step(remat, batch):
            args = copy.copy(flags)
            args.remat = remat
            model, criterion, optimizer, schedule = train_objects(torch, cfg, False, DEVICE,
                                                                  SEED + 31, args)
            step = ctx.make_fused_train_step(model, criterion, optimizer, lr_schedule=schedule)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            metrics = step(batch, torch.Generator(device=DEVICE).manual_seed(SEED + 32))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            return (float(metrics["loss"]),
                    {n: p.grad.detach().clone() for n, p in model.named_parameters()},
                    torch.cuda.max_memory_allocated() / 1e9, ms)

        one_step(True, batches[1])  # warm-up: checkpoint's first call imports its machinery
        runs = {}
        for remat in (False, True):
            runs[remat] = one_step(remat, batches[0])
            print(f"    remat={remat}: loss {runs[remat][0]!r}, step {runs[remat][3]!r} ms, "
                  f"peak memory allocated {runs[remat][2]!r} GB")
        (la, ga, _, _), (lb, gb, _, _) = runs[False], runs[True]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in ga.values())).item()
        worst = max(((ga[n] - gb[n]).abs().max().item() / norm, n) for n in ga)
        print(f"    --remat vs not: loss |diff| {abs(la - lb)!r}; gradient max |diff| / global "
              f"norm {worst[0]!r} ({worst[1]}) (C's backward adds with atomics)")
        if not abs(la - lb) <= STEP_TOL or not worst[0] <= GRAD_TOL:
            fail(f"--remat changed the masked step: loss {abs(la - lb)!r}, gradient {worst[0]!r}")
        stage1_cpu_phase(torch, cfg, ctx, batches[0], stage_args=flags,
                         title="  the masked stage-1 step on 2 scenes, GPU vs CPU, dropout 0")
    return launches


def color_sine_phase(torch, cfg, batch, text):
    """Phase 19 (e): --use_color and --pos_embed sine on the vanilla
    flagship, one eval batch of 6-channel scenes, then GPU vs CPU."""
    from coda_neurips2023_tpu_torch import _kernels
    from coda_neurips2023_tpu_torch.engine import make_eval_step
    from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
    from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
    from coda_neurips2023_tpu_torch.ops.grouping import GRID_LAUNCHES

    print("phase 19 (e): --use_color --pos_embed sine on the vanilla flagship, one batch of "
          f"{BATCH} x {NUM_POINTS} points with colours")
    rgb = torch.rand(batch["point_clouds"].shape, device=DEVICE,
                     generator=torch.Generator(device=DEVICE).manual_seed(SEED + 33))
    batch = dict(batch, point_clouds=torch.cat([batch["point_clouds"], rgb], -1))
    model = CoDA3DETR(cfg, use_color=True, position_embedding="sine", device=DEVICE)
    reset_parameters(model, torch.Generator(device=DEVICE).manual_seed(SEED + 34)).eval()
    if "pos_embedding.gauss_B" in model.state_dict():
        fail("the sine embedding has a gauss_B")
    step = make_eval_step(model, eval_text_features=text, eval_logit_scale=100.0)
    step(batch)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    out = step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    check_eval_outputs(torch, [out], model.nqueries, "colour + sine eval", zero_rows=False)
    want = {"fps": 2, "ball_query": GRID_LAUNCHES, "gather": 4}
    print(f"  launches: {launches}; step {ms!r} ms (C gathers the centres, the grouped xyz, the "
          f"grouped colours and the queries)")
    if {k: launches.get(k, 0) for k in want} != want or launches.get("attention", 0) <= 0:
        fail(f"colour + sine launches {launches}, expected {want} and D")
    small = {k: v[:2] for k, v in batch.items()}
    with torch.inference_mode():
        gpu = model(small)
        cpu = copy.deepcopy(model).to("cpu")({k: v.cpu() for k, v in small.items()})
    compare_gpu_cpu(torch, gpu, cpu, "colour + sine")


def masked_phase(torch, cfg, text, results):
    """Phase 19; returns each kernel's launches on the masked paths."""
    t0 = time.perf_counter()
    marks = []
    model, batch, launches = masked_eval_phase(torch, cfg, text, results)
    marks.append(("(a) and (b)", time.perf_counter()))
    cli_launches = masked_cli_phase(torch, model, batch, launches)
    marks.append(("(c)", time.perf_counter()))
    del model
    train_launches = masked_train_phase(torch, cfg)
    marks.append(("(d)", time.perf_counter()))
    color_sine_phase(torch, cfg, batch, text)
    marks.append(("(e)", time.perf_counter()))
    parts = ", ".join(f"{name} {end - start:.1f} s"
                      for (name, end), start in zip(marks, [t0] + [m[1] for m in marks]))
    print(f"phase 19 took {time.perf_counter() - t0:.1f} s: {parts}")
    return launches, cli_launches, train_launches


# phase 20: the bf16 detector's training (--compute_dtype bf16): kernel
# D-bf16 with its attention-weight dropout, its backward, the bf16 steps
BF16_DROPOUT = 0.1  # --enc_dropout / --dec_dropout as the scripts ship them
# (b): the bf16 backward against the fp32 backward on the card, each
# gradient's largest error over the fp32 gradient's largest magnitude: p and
# its cotangent rounded to bf16 in the recompute (2^-9 relative), each
# gradient a sum over 2048 keys or queries rounded to bf16 once, and the two
# dropout multipliers 1.109375 and 1 / 0.9 (0.16% apart); the plain versions
# on the CPU measure 3.6e-3 to 4.0e-3 at this shape (one scene)
BF16_BACKWARD_TOL = 1.5e-2
# (d): one bf16 step GPU vs CPU.  cuBLAS and the CPU sum each bf16 product in
# their own orders, so a product lands a bf16 ulp apart now and then and
# moves what follows (tests/test_torch_port_bf16_train.py measures the
# port's bf16 step against the JAX package's: the loss 7.5e-4 of its size,
# the gradients' largest element 2.1e-2 of their norm, the difference's
# norm 0.29 of theirs, and the port's bf16 step against its fp32 step 0.32:
# BatchNorm's training backward cancels most of each term, so bf16's
# rounding of the terms is a large share of what is left).  The loss within
# BF16_STEP_RTOL of its size, the largest gradient element within
# BF16_GRAD_RTOL of the norm, the difference's norm within BF16_GRAD_NORM_RTOL
# (the CPU test's bound); where the two matchers' costs tie within
# BF16_TIE_COST (a scene's cost sums up to 64 matched pairs of terms
# weighted up to 5, each carrying bf16's 2^-9) the CPU takes the GPU's
# assignments, and the rows concerned are printed
BF16_STEP_RTOL = 5e-3
BF16_GRAD_RTOL = 5e-2
BF16_GRAD_NORM_RTOL = 0.4
BF16_TIE_COST = 0.5
# step ms and peak GB of the fp32 steps (phases 8 and 10) and of phase 18
# (c)'s bf16-tower step, for phase 20 (c)
STEP_TIMES = {}


def bf16_backward_bound(b, h, sq, skv, d):
    """The backward's products (the recomputed QK^T, then dV, dP, dQ, dK:
    10D flops a query-key pair) at the dense bf16 rate and its elementwise
    softmax work (5 a pair) at the fp32 peak; q, k, v and dO read and dq,
    dk, dv written once in bf16."""
    pairs = b * h * sq * skv
    ops_ms = (pairs * 10 * d / BF16_PEAK + pairs * 5 / FP32_PEAK) * 1e3
    bytes_ms = 2 * b * h * (4 * sq * d + 3 * skv * d) / HBM_RATE * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def wgmma_serialized(log_lines):
    """ptxas's notes that it serialized kernel D-bf16's wgmma (C7510-C7515)."""
    return [line.strip() for line in log_lines
            if "C751" in line and ("coda_d_bf16" in line or "attention_bf16" in line)]


def bf16_dropout_kernel_phase(torch, results):
    """Phase 20 (a): D-bf16 with dropout against its plain bf16 version, the
    same seed, at the bf16 training step's shapes and at key counts that are
    not a multiple of 8 (padded, split and not): values within phase 18
    (a)'s bound, and each pair's drop, read through a one-hot V (D keys a
    call: the output is each pair's dropped weight, or in a split that times
    its chunk's share), at the same places as the hash's; times beside SDPA
    with dropout_p."""
    from coda_neurips2023_tpu_torch import _kernels
    from coda_neurips2023_tpu_torch.ops import masked_attention as ma
    from coda_neurips2023_tpu_torch.utils.device import multi_processor_count

    serialized = wgmma_serialized((_kernels.BUILD_DIR / "build.log").read_text().splitlines())
    for line in serialized:
        print(f"  ptxas: {line}")
    if serialized:
        fail(f"ptxas serialized kernel D-bf16's wgmma ({len(serialized)} notes C7510-C7515)")
    print("  ptxas: no wgmma serialization note (C7510-C7515) for kernel D-bf16")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 200)
    bf16, b, h = torch.bfloat16, TRAIN_BATCH, 4
    seed = torch.randint(0, 2 ** 62, (), dtype=torch.int64, device=DEVICE, generator=gen)
    mult = ma.bf16_dropout_multiplier(BF16_DROPOUT)
    sms = multi_processor_count(torch.device(DEVICE))
    entry = results["attention_bf16"]
    cases = [
        (f"encoder B={b} S=2048 H=4 D=64", 2048, 2048, 64, "train_dropout"),
        (f"decoder B={b} Sq=128 Skv=2048 H=4 D=128", 128, 2048, 128, "train_dropout_decoder"),
        (f"B={b} Sq=300 Skv=1001 H=4 D=64", 300, 1001, 64, None),
        (f"B={b} Sq=128 Skv=1001 H=4 D=128", 128, 1001, 128, None),
    ]
    for label, sq, skv, d, key in cases:
        q = (torch.randn((b, h, sq, d), device=DEVICE, generator=gen) / d ** 0.5).to(bf16)
        k = torch.randn((b, h, d, skv), device=DEVICE, generator=gen).to(bf16)
        v = torch.randn((b, h, skv, d), device=DEVICE, generator=gen).to(bf16)
        splits, chunk = ma.attention_splits(b, h, sq, skv, d, sms, bf16=True)

        def kern(vv):
            return ma.masked_attention(q, k, vv, None, None, 0.0, "bfloat16", BF16_DROPOUT, seed)

        def plain(vv):
            if splits > 1:
                return ma.masked_attention_split_plain(q, k, vv, None, None, 0.0, chunk,
                                                       "bfloat16", BF16_DROPOUT, seed)
            return ma.masked_attention_plain(q, k, vv, None, None, 0.0, "bfloat16",
                                             BF16_DROPOUT, seed)

        p = torch.softmax(ma._bf16_scores(q, k, None, None, 0.0), dim=-1)
        err = bf16_attention_check(torch, kern(v), plain(v), torch.matmul(p * mult, v.float().abs()),
                                   f"attention_bf16 dropout {label}")
        del p
        keep = ma.attention_keep_mask(seed, sq, skv, BF16_DROPOUT)
        wrong = 0
        for j0 in range(0, skv, d):
            n = min(d, skv - j0)
            probe = torch.zeros((b, h, skv, d), dtype=bf16, device=DEVICE)
            idx = torch.arange(n, device=DEVICE)
            probe[:, :, j0 + idx, idx] = 1.0
            dropped = ~keep[:, j0:j0 + n]
            for out in (kern(probe), plain(probe)):
                wrong += int(((out[..., :n] == 0) != dropped).sum())
        print(f"  {'attention_bf16':16s} {label + f' splits={splits} ldk={-(-skv // 8) * 8}':44s} "
              f"dropout {BF16_DROPOUT}: {int((~keep).sum())} of {keep.numel()} pairs dropped; "
              f"pairs whose zero differs from the hash's (kernel or plain, every row and head): "
              f"{wrong}")
        if wrong:
            fail(f"attention_bf16 dropout {label}: {wrong} pairs dropped otherwise than the hash")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if key:
            kt = k.transpose(2, 3).contiguous()
            ms, nodrop_ms, library_ms = time_in_turns(
                torch, lambda: kern(v),
                lambda: ma.masked_attention(q, k, v, None, None, 0.0, "bfloat16"),
                lambda: sdpa(q, kt, v, dropout_p=BF16_DROPOUT, scale=1.0))
            plain_ms = time_ms(torch, lambda: plain(v), reps=3)
            bnd = bf16_bound(b, h, sq, skv, d)
            entry.update({f"{key}_ms": ms, f"{key}_plain_ms": plain_ms, f"{key}_bound_ms": bnd[0],
                          f"{key}_library_ms": library_ms, f"{key}_nodrop_ms": nodrop_ms})
            print(f"  {'':16s} {'':44s} max_abs_err={err!r} kernel_ms={ms!r} plain_ms={plain_ms!r} "
                  f"bound_ms={bnd[0]!r} ({bnd[1]}) library_ms={library_ms!r} (SDPA bf16, "
                  f"dropout_p {BF16_DROPOUT}); the kernel without dropout {nodrop_ms!r}")
        del q, k, v


def bf16_backward_phase(torch, results):
    """Phase 20 (b): D-bf16's backward (the plain bf16 recompute under
    autograd) against the fp32 backward (kernel D's) on the card, dropout on,
    the same seed, at the training step's encoder shape; its time beside the
    fp32 backward's and SDPA's bf16 backward with dropout_p."""
    from coda_neurips2023_tpu_torch.ops import masked_attention as ma

    b, h, s, d = TRAIN_BATCH, 4, 2048, 64
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 201)
    bf16 = torch.bfloat16
    seed = torch.randint(0, 2 ** 62, (), dtype=torch.int64, device=DEVICE, generator=gen)
    q = (torch.randn((b, h, s, d), device=DEVICE, generator=gen) / d ** 0.5).to(bf16)
    k = torch.randn((b, h, d, s), device=DEVICE, generator=gen).to(bf16)
    v = torch.randn((b, h, s, d), device=DEVICE, generator=gen).to(bf16)
    g = torch.randn((b, h, s, d), device=DEVICE, generator=gen).to(bf16)
    graphs = {}
    for dtype, cdt in ((bf16, "bfloat16"), (torch.float32, "float32")):
        leaves = [t.to(dtype).requires_grad_() for t in (q, k, v)]
        out = ma.masked_attention(*leaves, None, None, 0.0, cdt, BF16_DROPOUT, seed)
        graphs[cdt] = (out, leaves, torch.autograd.grad(out, leaves, g.to(dtype),
                                                        retain_graph=True))
    errs = []
    for name, got, want in zip("qkv", graphs["bfloat16"][2], graphs["float32"][2]):
        if got.dtype != bf16:
            fail(f"the bf16 backward's d{name} is {got.dtype}")
        errs.append((got.float() - want).abs().max().item() / want.abs().max().item())
    print(f"  bf16 backward vs fp32 (dropout {BF16_DROPOUT}, same mask): dq, dk, dv largest error "
          f"over the fp32 gradient's largest magnitude {errs!r} (tolerance {BF16_BACKWARD_TOL})")
    if not max(errs) <= BF16_BACKWARD_TOL:
        fail(f"the bf16 backward differs from the fp32 backward by {max(errs)!r}")

    def backward(cdt):
        out, leaves, _ = graphs[cdt]
        gg = g.to(out.dtype)
        return lambda: torch.autograd.grad(out, leaves, gg, retain_graph=True)

    sq, sk, sv = (t.detach().requires_grad_() for t in (q, k.transpose(2, 3).contiguous(), v))
    sout = torch.nn.functional.scaled_dot_product_attention(sq, sk, sv, dropout_p=BF16_DROPOUT,
                                                            scale=1.0)
    ms, library_ms = time_in_turns(
        torch, backward("bfloat16"),
        lambda: torch.autograd.grad(sout, (sq, sk, sv), g, retain_graph=True))
    fp32_ms = time_ms(torch, backward("float32"), reps=3)
    bnd = bf16_backward_bound(b, h, s, s, d)
    results["attention_bf16"].update(
        backward_ms=ms, backward_fp32_ms=fp32_ms, backward_bound_ms=bnd[0],
        backward_library_ms=library_ms, backward_max_rel_err=max(errs))
    print(f"  {'attention_bf16':16s} {'backward, encoder B=8 S=2048 H=4 D=64':44s} "
          f"backward_ms={ms!r} (the plain bf16 recompute) fp32_backward_ms={fp32_ms!r} "
          f"bound_ms={bnd[0]!r} ({bnd[1]}) library_ms={library_ms!r} (SDPA bf16 backward, "
          f"dropout_p {BF16_DROPOUT})")
    del graphs, sout


def expected_bf16_launches(model, b, sms):
    """Kernel D-bf16's launches in one forward of the vanilla bf16 detector
    at batch b: a launch an encoder layer and a decoder layer's
    cross-attention, and a combine where `attention_splits` splits."""
    from coda_neurips2023_tpu_torch.ops.masked_attention import attention_splits

    h, npts, nq = model.encoder.layers[0].self_attn.nhead, model.pre_encoder.npoint, model.nqueries
    enc_d = model.encoder.layers[0].linear1.weight.shape[1] // h
    dec_d = model.decoder.layers[0].linear1.weight.shape[1] // h
    enc = 1 + (attention_splits(b, h, npts, npts, enc_d, sms, bf16=True)[0] > 1)
    dec = 1 + (attention_splits(b, h, nq, npts, dec_d, sms, bf16=True)[0] > 1)
    return len(model.encoder.layers) * enc + len(model.decoder.layers) * dec


def bf16_train_steps_phase(torch, cfg, batches):
    """Phase 20 (c): the bf16 stage-1 step (CODA_BQ_ALGO=adaptive, as phase
    10) and the bf16 baseline step (CODA_BQ_FUSED_GATHER=1, as phase 8) at
    full width: one warm-up and TRAIN_STEPS timed steps each, D-bf16's
    exact launches a step, no kernel D, E-bf16 once a tower layer in stage
    1; step ms and peak memory beside the fp32 steps' and the bf16-tower
    step's of the same run."""
    from coda_neurips2023_tpu_torch import _kernels
    from coda_neurips2023_tpu_torch.engine import make_train_step
    from coda_neurips2023_tpu_torch.stages import StageContext
    from coda_neurips2023_tpu_torch.utils.device import multi_processor_count

    sms = multi_processor_count(torch.device(DEVICE))
    out = {}
    for what, flags, env, bq in (
            ("stage 1", dict(STAGE1_ARGS, compute_dtype="bf16"), {"CODA_BQ_ALGO": "adaptive"},
             "ball_query_tile"),
            ("baseline", dict(compute_dtype="bf16"), {"CODA_BQ_FUSED_GATHER": "1"},
             "ball_query_group")):
        with bq_env(**env):
            model, criterion, optimizer, schedule = train_objects(torch, cfg, True, DEVICE,
                                                                  SEED + 20, flags)
            if model.compute_dtype != torch.bfloat16:
                fail(f"{what}: the model is {model.compute_dtype}")
            if what == "stage 1":
                ctx = StageContext(types.SimpleNamespace(**flags), cfg, device=DEVICE,
                                   generator=torch.Generator(device=DEVICE).manual_seed(SEED + 7))
                if ctx.clip_model.dtype != torch.bfloat16:
                    fail(f"--compute_dtype bf16: the tower is {ctx.clip_model.dtype}")
                step = ctx.make_fused_train_step(model, criterion, optimizer, lr_schedule=schedule)
            else:
                step = make_train_step(model, criterion, optimizer, lr_schedule=schedule)
            gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
            step(batches[0], gen)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times, losses, per_step = [], [], []
            for batch in batches[1:]:
                _kernels.reset_launches()
                t0 = time.perf_counter()
                metrics = step(batch, gen)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(metrics["loss"]))
                per_step.append(dict(_kernels.LAUNCHES))
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
        expected = expected_bf16_launches(model, TRAIN_BATCH, sms)
        print(f"  {what} bf16 step: losses {losses!r}")
        print(f"    launches a step: {per_step[0]}")
        if not all(map(math.isfinite, losses)):
            fail(f"{what} bf16 training loss not finite: {losses}")
        if not all(p.dtype == torch.float32 and torch.isfinite(p).all()
                   for p in model.parameters()):
            fail(f"{what}: parameters not fp32 and finite after the bf16 steps")
        for launches in per_step:
            if launches["attention_bf16"] != expected or launches["attention"]:
                fail(f"{what}: D-bf16 launched {launches['attention_bf16']} times a step "
                     f"(expected {expected}), kernel D {launches['attention']}")
            for name in ("fps", bq, "gather"):
                if launches[name] <= 0:
                    fail(f"kernel {name} was not launched on the bf16 {what} step")
            if what == "stage 1" and (launches["vit_attention_bf16"] != CLIP_LAYERS
                                      or launches["vit_attention"]):
                fail(f"stage 1: vit_attention_bf16 launched {launches['vit_attention_bf16']} "
                     f"times a step, expected {CLIP_LAYERS}")
        med = statistics.median(times)
        fp32 = STEP_TIMES.get("phase 10" if what == "stage 1" else "phase 8", {})
        tower = STEP_TIMES.get("phase 18 (c)", {}) if what == "stage 1" else {}
        print(f"    bf16 {what} step ms: median {med!r} min {min(times)!r} max {max(times)!r}; "
              f"scenes/s {TRAIN_BATCH / med * 1e3!r}; peak memory {peak_gb!r} GB; D-bf16 "
              f"{expected} launches a step")
        print(f"    beside it in this run: fp32 step median {fp32.get('median')!r} ms, peak "
              f"{fp32.get('peak_gb')!r} GB" + (
                  f"; the bf16-tower fp32 detector's step (phase 18 (c)) {tower.get('median')!r} ms"
                  if tower else ""))
        out[what] = dict(launches=per_step[0], median=med)
    return out


class TieMatcher:
    """The matcher, returning `want`'s assignments (L, B, nq) where its own
    differ and their cost under this matcher's costs exceeds its own by at
    most BF16_TIE_COST on each such (layer, scene); `rows` and `excess` keep
    how many rows that concerned and the largest excess."""

    def __init__(self, matcher, want):
        self.matcher, self.want, self.rows, self.excess = matcher, want, 0, 0.0

    def __call__(self, outputs, targets):
        import torch

        own = self.matcher(outputs, targets)
        m = self.matcher
        want = {k: v.to(own[k].device) for k, v in self.want.items()}
        index = targets["gt_box_sem_cls_label"].long()[None, :, None, :].expand(
            *outputs["sem_cls_prob"].shape[:3], -1)
        cost = (m.cost_class * -torch.gather(outputs["sem_cls_prob"], -1, index)
                + m.cost_objectness * -outputs["objectness_prob"][..., None]
                + m.cost_center * outputs["center_dist"] + m.cost_giou * -outputs["gious"]).detach()

        def total(a):
            sel = torch.gather(cost, -1, a["per_prop_gt_inds"][..., None])[..., 0]
            return (sel * a["proposal_matched_mask"]).sum(-1)

        differ = ((own["per_prop_gt_inds"] != want["per_prop_gt_inds"])
                  | (own["proposal_matched_mask"] != want["proposal_matched_mask"])).any(-1)
        self.rows = int(differ.sum())
        self.excess = float((total(want) - total(own))[differ].max()) if self.rows else 0.0
        if self.excess > BF16_TIE_COST:
            fail(f"the matcher's own assignment is cheaper than the other device's by "
                 f"{self.excess!r} > {BF16_TIE_COST}: not a tie")
        return want


def bf16_cpu_phase(torch, cfg, batch):
    """Phase 20 (d): one bf16 baseline step, dropout 0, on 2 scenes from the
    same weights, GPU vs CPU (plain PyTorch)."""
    from coda_neurips2023_tpu_torch.engine import make_train_step

    small = {k: v[:2] for k, v in batch.items()}
    runs = {}
    for name, device in (("gpu", DEVICE), ("cpu", "cpu")):
        model, criterion, optimizer, schedule = train_objects(
            torch, cfg, False, device, SEED + 22, {"compute_dtype": "bf16"})
        if name == "cpu":
            criterion.matcher = tie = TieMatcher(criterion.matcher, runs["gpu"][2])
        step = make_train_step(model, criterion, optimizer, lr_schedule=schedule)
        t0 = time.perf_counter()
        metrics = step({k: v.to(device) for k, v in small.items()})
        grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu()
                 for n, p in model.named_parameters()}
        asg = {k: v.cpu() for k, v in criterion.last_assignments.items()}
        runs[name] = (float(metrics["loss"]), grads, asg)
        print(f"  {name}: loss {runs[name][0]!r} in {time.perf_counter() - t0:.2f} s")
    (gl, gg, _), (cl, cg, _) = runs["gpu"], runs["cpu"]
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in cg.values())).item()
    diff = torch.sqrt(sum(((gg[n] - cg[n]).double() ** 2).sum() for n in cg)).item() / norm
    worst = max(((gg[n] - cg[n]).abs().max().item() / norm, n) for n in cg)
    rel = abs(gl - cl) / abs(cl)
    print(f"  the CPU took the GPU's assignments on {tie.rows} (layer, scene) rows (cost excess "
          f"{tie.excess!r}); loss relative difference {rel!r}; gradients' difference "
          f"{diff!r} of their norm ({norm!r}), largest element {worst[0]!r} of it ({worst[1]})")
    if not rel <= BF16_STEP_RTOL:
        fail(f"bf16 step GPU vs CPU: loss differs by {rel!r} of its size > {BF16_STEP_RTOL}")
    if not (diff <= BF16_GRAD_NORM_RTOL and worst[0] <= BF16_GRAD_RTOL):
        fail(f"bf16 step GPU vs CPU: the gradients' difference {diff!r} of their norm (> "
             f"{BF16_GRAD_NORM_RTOL}?), {worst[0]!r} in {worst[1]} (> {BF16_GRAD_RTOL}?)")


def bf16_train_cli_phase(torch, root, smi):
    """Phase 20 (e): `main` with scripts/coda_sunrgbd_stage1.sh's flags and
    --compute_dtype bf16 for one epoch (phase 14's data and cuts), then one
    `main --compute_dtype bf16 --test_only --show_only` from its checkpoint."""
    import shutil

    from coda_neurips2023_tpu_torch import _kernels
    from coda_neurips2023_tpu_torch.main import main as cli_main

    out_dir = _kernels.BUILD_DIR.parent / "phase20"
    if out_dir.exists():
        shutil.rmtree(out_dir)
    argv = script_argv(root, "coda_sunrgbd_stage1.sh", STAGE1_CUTS) + [
        "--synthetic_num_scenes", str(TRAIN_CLI_SCENES), "--checkpoint_dir", str(out_dir),
        "--compute_dtype", "bf16"]
    print(f"  main {' '.join(argv)}")
    probe = TrainCliProbe(torch)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    with probe.installed():
        model = cli_main(argv)
    print(f"  stage 1 in bf16: main() {time.perf_counter() - t0!r} s")
    probe.report("stage 1 in bf16", smi)
    if model.compute_dtype != torch.bfloat16:
        fail(f"main --compute_dtype bf16 trained a {model.compute_dtype} detector")
    launches = dict(_kernels.LAUNCHES)
    for s in probe.steps:
        if s["launches"]["attention_bf16"] <= 0 or s["launches"]["attention"]:
            fail(f"a bf16 CLI step launched D-bf16 {s['launches']['attention_bf16']} times, "
                 f"kernel D {s['launches']['attention']}")
    if not (out_dir / "last_checkpoint.pth").is_file():
        fail("the bf16 stage-1 run wrote no last_checkpoint.pth")
    show_dir = out_dir / "show_only"
    t0 = time.perf_counter()
    written = cli_main(script_argv(root, "coda_sunrgbd_stage1.sh", STAGE1_CUTS) + [
        "--synthetic_num_scenes", str(TRAIN_CLI_SCENES), "--checkpoint_dir", str(show_dir),
        "--compute_dtype", "bf16", "--test_only", "--show_only",
        "--test_ckpt", str(out_dir / "checkpoint.pth")])
    files = os.listdir(show_dir / "show") if (show_dir / "show").is_dir() else []
    print(f"  main --compute_dtype bf16 --test_only --show_only: {written} scenes, {len(files)} "
          f"files in {time.perf_counter() - t0!r} s")
    if not written or not files:
        fail("the bf16 --show_only run wrote nothing")
    from coda_neurips2023_tpu_torch.utils import ap_calculator

    ap_calculator.close_pool()
    return launches


def bf16_train_phase(torch, cfg, root, smi, results):
    """Phase 20: the bf16 detector's training; returns D-bf16's and
    E-bf16's launches a bf16 stage-1 step, D-bf16's a baseline step and the
    CLI run's."""
    from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset, make_batch

    t0 = time.perf_counter()
    print(f"phase 20 (a): kernel D-bf16 with attention-weight dropout {BF16_DROPOUT} vs its "
          f"plain bf16 version, the same seed")
    with torch.inference_mode():
        bf16_dropout_kernel_phase(torch, results)
    t_a = time.perf_counter()
    print("phase 20 (b): the bf16 backward vs the fp32 backward on the card")
    bf16_backward_phase(torch, results)
    t_b = time.perf_counter()
    ds = SyntheticDetectionDataset(cfg, num_scenes=(TRAIN_STEPS + 1) * TRAIN_BATCH,
                                   num_points=NUM_POINTS, seed=SEED, with_images=True,
                                   image_hw=IMAGE_HW)
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in make_batch(ds, i * TRAIN_BATCH, TRAIN_BATCH).items()}
               for i in range(TRAIN_STEPS + 1)]
    print(f"phase 20 (c): the bf16 stage-1 and baseline training steps, {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {NUM_POINTS} points at full width, dropout as shipped")
    steps = bf16_train_steps_phase(torch, cfg, batches)
    t_c = time.perf_counter()
    print("phase 20 (d): one bf16 training step on 2 scenes, GPU vs CPU, dropout 0")
    bf16_cpu_phase(torch, cfg, batches[0])
    del batches
    t_d = time.perf_counter()
    print(f"phase 20 (e): main with scripts/coda_sunrgbd_stage1.sh's flags and --compute_dtype "
          f"bf16, one epoch of {TRAIN_CLI_SCENES} scenes, then --test_only --show_only")
    cli = bf16_train_cli_phase(torch, root, smi)
    print(f"phase 20 took {time.perf_counter() - t0:.1f} s: (a) {t_a - t0:.1f}, (b) "
          f"{t_b - t_a:.1f}, (c) {t_c - t_b:.1f}, (d) {t_d - t_c:.1f}, (e) "
          f"{time.perf_counter() - t_d:.1f}")
    return {
        "attention_bf16": dict(train_launches=steps["stage 1"]["launches"]["attention_bf16"],
                               baseline_train_launches=steps["baseline"]["launches"][
                                   "attention_bf16"],
                               train_cli_launches=cli["attention_bf16"]),
        "vit_attention_bf16": dict(
            train_launches=steps["stage 1"]["launches"]["vit_attention_bf16"],
            train_cli_launches=cli["vit_attention_bf16"]),
    }


# phase 21: tensor parallelism (parallel/tp.py).  Stage 1's step at full
# width (scripts/coda_sunrgbd_stage1.sh's flags as phase 17 (a) runs them:
# dropout 0, the crops pinned; the CLIP teacher a random ViT-B/16 from a
# seed) at a global batch of TP_BATCH for TP_STEPS steps on a (dp, mp) grid
# of TP_MP shards, against one process at the global batch from the same
# seed: (a) two ranks on the one card over gloo (NCCL takes one card a
# rank), dp 1 x mp 2; (b) with four or more cards, four NCCL ranks, one a
# card, dp 2 x mp 2
TP_MP = 2
TP_BATCH = TRAIN_BATCH
TP_STEPS = DDP_STEPS
TP_KERNELS = ("fps", "ball_query", "gather", "attention", "vit_attention")
TP_HEADS = {"attention": FLAGSHIP_ARGS["enc_nhead"] // TP_MP, "vit_attention": 12 // TP_MP}
# a grid's step against one process's differs only in the order of the
# row-parallel sums: measured on an H100 80GB HBM3 at 700 W, losses within
# 7.6e-6 (gloo, one card) and 1.7e-5 (NCCL, four cards), weights within
# 4.5e-7 and 8.0e-7 of their norm, the gradients' global norm within 2.9e-5
# at the first step and 4.7e-4 at the second (gloo; BatchNorm's training
# backward amplifies the weights' difference); gradients mp times too
# large, or a clip norm over one shard, move that norm by tens of percent
TP_LOSS_TOL = 1e-4
TP_WEIGHT_TOL = 5e-6
TP_NORM_RTOL = 3e-3


def expected_mp_reduces(model, clip):
    """(forward, backward) mp all-reduces of one stage-1 step, counted from
    the blocks switched to the grid: forward, one after each attention's
    out_proj and each FFN's linear2 (the detector's and the image tower's,
    which runs once a step, under no_grad); backward, copy_to_mp's
    gradient once for each distinct input of a column-parallel product: an
    encoder layer's self-attention takes one tensor (the vanilla encoder
    adds no position embedding), a decoder layer's two (the queries with and
    without their embedding) and its cross-attention three; each linear1
    one."""
    from coda_neurips2023_tpu_torch.models.transformer import (
        TransformerDecoderLayer,
        TransformerEncoderLayer,
    )

    forward = backward = 0
    for layer in model.modules():
        if isinstance(layer, TransformerEncoderLayer):
            parts = ((layer.self_attn.grid, 1), (layer.grid, 1))
        elif isinstance(layer, TransformerDecoderLayer):
            parts = ((layer.self_attn.grid, 2), (layer.multihead_attn.grid, 3), (layer.grid, 1))
        else:
            continue
        forward += sum(g is not None for g, _ in parts)
        backward += sum(n for g, n in parts if g is not None)
    for block in clip.visual.transformer.resblocks:
        forward += (block.attn.grid is not None) + (block.mlp.grid is not None)
    return forward, backward


def tp_run(torch, grid=None):
    """Phase 21's TP_STEPS stage-1 steps in this process: on `grid`, the
    detector and the CLIP teacher sharded and this dp block's rows; without
    one, one process at the global batch.  Records each step's loss, device
    ms, kernel launches, mp all-reduce counts, the heads kernels D and E
    were called with, the dp gradient all-reduce's bytes and ms, and the
    last step's mp all-reduces (kind, elements, dtype), the peak memory,
    the parameters' digests and the whole state after the steps."""
    import hashlib

    from coda_neurips2023_tpu_torch import _kernels, engine
    from coda_neurips2023_tpu_torch.criterion import build_criterion
    from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
    from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset, make_batch
    from coda_neurips2023_tpu_torch.models import clip as clip_mod
    from coda_neurips2023_tpu_torch.models import transformer
    from coda_neurips2023_tpu_torch.parallel import ddp, tp
    from coda_neurips2023_tpu_torch.parallel import dist as pdist
    from coda_neurips2023_tpu_torch.stages import StageContext

    cfg = SunrgbdAnonymousConfig()
    flags = {**FLAGSHIP_ARGS, **TRAIN_ARGS, **STAGE1_ARGS}
    ctx = StageContext(types.SimpleNamespace(**flags), cfg, device=DEVICE,
                       generator=torch.Generator(device=DEVICE).manual_seed(SEED + 21))
    model, _, optimizer, schedule = train_objects(torch, cfg, False, DEVICE, SEED + 22,
                                                  STAGE1_ARGS)
    args = types.SimpleNamespace(**flags)
    criterion = build_criterion(args, cfg, num_replicas=pdist.get_world_size())
    if grid is not None:
        tp.shard_state_tp(grid, model, optimizer)
        tp.shard_state_tp(grid, ctx.clip_model)
    want_mp = expected_mp_reduces(model, ctx.clip_model)
    n = args.distillation_box_num
    ctx.select_boxes = lambda last, batch, generator=None: torch.arange(
        n, device=DEVICE).expand(last["objectness_prob"].shape[0], n)
    step = ctx.make_fused_train_step(model, criterion, optimizer, lr_schedule=schedule)
    ds = SyntheticDetectionDataset(cfg, num_scenes=TP_STEPS * TP_BATCH, num_points=NUM_POINTS,
                                   seed=SEED, with_images=True, image_hw=IMAGE_HW)
    dp, d = pdist.get_world_size(), pdist.get_rank()
    b = TP_BATCH // dp
    batches = [{k: torch.from_numpy(v[d * b:(d + 1) * b]).to(DEVICE)
                for k, v in make_batch(ds, i * TP_BATCH, TP_BATCH).items()}
               for i in range(TP_STEPS)]
    record = dict(losses=[], step_ms=[], launches=[], counts=[], want_mp=want_mp,
                  heads={"attention": set(), "vit_attention": set()}, allreduce=[], sizes=[],
                  norms=[])
    update = optimizer.step

    def clipped(lr):  # the gradients' global norm, read after the step
        norm = update(lr)
        record["norms"].append(norm.detach().clone())
        return norm

    optimizer.step = clipped

    def seen(name, fn):
        def call(q, *a, **kw):
            record["heads"][name].add(q.shape[1])
            return fn(q, *a, **kw)
        return call

    all_reduce, mp_reduce = ddp.all_reduce_gradients, tp._all_reduce

    def timed(params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = all_reduce(params)
        torch.cuda.synchronize()
        record["allreduce"].append((nbytes, (time.perf_counter() - t0) * 1e3))
        return nbytes

    def sized(tensor, g, kind):
        record["sizes"][-1].append((kind, tensor.numel(), tensor.dtype))
        return mp_reduce(tensor, g, kind)

    saved = (transformer.masked_attention, clip_mod.vit_attention)
    transformer.masked_attention = seen("attention", transformer.masked_attention)
    clip_mod.vit_attention = seen("vit_attention", clip_mod.vit_attention)
    ddp.all_reduce_gradients, tp._all_reduce = timed, sized
    try:
        torch.cuda.reset_peak_memory_stats()
        for batch in batches:
            gen = engine.step_generator(SEED, optimizer.count, DEVICE, d)
            record["sizes"].append([])
            tp.reset_counts()
            before = dict(_kernels.LAUNCHES)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step(batch, gen)
            end.record()
            torch.cuda.synchronize()
            record["step_ms"].append(start.elapsed_time(end))
            record["losses"].append(float(metrics["loss"]))
            record["launches"].append({k: v - before[k] for k, v in _kernels.LAUNCHES.items()})
            record["counts"].append(dict(tp.COUNTS))
    finally:
        transformer.masked_attention, clip_mod.vit_attention = saved
        ddp.all_reduce_gradients, tp._all_reduce = all_reduce, mp_reduce
    record["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    record["norms"] = [float(n) for n in record["norms"]]
    record["sizes"] = record["sizes"][-1]
    params = dict(model.named_parameters())
    record["sharded"] = sorted(k for k, p in params.items() if hasattr(p, "tp_grid"))
    record["digests"] = {k: hashlib.sha1(p.detach().cpu().numpy().tobytes()).hexdigest()
                         for k, p in params.items()}
    state = tp.gather_state_tp(grid, model) if grid is not None else model.state_dict()
    record["state"] = {k: v.detach().cpu() for k, v in state.items()}
    return record


def tp_rank(out_dir, mp):
    """One rank of phase 21: tp_run on the grid of mp shards, then the last
    step's mp all-reduces replayed alone over the mp group (synchronized on
    both sides, each size once); writes <out_dir>/rank<r>.pkl."""
    import pickle

    import torch
    import torch.distributed as tdist

    from coda_neurips2023_tpu_torch.parallel import dist as pdist
    from coda_neurips2023_tpu_torch.parallel import tp

    grid = tp.make_tp_grid(mp)
    record = tp_run(torch, grid)
    replay = {"forward": 0.0, "backward": 0.0, "norm": 0.0}
    for kind, numel, dtype in record["sizes"]:
        t = torch.ones(numel, dtype=dtype, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tdist.all_reduce(t, group=grid.mp_group)
        torch.cuda.synchronize()
        replay[kind] += (time.perf_counter() - t0) * 1e3
    record["replay_ms"] = replay
    record["grid"] = (grid.dp, grid.mp, grid.dp_rank, grid.mp_rank)
    with open(os.path.join(out_dir, f"rank{pdist.process_rank()}.pkl"), "wb") as f:
        pickle.dump(record, f)


def tp_checks(torch, smi, world, backend, devices, one, tag):
    """Phase 21's grid of `world` ranks on `devices` over `backend` against
    the one-process record `one`; returns rank 0's launches over its steps."""
    import pickle
    import shutil

    from coda_neurips2023_tpu_torch import _kernels
    from coda_neurips2023_tpu_torch.parallel import ddp

    out_dir = _kernels.BUILD_DIR.parent / "phase21" / tag
    if out_dir.exists():
        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    dp = world // TP_MP
    print(f"phase 21 ({tag}): {world} ranks on {sorted(set(devices))} over {backend}, a grid of "
          f"dp {dp} x mp {TP_MP}: the stage-1 step at full width, global batch {TP_BATCH} "
          f"({TP_BATCH // dp} rows a dp block), {TP_STEPS} steps, dropout 0, the crops pinned")
    t0 = time.perf_counter()
    ddp.launch(tp_rank, world, str(out_dir), TP_MP, devices=devices, backend=backend,
               dist_url=ddp.free_url())
    launch_s = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    want_fwd, want_bwd = ranks[0]["want_mp"]
    if not (want_fwd > 0 and want_bwd > 0) or any(rec["want_mp"] != ranks[0]["want_mp"]
                                                 for rec in ranks):
        fail(f"the ranks' blocks switched to the grid call for {[r['want_mp'] for r in ranks]} "
             f"(forward, backward) mp all-reduces a step")
    for r, rec in enumerate(ranks):
        if rec["grid"] != (dp, TP_MP, r // TP_MP, r % TP_MP):
            fail(f"rank {r} sits at {rec['grid']} of the grid, not (dp {dp}, mp {TP_MP}, "
                 f"{r // TP_MP}, {r % TP_MP})")
        if not rec["sharded"]:
            fail(f"rank {r}: the rules sharded no parameter")
        if rec["heads"] != {k: {v} for k, v in TP_HEADS.items()}:
            fail(f"rank {r}: kernels D and E were called at heads {rec['heads']}, not "
                 f"{TP_HEADS}")
        for k, (launched, counts) in enumerate(zip(rec["launches"], rec["counts"])):
            missing = [n for n in TP_KERNELS if launched[n] <= 0]
            if missing or launched["vit_attention"] != CLIP_LAYERS:
                fail(f"rank {r} step {k}: kernels {missing} not launched, vit_attention "
                     f"{launched['vit_attention']} times ({launched})")
            if (counts["forward"], counts["backward"]) != (want_fwd, want_bwd):
                fail(f"rank {r} step {k}: {counts['forward']} forward and {counts['backward']} "
                     f"backward mp all-reduces, the model's blocks call for {want_fwd} and "
                     f"{want_bwd}")
    print(f"  every rank at its place on the grid; D called at {TP_HEADS['attention']} heads and "
          f"E at {TP_HEADS['vit_attention']} on every rank, A-E launched every step (E "
          f"{CLIP_LAYERS} times); {want_fwd} forward and {want_bwd} backward mp all-reduces a "
          f"step, as the model's blocks call for")
    losses = [rec["losses"] for rec in ranks]
    if any(l != losses[0] for l in losses):
        fail(f"the ranks' losses differ: {losses}")
    err = max(abs(a - b) for a, b in zip(losses[0], one["losses"]))
    print(f"  losses, the grid {losses[0]!r}; one process {one['losses']!r}; max |diff| {err!r}")
    norm_err = max(abs(a - b) / b for rec in ranks for a, b in zip(rec["norms"], one["norms"]))
    print(f"  gradients' global norm, the grid {ranks[0]['norms']!r}; one process "
          f"{one['norms']!r}; max relative diff over the ranks {norm_err!r}")
    got, want = ranks[0]["state"], one["state"]
    names = [k for k in want if not k.endswith("num_batches_tracked")]
    diff = math.sqrt(sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in names))
    norm = math.sqrt(sum(float((want[k].double() ** 2).sum()) for k in names))
    print(f"  the gathered weights and BatchNorm statistics after {TP_STEPS} steps: |diff| / |one| "
          f"{diff / norm!r}")
    if not err <= TP_LOSS_TOL:
        fail(f"the grid's losses differ from one process's by {err!r} > {TP_LOSS_TOL}")
    if not (len(ranks[0]["norms"]) == TP_STEPS and norm_err <= TP_NORM_RTOL):
        fail(f"the grid's gradient norms differ from one process's by {norm_err!r} of theirs "
             f"> {TP_NORM_RTOL}")
    if not diff / norm <= TP_WEIGHT_TOL:
        fail(f"the grid's weights differ from one process's by {diff / norm!r} of their norm "
             f"> {TP_WEIGHT_TOL}")
    sharded = set(ranks[0]["sharded"])
    for name, digest in ranks[0]["digests"].items():
        for r, rec in enumerate(ranks):
            peer = ranks[r % TP_MP]["digests"][name] if name in sharded else digest
            if rec["digests"][name] != peer:
                fail(f"rank {r}'s {name} differs from its "
                     f"{'dp peer' if name in sharded else 'replicas'}")
    print(f"  {len(sharded)} sharded parameters bit-equal on each shard's dp peers, the other "
          f"{len(ranks[0]['digests']) - len(sharded)} bit-equal on all {world} ranks")
    note = ("gloo over one card's shared SMs: not a scaling number" if backend == "gloo"
            else "NCCL, one card a rank")
    for r, rec in enumerate(ranks):
        c = rec["counts"][-1]
        ar = rec["allreduce"]
        print(f"  rank {r} [{smi}] ({note}): step ms {[round(x, 3) for x in rec['step_ms']]}; "
              f"mp all-reduces a step {c['forward']} forward {c['forward_bytes']} bytes, "
              f"{c['backward']} backward {c['backward_bytes']} bytes, replayed alone "
              f"{rec['replay_ms']['forward']:.3f} + {rec['replay_ms']['backward']:.3f} ms, "
              f"{c['norm']} for the clip's norm {rec['replay_ms']['norm']:.3f} ms; "
              f"dp gradient all-reduce {ar[-1][0]} bytes {ar[-1][1]:.3f} ms; peak memory "
              f"allocated {rec['peak_gb']!r} GB")
    print(f"  one process at batch {TP_BATCH} [{smi}]: step ms "
          f"{[round(x, 3) for x in one['step_ms']]}; peak {one['peak_gb']!r} GB; the {world}-rank "
          f"launch {launch_s:.1f} s")
    return {k: sum(l[k] for l in ranks[0]["launches"]) for k in ranks[0]["launches"][0]}


def tp_kernel_rows(torch, results):
    """Kernels D and E against their plain versions at the local head count
    of phase 21's grid (mp 2): D at the stage-1 step's encoder and decoder
    shapes (B=8), E at its 256 crops; kernel, plain, SDPA ms and bound."""
    from coda_neurips2023_tpu_torch.ops.masked_attention import (
        masked_attention,
        masked_attention_plain,
    )
    from coda_neurips2023_tpu_torch.ops.vit_attention import vit_attention, vit_attention_plain

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    h, b = TP_HEADS["attention"], TP_BATCH

    def randn(*shape):
        return torch.randn(shape, device=DEVICE, generator=gen)

    rows = []
    for label, sq, skv, d in (("encoder", 2048, 2048, 64), ("decoder", 128, 2048, 128)):
        q = randn(b, h, sq, d) / d ** 0.5
        k, v = randn(b, h, d, skv), randn(b, h, skv, d)
        kt = k.transpose(2, 3).contiguous()
        rows.append(("attention", f"{label} B={b} H={h} Sq={sq} Skv={skv} D={d}",
                     lambda q=q, k=k, v=v: masked_attention(q, k, v, None, None, 0.0),
                     lambda q=q, k=k, v=v: masked_attention_plain(q, k, v, None, None, 0.0),
                     lambda q=q, kt=kt, v=v: sdpa(q, kt, v, scale=1.0),
                     attention_bound(b, h, sq, skv, d), ATTN_TOL, label))
    crops, vh = TP_BATCH * N_SEL, TP_HEADS["vit_attention"]
    q, k, v = (randn(crops, vh, 197, 64) for _ in range(3))
    rows.append(("vit_attention", f"B={crops} crops H={vh} S=197 D=64",
                 lambda: vit_attention(q, k, v), lambda: vit_attention_plain(q, k, v),
                 lambda: sdpa(q, k, v), attention_bound(crops, vh, 197, 197, 64), VIT_ATTN_TOL,
                 "stage1"))
    with torch.inference_mode():
        for name, label, kern, plain, library, bnd, tol, shape in rows:
            want = plain()
            err = (kern() - want).abs().max().item()
            if not err <= tol:
                fail(f"{name} at mp {TP_MP}'s {label}: max_abs_err {err!r} > {tol}")
            if not (library() - want).abs().max().item() <= tol:
                fail(f"scaled_dot_product_attention differs from the plain {name}")
            ms, library_ms = time_in_turns(torch, kern, library)
            plain_ms = time_ms(torch, plain)
            results[name].setdefault("tp", {})[shape] = dict(
                shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
                bound_by=bnd[1], library_ms=library_ms)
            print(f"  {name:16s} mp {TP_MP}: {label:40s} max_abs_err={err!r} kernel_ms={ms!r} "
                  f"plain_ms={plain_ms!r} bound_ms={bnd[0]!r} ({bnd[1]}) library_ms={library_ms!r}")


def tp_phase(torch, smi, results):
    """Phase 21: (a) a grid of two ranks on the one card over gloo; with four
    or more cards, (b) dp 2 x mp 2 over NCCL; then D and E at the local
    heads.  Returns (a)'s launches of rank 0."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    print(f"phase 21: one process, the stage-1 step at full width, batch {TP_BATCH}, "
          f"{TP_STEPS} steps, dropout 0, the crops pinned (the grids' reference)")
    one = tp_run(torch)
    torch.cuda.empty_cache()
    launches = tp_checks(torch, smi, TP_MP, "gloo", ["cuda:0"] * TP_MP, one, "a")
    cards = torch.cuda.device_count()
    if cards >= 2 * TP_MP:
        tp_checks(torch, smi, 2 * TP_MP, "nccl", [f"cuda:{r}" for r in range(2 * TP_MP)], one,
                  "b")
    else:
        print(f"  (b) dp 2 x mp {TP_MP} over NCCL did not run: {cards} card(s) visible, it takes "
              f"{2 * TP_MP}, one a rank; this run is no pass of NCCL")
    del one
    print(f"phase 21: kernels D and E at mp {TP_MP}'s local heads vs plain PyTorch and SDPA")
    tp_kernel_rows(torch, results)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s [{smi}]")
    return launches


def main():
    started = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "coda_neurips2023_tpu_torch", "csrc")):
        fail("coda_neurips2023_tpu_torch/ is not beside this script")
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    for var in BQ_VARS:  # the default kernels; each phase sets its own
        os.environ.pop(var, None)

    # phase 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # phase 2
    from coda_neurips2023_tpu_torch import _kernels

    t0 = time.perf_counter()
    # the scan kernels B and F replaced, phase 3's yardstick, built beside the package's
    scan_so = _kernels.BUILD_DIR.parent / "ball_query_variants.so"
    scan_so.parent.mkdir(parents=True, exist_ok=True)
    scan_build = subprocess.Popen(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", str(scan_so),
         os.path.join(root, "scripts", "ball_query_variants.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lib_path = _kernels.build()
    finally:
        scan_log = scan_build.communicate()[0]
    if scan_build.returncode != 0:
        fail(f"nvcc failed on scripts/ball_query_variants.cu:\n{scan_log[-4000:]}")
    print(f"kernels built in {time.perf_counter() - t0:.1f} s -> {lib_path.name}, {scan_so.name}")
    from coda_neurips2023_tpu_torch import native

    t0 = time.perf_counter()
    if not native.available():
        fail("g++ failed on coda_neurips2023_tpu_torch/csrc/host/coda_native.cpp")
    print(f"host library (the AP stack's NMS and IoU) built in {time.perf_counter() - t0:.1f} s")
    log = (_kernels.BUILD_DIR / "build.log").read_text().splitlines()
    for line in log:
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas: " + line.split("ptxas info    :")[-1].strip())
    _kernels.library()

    from coda_neurips2023_tpu_torch.datasets.config import (
        SunrgbdAnonymousConfig,
        SunrgbdImageConfig,
    )
    from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset, make_batch
    from coda_neurips2023_tpu_torch.engine import make_eval_step
    from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
    from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
    from coda_neurips2023_tpu_torch.stages import StageContext

    cfg = SunrgbdAnonymousConfig()
    ds = SyntheticDetectionDataset(cfg, num_scenes=STEPS * BATCH, num_points=NUM_POINTS, seed=SEED,
                                   with_images=True, image_hw=IMAGE_HW)
    batches = [
        {k: torch.from_numpy(v).cuda() for k, v in make_batch(ds, i * BATCH, BATCH).items()}
        for i in range(STEPS)
    ]

    # phase 3
    print("phase 3: kernels vs plain PyTorch")
    results = {}
    scannet = SyntheticDetectionDataset(cfg, num_scenes=TRAIN_BATCH, num_points=SCANNET_POINTS,
                                        seed=SEED)
    xyz40 = torch.from_numpy(make_batch(scannet, 0, TRAIN_BATCH)["point_clouds"]).cuda()
    with torch.inference_mode():
        compare_kernels(torch, batches[0]["point_clouds"][..., :3].contiguous(),
                        xyz40[..., :3].contiguous(), load_scan_kernels(scan_so), results)
        gather_sweep(torch)
    del xyz40
    compare_attention_backward(torch)

    # phase 4
    print(f"phase 4: flagship eval step, {STEPS} batches of {BATCH} x {NUM_POINTS} points")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = reset_parameters(CoDA3DETR(cfg, device="cuda"), gen).eval()
    t0 = time.perf_counter()
    ctx = StageContext(types.SimpleNamespace(**CLIP_ARGS), SunrgbdImageConfig(), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    text = ctx.text_banks["test"]
    torch.cuda.synchronize()
    print(f"  text bank {tuple(text.shape)} from CLIP's text tower in "
          f"{time.perf_counter() - t0:.2f} s (once, outside the timed steps)")
    if tuple(text.shape) != (EVAL_CLASSES, 512) or not torch.isfinite(text).all():
        fail(f"text bank: shape {tuple(text.shape)} or non-finite values")
    if (torch.linalg.vector_norm(text, dim=1) - 1).abs().max() > 1e-5:
        fail("text bank rows are not unit vectors")
    eval_step = make_eval_step(model, eval_text_features=text, eval_logit_scale=100.0)
    eval_step(batches[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    times, outs = [], []
    for batch in batches:
        t0 = time.perf_counter()
        out = eval_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches4 = dict(_kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    nq = model.nqueries
    check_eval_outputs(torch, outs, nq, "eval", zero_rows=False)
    print(f"  launches in the {STEPS} timed steps: {launches4}")
    for name in ("fps", "ball_query", "gather", "attention"):
        if launches4[name] <= 0:
            fail(f"kernel {name} was not launched on the detector eval path")
    check_grid_launches(launches4, "ball_query", STEPS, "detector eval")
    med = statistics.median(times)
    print(f"  eval step ms: median {med!r} min {min(times)!r} max {max(times)!r}")
    print(f"  scenes/s (median step): {BATCH / med * 1e3!r}")
    print(f"  peak memory allocated: {peak_gb!r} GB")

    # phase 5
    print("phase 5: the same model on the CPU (plain PyTorch) on 2 scenes")
    small = {k: v[:2] for k, v in batches[0].items()}
    with torch.inference_mode():
        gpu = model(small)
        cpu_model = model.to("cpu")
        cpu = cpu_model({k: v.cpu() for k, v in small.items()})
    compare_gpu_cpu(torch, gpu, cpu, "flagship")

    launches6, detector = clip_eval_phase(torch, ctx, cfg, batches)
    clip_cpu_phase(torch, ctx, detector, batches[0])
    crop_phase(torch, batches[0]["input_image"], results)
    # phase 12 reruns phase 4's first batch
    phase4_batch = {k: batches[0][k] for k in ("point_clouds", "point_cloud_dims_min",
                                               "point_cloud_dims_max")}
    phase4_out = outs[0]
    del detector, ctx, batches, outs

    train_ds = SyntheticDetectionDataset(cfg, num_scenes=(TRAIN_STEPS + 1) * TRAIN_BATCH,
                                         num_points=NUM_POINTS, seed=SEED)
    train_batches = [
        {k: torch.from_numpy(v).cuda()
         for k, v in make_batch(train_ds, i * TRAIN_BATCH, TRAIN_BATCH).items()}
        for i in range(TRAIN_STEPS + 1)
    ]
    with bq_env(CODA_BQ_FUSED_GATHER="1"):
        launches8 = train_phase(torch, cfg, train_batches)
        train_cpu_phase(torch, cfg, train_batches[0])
    del train_batches

    stage1_ds = SyntheticDetectionDataset(cfg, num_scenes=(TRAIN_STEPS + 1) * TRAIN_BATCH,
                                          num_points=NUM_POINTS, seed=SEED, with_images=True,
                                          image_hw=IMAGE_HW)
    stage1_batches = [
        {k: torch.from_numpy(v).cuda()
         for k, v in make_batch(stage1_ds, i * TRAIN_BATCH, TRAIN_BATCH).items()}
        for i in range(TRAIN_STEPS + 1)
    ]
    with bq_env(CODA_BQ_ALGO="adaptive"):
        launches10, stage1_ctx = stage1_phase(torch, cfg, stage1_batches)
        stage1_cpu_phase(torch, cfg, stage1_ctx, stage1_batches[0])
    del stage1_batches, stage1_ctx

    model = model.to("cuda")
    mxu_phase(torch, model, text, phase4_batch, phase4_out)
    cli_launches, eval13 = cli_phase(torch, model, launches4)
    del model
    train_cli_launches = train_cli_phase(torch, root, smi)
    ckpt4 = _kernels.BUILD_DIR.parent / "phase13" / "model.pth"
    t0 = time.perf_counter()
    train_dir, scannet_args = scannet_eval_phase(torch, root, ckpt4, launches4, results)
    launches15 = scannet_stage1_phase(torch, train_dir, scannet_args)
    t1 = time.perf_counter()
    modes_phase(torch, ckpt4)
    print(f"phase 15 took {t1 - t0:.1f} s, phase 16 {time.perf_counter() - t1:.1f} s")
    ddp_launches = ddp_phase(torch, root, smi, ckpt4, eval13)
    bf16_launches = bf16_phase(torch, cfg, ckpt4, results)
    masked_launches, masked_cli, masked_stage1 = masked_phase(torch, cfg, text, results)
    train20 = bf16_train_phase(torch, cfg, root, smi, results)
    tp_launches = tp_phase(torch, smi, results)

    # each kernel's count from the path it serves: A-D the detector eval
    # (phase 4), E and the crops the CLIP-crop eval (phase 6), F the baseline
    # training step (phase 8), G the stage-1 training step (phase 10)
    launches = dict(launches4, vit_attention=launches6["vit_attention"],
                    ball_query_group=launches8["ball_query_group"],
                    ball_query_tile=launches10["ball_query_tile"], crop=launches6["crop"])
    kernels = [
        {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
            **({"cli_launches": cli_launches[name]} if name in CLI_KERNELS else {}),
            "train_cli_launches": train_cli_launches[name],
            "scannet_cli_launches": results["scannet_cli_launches"][NUM_POINTS].get(name, 0),
            "scannet_stage1_launches": launches15[name],
            "ddp_launches": ddp_launches[name],
            "masked_launches": masked_launches.get(name, 0),
            "masked_cli_launches": masked_cli.get(name, 0),
            "masked_stage1_launches": masked_stage1.get(name, 0),
            "tp_launches": tp_launches.get(name, 0),
            **{key: value for key, value in results[name].items() if key != "max_abs_err"},
        }
        for name, (src, rep) in KERNELS.items()
    ] + [
        {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            **bf16_launches[name], **train20[name], "max_abs_err": results[name]["max_abs_err"],
            "tp_launches": tp_launches.get(name, 0),
            **{key: value for key, value in results[name].items() if key != "max_abs_err"},
        }
        for name, (src, rep) in BF16_KERNELS.items()
    ]
    print(f"chip_smoke took {time.perf_counter() - started:.1f} s, the kernels' build included")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
