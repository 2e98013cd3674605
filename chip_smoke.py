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
     work).
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
barrier floor at the main shape.  The last line is
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
        out_p = masked_attention_plain(pq, pk, pv, None, None, 0.0, dropout, seed)
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


def train_objects(torch, cfg, dropout: bool, device, seed, flags=None):
    """The baseline detector (or, with STAGE1_ARGS as `flags`, the CoDA
    detector), its criterion and optimizer on `device`, built as a training
    run builds them.  The random weights are drawn on the card from `seed`,
    so every device gets the same ones."""
    from coda_neurips2023_tpu_torch.criterion import build_criterion
    from coda_neurips2023_tpu_torch.models import build_model
    from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
    from coda_neurips2023_tpu_torch.optimizer import build_optimizer

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
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        matcher_ms.append(criterion.matcher.last_host_ms)
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


def stage1_phase(torch, cfg, batches):
    """Phase 10: the stage-1 distillation training step at full width, G on."""
    from coda_neurips2023_tpu_torch import _kernels
    from coda_neurips2023_tpu_torch.stages import StageContext

    print(f"phase 10: stage-1 training step (3detr_predictedbox_distillation), {TRAIN_STEPS} steps "
          f"of {TRAIN_BATCH} x {NUM_POINTS} points with {IMAGE_HW[0]} x {IMAGE_HW[1]} images, "
          f"{N_SEL} crops a scene, CODA_BQ_ALGO=adaptive")
    t0 = time.perf_counter()
    ctx = StageContext(types.SimpleNamespace(**STAGE1_ARGS), cfg, device=DEVICE,
                       generator=torch.Generator(device=DEVICE).manual_seed(SEED + 7))
    print(f"  CLIP and the text bank {tuple(ctx.train_text_features.shape)} in "
          f"{time.perf_counter() - t0:.2f} s (once, outside the timed steps)")
    model, criterion, optimizer, schedule = train_objects(torch, cfg, True, DEVICE, SEED + 8,
                                                          STAGE1_ARGS)
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
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        l1.append(float(metrics["loss_predicted_region_embed_l1"]))
        crops.append(int(targets["gt_text_correlation_embedding_mask"].sum()))
        matcher_ms.append(criterion.matcher.last_host_ms)
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
    print(f"  launches in the {TRAIN_STEPS} timed steps: {launches}")
    for name in ("fps", "ball_query_tile", "gather", "attention", "vit_attention"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the stage-1 path")
    for name in ("ball_query", "ball_query_group"):
        if launches[name] != 0:
            fail(f"kernel {name} was launched on the stage-1 path under CODA_BQ_ALGO=adaptive")
    check_grid_launches(launches, "ball_query_tile", TRAIN_STEPS, "stage-1")
    if launches["vit_attention"] != TRAIN_STEPS * CLIP_LAYERS:
        fail(f"vit_attention launched {launches['vit_attention']} times, expected "
             f"{TRAIN_STEPS * CLIP_LAYERS} (one tower call of every step's crops)")
    med = statistics.median(times)
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
        unaugment_corners,
    )

    un = unaugment_corners(last["box_corners_xyz"], batch["scale_array"], batch["rot_array"],
                           batch["flip_array"])
    b, q = un.shape[:2]
    uv, _ = project_upright_depth_to_image(un.reshape(b, q * 8, 3), batch["K"], batch["Rtilt"])
    hi = torch.stack([batch["ori_width"], batch["ori_height"]], -1).double()[:, None, None, :] - 1
    uv = torch.minimum(uv.reshape(b, q, 8, 2).double().clamp(min=0), hi)
    ext = torch.cat([uv.amin(2), uv.amax(2)], -1)  # the rect before truncation
    hi4 = hi[:, :, 0, [0, 1, 0, 1]]
    near = ((ext - ext.round()).abs() < RECT_MARGIN) & (ext > 0) & (ext < hi4)
    risky = near.any(-1).cpu()
    key = torch.rand((b, q), generator=gen) + risky.double()
    return torch.argsort(key, dim=1)[:, :N_SEL], (~risky).sum(1).tolist()


def stage1_cpu_phase(torch, cfg, ctx, batch):
    """Phase 11: the stage-1 step, dropout 0, GPU vs CPU, same weights and crops."""
    from coda_neurips2023_tpu_torch.engine import last_layer
    from coda_neurips2023_tpu_torch.models.distillation import crop_rects

    print("phase 11: the stage-1 step on 2 scenes, GPU vs CPU (plain PyTorch), dropout 0")
    small = {k: v[:2] for k, v in batch.items()}
    model, criterion, optimizer, schedule = train_objects(torch, cfg, False, DEVICE, SEED + 10,
                                                          STAGE1_ARGS)
    with torch.no_grad():  # the boxes the step will crop, from a copy's training forward
        last = last_layer(copy.deepcopy(model)(small))
    sel, n_safe = safe_selection(torch, last, small, torch.Generator().manual_seed(SEED + 11))
    print(f"  boxes a scene whose rects lie {RECT_MARGIN} px from integer boundaries: {n_safe}")
    runs = {}
    for name, device, c in (("gpu", DEVICE, ctx), ("cpu", "cpu", ctx.to("cpu"))):
        if name == "cpu":
            model, criterion, optimizer, schedule = train_objects(torch, cfg, False, "cpu",
                                                                  SEED + 10, STAGE1_ARGS)
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
    """engine.make_eval_step wrapped so that the text bank it is given and its
    step's first batch and outputs land in `store`."""
    make = engine.make_eval_step

    def wrapped(model, eval_text_features=None, **kw):
        store["bank"] = eval_text_features
        step = make(model, eval_text_features=eval_text_features, **kw)

        def recorded(batch):
            out = step(batch)
            if "first" not in store:
                store["first"] = (dict(batch), {k: v.clone() for k, v in out.items()})
            return out

        return recorded

    engine.make_eval_step = wrapped
    try:
        yield store
    finally:
        engine.make_eval_step = make


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


def check_cli_metrics(metrics, scans, stats, meter, what):
    if stats["scans"] != scans or meter["scans"] != scans:
        fail(f"{what}: metered {stats['scans']} scans (parsed {meter['scans']}), expected {scans}")
    if meter["native_nms_scans"] != scans:
        fail(f"{what}: NMS ran in the host library for {meter['native_nms_scans']} of {scans} scans")
    if set(metrics) != {0.25, 0.5}:
        fail(f"{what}: metric thresholds {sorted(metrics)}")
    for thresh, ret in metrics.items():
        ncls = sum(1 for k in ret if k.endswith(" Average Precision"))
        if ncls not in (1, EVAL_CLASSES) or set(ret) != expected_metric_keys(ncls):
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
    """Phase 13: the eval entry point end to end on the card."""
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
    cli_launches = {}
    for workers in CLI_WORKERS:
        with recording_eval_step(engine, {}) as store:
            metrics, launches, stats, meter, seconds = cli_run(torch, argv, workers)
        check_cli_metrics(metrics, scans, stats, meter, f"CODA_AP_WORKERS={workers}")
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
    return cli_launches


def main():
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
    for key in ("enc_inds", "query_xyz", "enc_xyz"):
        if not torch.equal(gpu[key].cpu(), cpu[key]):
            fail(f"{key}: GPU and CPU differ")
    if not torch.equal(gpu["angle_logits"].argmax(-1).cpu(), cpu["angle_logits"].argmax(-1)):
        fail("angle classes differ between GPU and CPU")
    worst = max(
        ((gpu[k].cpu() - cpu[k]).abs().max().item(), k) for k in cpu if cpu[k].is_floating_point()
    )
    print(f"  GPU vs CPU: indices equal, worst float key {worst[1]} max_abs_err={worst[0]!r}")
    if not worst[0] <= MODEL_TOL:
        fail(f"GPU vs CPU: {worst[1]} differs by {worst[0]!r} > {MODEL_TOL}")

    launches6, detector = clip_eval_phase(torch, ctx, cfg, batches)
    clip_cpu_phase(torch, ctx, detector, batches[0])
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
    cli_launches = cli_phase(torch, model, launches4)

    # each kernel's count from the path it serves: A-D the detector eval
    # (phase 4), E the CLIP-crop eval (phase 6), F the baseline training step
    # (phase 8), G the stage-1 training step (phase 10)
    launches = dict(launches4, vit_attention=launches6["vit_attention"],
                    ball_query_group=launches8["ball_query_group"],
                    ball_query_tile=launches10["ball_query_tile"])
    kernels = [
        {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
            **({"cli_launches": cli_launches[name]} if name in CLI_KERNELS else {}),
            **{key: value for key, value in results[name].items() if key != "max_abs_err"},
        }
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
