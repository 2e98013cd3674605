#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without printing a
result):
  1. torch/CUDA versions, the card's name and power limit, TF32 switched off.
  2. Build the kernels (coda_neurips2023_tpu_torch/csrc) with nvcc.
  3. Each kernel against its plain PyTorch version at the shapes of the two
     eval paths: FPS, ball query and gather exactly, attention (D) within
     ATTN_TOL, ViT attention (E) at one scene's crops within VIT_ATTN_TOL;
     kernel and plain times (CUDA events, median of REPS after warm-up).
  4. The flagship CoDA model (enc 256, dec 512, 3 + 8 layers, 2048 points,
     128 queries) with random weights from a seed, eval step on 3 batches of
     32 synthetic 20000-point scenes against the 46-class text bank, which
     CLIP's text tower (random weights from a seed) encodes first: shapes,
     finite values, the launch counts of kernels A-D, step times, peak memory.
  5. The same model and weights on the CPU (plain PyTorch paths) on 2 scenes:
     integer outputs equal, floats within MODEL_TOL.
  6. The baseline detector's CLIP-crop eval (3detrmulticlasshead
     --if_with_clip) at full width: the flagship detector without a text
     head, CLIP ViT-B/16, batches of 32 scenes with 531 x 730 images, so 4096
     crops through the image tower a step; one warm-up and 3 timed steps:
     shapes, finite values, sem_cls_prob rows that sum to 1 or are zero (an
     invalid box), the launch counts of all five kernels, step times, crops/s,
     peak memory.
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
     F and D (F, A and D must launch).
  9. The same step, dropout 0, from the same weights on 2 scenes on the GPU
     and on the CPU (plain paths): assignments equal, loss within STEP_TOL,
     gradients within GRAD_TOL of their global norm.
Phase 3 also holds kernel F against its plain version and against kernel B
followed by kernel C, bit for bit, and D in training (with and without its
attention-weight dropout: the output, and q, k, v gradients through its
autograd Function) against its plain version and autograd of it.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

BATCH = 32
NUM_POINTS = 20000
EVAL_CLASSES = 46
STEPS = 3
REPS = 7
SEED = 0
# fp32 attention: the kernel sums the 64/128-term dot products and the
# softmax-weighted values in another order than cuBLAS, and rescales its
# running sum tile by tile; outputs are O(1), so 1e-4 absolute is ~1e-5
# relative, far above fp32 rounding and far below any indexing or masking
# error.
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
}
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


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(torch, fn, reps=REPS, warmup=2):
    """Median, over `reps` runs after `warmup`, of CUDA-event milliseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_kernels(torch, xyz, results):
    """Phase 3: each kernel vs its plain version at the eval forward's shapes."""
    from coda_neurips2023_tpu_torch.ops import grouping, sampling
    from coda_neurips2023_tpu_torch.ops.masked_attention import (
        masked_attention,
        masked_attention_plain,
    )
    from coda_neurips2023_tpu_torch.ops.vit_attention import vit_attention, vit_attention_plain

    def record(name, label, err, ms, plain_ms, main_shape):
        entry = results.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if main_shape:
            entry["ms"], entry["plain_ms"] = ms, plain_ms
        print(f"  {name:16s} {label:44s} max_abs_err={err!r} kernel_ms={ms!r} plain_ms={plain_ms!r}")

    def exact(name, label, kern, plain, main_shape=True):
        a, b = kern(), plain()
        torch.cuda.synchronize()
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            bad = (a != b).sum().item() if a.shape == b.shape else "shape"
            fail(f"{name} {label}: kernel differs from plain version ({bad} entries)")
        record(name, label, 0.0, time_ms(torch, kern), time_ms(torch, plain), main_shape)
        return a

    b = xyz.shape[0]
    inds = exact("fps", f"B={b} N={NUM_POINTS} -> 2048",
                 lambda: sampling.furthest_point_sample(xyz, 2048),
                 lambda: sampling.furthest_point_sample_plain(xyz, 2048))
    centres = exact("gather", f"gather_points B={b} N={NUM_POINTS} M=2048",
                    lambda: sampling.gather_points(xyz, inds),
                    lambda: grouping.group_points_plain(xyz, inds[:, None, :]).reshape(b, 2048, 3),
                    main_shape=False)
    q_inds = exact("fps", f"B={b} N=2048 -> 128",
                   lambda: sampling.furthest_point_sample(centres, 128),
                   lambda: sampling.furthest_point_sample_plain(centres, 128),
                   main_shape=False)
    exact("gather", f"gather_points B={b} N=2048 M=128",
          lambda: sampling.gather_points(centres, q_inds),
          lambda: grouping.group_points_plain(centres, q_inds[:, None, :]).reshape(b, 128, 3),
          main_shape=False)
    idx = exact("ball_query", f"B={b} N={NUM_POINTS} M=2048 r=0.2 k=64",
                lambda: grouping.ball_query(0.2, 64, xyz, centres),
                lambda: grouping.ball_query_plain(0.2, 64, xyz, centres))
    exact("gather", f"group_points B={b} N={NUM_POINTS} M=2048 K=64",
          lambda: grouping.group_points(xyz, idx),
          lambda: grouping.group_points_plain(xyz, idx))
    two_op = lambda: grouping.group_points(xyz, grouping.ball_query(0.2, 64, xyz, centres))
    for n_scenes in (b, TRAIN_BATCH):
        x, c = xyz[:n_scenes].contiguous(), centres[:n_scenes].contiguous()
        label = f"B={n_scenes} N={NUM_POINTS} M=2048 r=0.2 k=64"
        kern = lambda: grouping.ball_query_group(0.2, 64, x, c)
        plain = lambda: grouping.ball_query_group_plain(0.2, 64, x, c)
        bc = lambda: (lambda i: (i, grouping.group_points(x, i)))(grouping.ball_query(0.2, 64, x, c))
        got, want, via_bc = kern(), plain(), bc()
        torch.cuda.synchronize()
        for what, ref in (("plain version", want), ("kernel B then kernel C", via_bc)):
            if not all(torch.equal(g, w) for g, w in zip(got, ref)):
                fail(f"ball_query_group {label}: differs from the {what}")
        if n_scenes == b and not torch.equal(got[1], two_op()):
            fail("ball_query_group: differs from group_points(ball_query) of phase 3")
        ms, bc_ms = time_ms(torch, kern), time_ms(torch, bc)
        record("ball_query_group", label, 0.0, ms, time_ms(torch, plain), n_scenes == TRAIN_BATCH)
        print(f"  {'':16s} {'':44s} kernels B then C ms={bc_ms!r}")
    half = sampling.gather_points(centres, sampling.furthest_point_sample(centres, 1024))
    exact("ball_query", f"B={b} N=2048 M=1024 r=0.4 k=32",
          lambda: grouping.ball_query(0.4, 32, centres, half),
          lambda: grouping.ball_query_plain(0.4, 32, centres, half),
          main_shape=False)

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen)

    cases = [
        ("encoder self-attention S=2048 H=4 D=64", 2048, 2048, 64, 0.0, True),
        ("decoder cross-attention Sq=128 Skv=2048 H=4 D=128", 128, 2048, 128, 0.0, False),
        ("radius-masked S=2048 H=4 D=64 r=1.2**2", 2048, 2048, 64, 1.2 ** 2, False),
    ]
    for label, sq, skv, d, radius, main_shape in cases:
        q = randn(b, 4, sq, d) / d ** 0.5
        k, v = randn(b, 4, d, skv), randn(b, 4, skv, d)
        qxyz = centres[:, :sq].contiguous()
        kxyz_t = centres.transpose(1, 2).contiguous()
        kern = lambda: masked_attention(q, k, v, qxyz, kxyz_t, radius)
        plain = lambda: masked_attention_plain(q, k, v, qxyz, kxyz_t, radius)
        err = (kern() - plain()).abs().max().item()
        if not err <= ATTN_TOL:
            fail(f"attention {label}: max_abs_err {err!r} > {ATTN_TOL}")
        record("attention", label, err, time_ms(torch, kern), time_ms(torch, plain), main_shape)

    # kernel E at one scene's crops through a ViT-B/16 layer: 128 x 12 x 197 x 64
    q, k, v = (randn(128, 12, 197, 64) for _ in range(3))
    kern = lambda: vit_attention(q, k, v)
    plain = lambda: vit_attention_plain(q, k, v)
    err = (kern() - plain()).abs().max().item()
    if not err <= VIT_ATTN_TOL:
        fail(f"vit_attention: max_abs_err {err!r} > {VIT_ATTN_TOL}")
    record("vit_attention", "B=128 crops H=12 S=197 D=64", err, time_ms(torch, kern),
           time_ms(torch, plain), True)


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


def train_objects(torch, cfg, dropout: bool, device, seed):
    """The baseline detector, its criterion and optimizer on `device`, built
    as a training run builds them.  The random weights are drawn on the card
    from `seed`, so every device gets the same ones."""
    from coda_neurips2023_tpu_torch.criterion import build_criterion
    from coda_neurips2023_tpu_torch.models import build_model
    from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
    from coda_neurips2023_tpu_torch.optimizer import build_optimizer

    args = types.SimpleNamespace(**dict(FLAGSHIP_ARGS, **TRAIN_ARGS))
    if not dropout:
        args.mlp_dropout = args.enc_dropout = args.dec_dropout = 0.0
    model, _ = build_model(args, cfg, device="cuda")
    reset_parameters(model, torch.Generator(device="cuda").manual_seed(seed))
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


def main():
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "coda_neurips2023_tpu_torch", "csrc")):
        fail("coda_neurips2023_tpu_torch/ is not beside this script")
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")

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
    lib_path = _kernels.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s -> {lib_path.name}")
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
    with torch.inference_mode():
        compare_kernels(torch, batches[0]["point_clouds"][..., :3].contiguous(), results)
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
    del detector, ctx, batches, outs, model, cpu_model

    train_ds = SyntheticDetectionDataset(cfg, num_scenes=(TRAIN_STEPS + 1) * TRAIN_BATCH,
                                         num_points=NUM_POINTS, seed=SEED)
    train_batches = [
        {k: torch.from_numpy(v).cuda()
         for k, v in make_batch(train_ds, i * TRAIN_BATCH, TRAIN_BATCH).items()}
        for i in range(TRAIN_STEPS + 1)
    ]
    fused = os.environ.get("CODA_BQ_FUSED_GATHER")
    os.environ["CODA_BQ_FUSED_GATHER"] = "1"
    try:
        launches8 = train_phase(torch, cfg, train_batches)
        train_cpu_phase(torch, cfg, train_batches[0])
    finally:
        if fused is None:
            del os.environ["CODA_BQ_FUSED_GATHER"]
        else:
            os.environ["CODA_BQ_FUSED_GATHER"] = fused

    # each kernel's count from the path it serves: A-D the detector eval
    # (phase 4), E the CLIP-crop eval (phase 6), F the training step (phase 8)
    launches = dict(launches4, vit_attention=launches6["vit_attention"],
                    ball_query_group=launches8["ball_query_group"])
    kernels = [
        {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
            "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
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
