#!/usr/bin/env python3
"""Where the port's eval or training step spends its time on the GPU.

    python3 scripts/profile_torch_eval.py [--batch B] [--points 20000] [--clip | --train | --stage1]

Builds the flagship CoDA model (random weights from a seed), warms the eval
step up, then traces STEPS steps with torch.profiler and prints the device
time by kernel, that of the port's own kernels (csrc/, A-G, with kernel D's
combine launch) apart, the device time by phase of the forward (record_function
ranges), and the device's busy share of the traced wall time.  With --clip
it profiles the baseline detector's CLIP-crop eval step instead (ViT-B/16,
531 x 730 images), with the detector, the crops and the image tower as
phases.  With --train it profiles the baseline detector's training step
(scripts/coda_baseline_sunrgbd.sh, B=8 by default, CODA_BQ_FUSED_GATHER=1),
with the step's own ranges (forward; criterion with gIoU and matcher;
backward; optimizer) as phases, and the matcher's host time.  With --stage1
it profiles CoDA's stage-1 distillation training step
(scripts/coda_sunrgbd_stage1.sh, B=8 by default, 531 x 730 images, 32 crops
a scene through CLIP ViT-B/16, CODA_BQ_ALGO=adaptive so kernel G runs the
ball query), with the step's ranges and the crops and the image tower as
phases.  --train and --stage1 then time the step again by part with a sync
at each boundary.  Needs a GPU.
"""

import argparse
import os
import re
import statistics
import sys
import time
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from coda_neurips2023_tpu_torch.datasets.config import (  # noqa: E402
    SunrgbdAnonymousConfig,
    SunrgbdImageConfig,
)
from coda_neurips2023_tpu_torch.datasets.synthetic import (  # noqa: E402
    SyntheticDetectionDataset,
    make_batch,
)
import chip_smoke  # noqa: E402
from coda_neurips2023_tpu_torch.criterion import build_criterion  # noqa: E402
from coda_neurips2023_tpu_torch.engine import (  # noqa: E402
    TARGET_KEYS,
    last_layer,
    make_eval_step,
    make_train_step,
)
from coda_neurips2023_tpu_torch.models.helpers import reset_parameters  # noqa: E402
from coda_neurips2023_tpu_torch.models import distillation  # noqa: E402
from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR  # noqa: E402
from coda_neurips2023_tpu_torch.optimizer import build_optimizer  # noqa: E402
from coda_neurips2023_tpu_torch.stages import StageContext  # noqa: E402
from coda_neurips2023_tpu_torch.utils import spans  # noqa: E402

STEPS = 3
# the __global__ functions of the port's csrc/*.cu and *.cuh
PORT_KERNELS = {
    m.group(1)
    for src in (ROOT / "coda_neurips2023_tpu_torch" / "csrc").glob("*.cu*")
    for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                         src.read_text())
}


def last_solve_ms() -> float:
    """Host ms of the newest matcher:solve span (the last step's solve and
    copy back up)."""
    return next((1e3 * (s.t1 - s.t0) for s in reversed(spans.RING) if s.name == "matcher:solve"),
                float("nan"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=None, help="32 (eval) or 8 (--train)")
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--clip", action="store_true",
                    help="profile the CLIP-crop eval step of the baseline detector")
    ap.add_argument("--train", action="store_true",
                    help="profile the baseline detector's training step")
    ap.add_argument("--stage1", action="store_true",
                    help="profile CoDA's stage-1 distillation training step")
    args = ap.parse_args()
    training = args.train or args.stage1
    if args.batch is None:
        args.batch = 8 if training else 32
    if not torch.cuda.is_available():
        sys.exit("profile_torch_eval: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = SunrgbdAnonymousConfig()
    ds = SyntheticDetectionDataset(cfg, num_scenes=args.batch, num_points=args.points,
                                   with_images=args.clip or args.stage1, image_hw=(531, 730))
    batch = {k: torch.from_numpy(v).cuda() for k, v in make_batch(ds, 0, args.batch).items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = reset_parameters(
        CoDA3DETR(cfg, with_text_head=not (args.clip or args.train), device="cuda"), gen
    ).eval()
    criterion = ctx = None
    if args.stage1:
        os.environ["CODA_BQ_ALGO"] = "adaptive"
        train_args = types.SimpleNamespace(**{**chip_smoke.FLAGSHIP_ARGS, **chip_smoke.TRAIN_ARGS,
                                              **chip_smoke.STAGE1_ARGS})
        ctx = StageContext(train_args, cfg, device="cuda", generator=gen)
        criterion = build_criterion(train_args, cfg)
        optimizer, schedule = build_optimizer(train_args, model.train(), 600)
        train_step = ctx.make_fused_train_step(model, criterion, optimizer, lr_schedule=schedule)
        phases = {"image_tower": ctx.clip_model.visual}
        crop = distillation.clip_crops

        def timed_crop(*a, **kw):
            with torch.profiler.record_function("phase:crops"):
                return crop(*a, **kw)

        distillation.clip_crops = timed_crop

        def step(b):
            return train_step(b, gen)
    elif args.train:
        os.environ["CODA_BQ_FUSED_GATHER"] = "1"
        train_args = types.SimpleNamespace(**chip_smoke.TRAIN_ARGS)
        criterion = build_criterion(train_args, cfg)
        optimizer, schedule = build_optimizer(train_args, model.train(), 600)
        train_step = make_train_step(model, criterion, optimizer, lr_schedule=schedule)
        phases = {}

        def step(b):
            return train_step(b, gen)
    elif args.clip:
        stage_args = types.SimpleNamespace(
            train_range_max=10, test_range_max=46, if_clip_more_prompts=True,
            if_clip_superset=False, clip_model_path=None, dataset_name="sunrgbd",
        )
        ctx = StageContext(stage_args, SunrgbdImageConfig(), device="cuda", generator=gen)
        step = ctx.make_clip_eval_step(model)
        phases = {"detector": model, "image_tower": ctx.clip_model.visual}
        crop = distillation.clip_crops

        def timed_crop(*a, **kw):
            with torch.profiler.record_function("phase:crops"):
                return crop(*a, **kw)

        distillation.clip_crops = timed_crop
    else:
        text = torch.randn((46, 512), device="cuda", generator=gen)
        text = text / torch.linalg.vector_norm(text, dim=1, keepdim=True)
        step = make_eval_step(model, eval_text_features=text)
        # phases of the forward, as record_function ranges on the module calls
        phases = {
            "pre_encoder": model.pre_encoder, "encoder": model.encoder,
            "enc_to_dec": model.encoder_to_decoder_projection, "decoder": model.decoder,
        }
        phases.update({f"heads.{n}": m for n, m in model.mlp_heads.items()})
    for name, module in phases.items():  # the training step has its own ranges
        def pre(_m, _a, name=name):
            _m._range = torch.profiler.record_function("phase:" + name)
            _m._range.__enter__()

        def post(_m, _a, _o):
            _m._range.__exit__(None, None, None)

        module.register_forward_pre_hook(pre)
        module.register_forward_hook(post)

    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    if criterion is not None:
        print(f"matcher host ms (last step): {last_solve_ms()!r}")
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ranges = ("phase:", "train:")
    kernels = [e for e in on_device if not e.key.startswith(ranges)]
    dev_total = sum(e.self_device_time_total for e in kernels)
    print(f"device {torch.cuda.get_device_name(0)}; {STEPS} steps of B={args.batch} "
          f"x {args.points} points")
    print(f"wall {wall_us / STEPS / 1e3!r} ms/step; device busy {dev_total / STEPS / 1e3!r} "
          f"ms/step ({dev_total / wall_us!r} of wall)")
    print("device time by kernel (ms/step, share):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]:
        t = e.self_device_time_total
        print(f"  {t / STEPS / 1e3:10.3f}  {t / dev_total:6.1%}  x{e.count // STEPS:<5d} {e.key[:90]}")
    print("the port's kernels A-G (ms/step, launches/step), by csrc/ kernel function:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        # "void ns::name<args>(params)" or "(anonymous namespace)::name<args>(params)"
        key = e.key.removeprefix("void ").replace("(anonymous namespace)::", "")
        name = key.split("(")[0].split("::")[-1]
        if name.split("<")[0] in PORT_KERNELS:
            print(f"  {e.self_device_time_total / STEPS / 1e3:10.3f}  x{e.count // STEPS:<5d} {name}")
    print("device time by phase (ms/step, span on the device):")
    for e in on_device:
        if e.key.startswith(ranges):
            print(f"  {e.self_device_time_total / STEPS / 1e3:10.3f}  {e.key[6:]}")
    print("host time by phase (ms/step, the range on the host's clock):")
    for e in events:
        if e.key.startswith(ranges) and e.device_type == torch.autograd.DeviceType.CPU:
            print(f"  {e.cpu_time_total / STEPS / 1e3:10.3f}  {e.key[6:]}")
    if training:
        # the backward runs on autograd's device thread, outside the step's
        # ranges: time the step's parts again with a sync between them
        print("training step by part (ms/step, host clock with a sync at each boundary, median):")
        parts = {"forward": [], "targets": [], "criterion": [], "backward": [], "optimizer": []}
        tower_ms = []
        if ctx is not None:  # the image tower alone, synced around each call
            tower = ctx.clip_image_fn

            def synced_tower(images):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = tower(images)
                torch.cuda.synchronize()
                tower_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            ctx.clip_image_fn = synced_tower
            extra = ctx.extra_targets_fn()
        keys = [k for k in TARGET_KEYS if k in batch]
        for _ in range(STEPS):
            optimizer.zero_grad()
            torch.cuda.synchronize()
            t = [time.perf_counter()]
            outputs = model(batch, generator=gen)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            targets = {k: batch[k] for k in keys}
            if ctx is not None:
                with torch.no_grad():
                    targets.update(extra(outputs, batch, gen))
                torch.cuda.synchronize()
            t.append(time.perf_counter())
            loss, _ = criterion(outputs, targets)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            loss.backward()
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            optimizer.step(schedule(optimizer.count))
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            for name, a, b in zip(parts, t, t[1:]):
                parts[name].append((b - a) * 1e3)
        for name, ms in parts.items():
            if name != "targets" or ctx is not None:
                print(f"  {statistics.median(ms):10.3f}  {name}")
        if ctx is not None:
            tower = statistics.median(tower_ms)
            print(f"  {tower:10.3f}  of the targets, the image tower "
                  f"({args.batch * chip_smoke.N_SEL} crops)")
            print(f"  {statistics.median(parts['targets']) - tower:10.3f}  of the targets, the rest "
                  "(selection, rects, crops, scatter)")
        print(f"  {last_solve_ms():10.3f}  of which the matcher on the host")


if __name__ == "__main__":
    main()
