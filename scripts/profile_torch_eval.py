#!/usr/bin/env python3
"""Where the port's eval step spends its time on the GPU.

    python3 scripts/profile_torch_eval.py [--batch 32] [--points 20000] [--clip]

Builds the flagship CoDA model (random weights from a seed), warms the eval
step up, then traces STEPS steps with torch.profiler and prints the device
time by kernel, the device time by phase of the forward (record_function
ranges), and the device's busy share of the traced wall time.  With --clip
it profiles the baseline detector's CLIP-crop eval step instead (ViT-B/16,
531 x 730 images), with the detector, the crops and the image tower as
phases.  Needs a GPU.
"""

import argparse
import os
import sys
import time
import types

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from coda_neurips2023_tpu_torch.datasets.config import (  # noqa: E402
    SunrgbdAnonymousConfig,
    SunrgbdImageConfig,
)
from coda_neurips2023_tpu_torch.datasets.synthetic import (  # noqa: E402
    SyntheticDetectionDataset,
    make_batch,
)
from coda_neurips2023_tpu_torch.engine import make_eval_step  # noqa: E402
from coda_neurips2023_tpu_torch.models.helpers import reset_parameters  # noqa: E402
from coda_neurips2023_tpu_torch.models import distillation  # noqa: E402
from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR  # noqa: E402
from coda_neurips2023_tpu_torch.stages import StageContext  # noqa: E402

STEPS = 3


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--clip", action="store_true",
                    help="profile the CLIP-crop eval step of the baseline detector")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_eval: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = SunrgbdAnonymousConfig()
    ds = SyntheticDetectionDataset(cfg, num_scenes=args.batch, num_points=args.points,
                                   with_images=args.clip, image_hw=(531, 730))
    batch = {k: torch.from_numpy(v).cuda() for k, v in make_batch(ds, 0, args.batch).items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = reset_parameters(
        CoDA3DETR(cfg, with_text_head=not args.clip, device="cuda"), gen
    ).eval()
    if args.clip:
        stage_args = types.SimpleNamespace(
            train_range_max=10, test_range_max=46, if_clip_more_prompts=True,
            if_clip_superset=False, clip_model_path=None, dataset_name="sunrgbd",
        )
        ctx = StageContext(stage_args, SunrgbdImageConfig(), device="cuda", generator=gen)
        step = ctx.make_clip_eval_step(model)
        phases = {"detector": model, "image_tower": ctx.clip_model.visual}
        crop = distillation.crop_square_resize_white

        def timed_crop(*a, **kw):
            with torch.profiler.record_function("phase:crops"):
                return crop(*a, **kw)

        distillation.crop_square_resize_white = timed_crop
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
    for name, module in phases.items():
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

    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in on_device if not e.key.startswith("phase:")]
    dev_total = sum(e.self_device_time_total for e in kernels)
    print(f"device {torch.cuda.get_device_name(0)}; {STEPS} steps of B={args.batch} "
          f"x {args.points} points")
    print(f"wall {wall_us / STEPS / 1e3!r} ms/step; device busy {dev_total / STEPS / 1e3!r} "
          f"ms/step ({dev_total / wall_us!r} of wall)")
    print("device time by kernel (ms/step, share):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]:
        t = e.self_device_time_total
        print(f"  {t / STEPS / 1e3:10.3f}  {t / dev_total:6.1%}  x{e.count // STEPS:<5d} {e.key[:90]}")
    print("device time by phase (ms/step, span on the device):")
    for e in on_device:
        if e.key.startswith("phase:"):
            print(f"  {e.self_device_time_total / STEPS / 1e3:10.3f}  {e.key[6:]}")


if __name__ == "__main__":
    main()
