"""The reference's entry points: the dataset configs, the detector, CLIP and
its text banks, the criterion and AdamW from main's flags, and the steps the
benchmark holds the program's against.  Plain PyTorch throughout (the
modules beside this one are a frozen copy of the port's plain paths); it
imports nothing of the program.

`train_step` is the port's `engine.make_train_step` on one process (forward,
stage 1's distillation targets from that forward under no_grad, criterion,
backward, AdamW), `step_generator` the port's per-step generator, and
`clip_eval_scores` the CLIP-crop eval's class scores of given boxes.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from portbench.reference.criterion import build_criterion
from portbench.reference.datasets.config import (
    SunrgbdAnonymousConfig,
    SunrgbdImageConfig,
    load_cmp_names,
)
from portbench.reference.models import build_model
from portbench.reference.models.clip import CLIP
from portbench.reference.models.distillation import (
    build_clip_distillation_targets,
    clip_crop_scores,
    select_distillation_boxes,
)
from portbench.reference.models.text_bank import build_text_banks
from portbench.reference.optimizer import build_optimizer

TARGET_KEYS = (
    "gt_box_corners", "gt_box_centers_normalized", "gt_box_sizes_normalized",
    "gt_box_angles", "gt_angle_class_label", "gt_angle_residual_label",
    "gt_box_sem_cls_label", "gt_box_present", "gt_box_seen_sem_cls_label",
    "gt_box_seen_sem_cls_confi",
)
EVAL_KEYS = (
    "box_corners", "sem_cls_prob", "objectness_prob", "center_unnormalized",
    "size_unnormalized", "angle_continuous",
)
LOGIT_SCALE = 100.0  # a random CLIP's, as the program takes it


def dataset_configs(args):
    """(training config, eval config) of SUN RGB-D for main's flags."""
    kw = dict(asset_dir=None, use_v1=getattr(args, "if_use_v1", True),
              train_range=(args.train_range_min, args.train_range_max),
              test_range=(args.test_range_min, args.test_range_max),
              image_size=(args.image_size_width, args.image_size_height))
    return SunrgbdAnonymousConfig(**kw), SunrgbdImageConfig(num_semcls=args.test_num_semcls, **kw)


def text_banks(args, eval_config, clip: CLIP) -> dict:
    banks = build_text_banks(
        eval_config, train_range_max=args.train_range_max, test_range_max=args.test_range_max,
        superset_names=None, cmp_names=load_cmp_names(None, scannet=False),
        seen_idx=getattr(eval_config, "seen_vocab_idx", None) or None,
        if_clip_more_prompts=args.if_clip_more_prompts, clip_model=clip,
    )
    banks.pop("superset_prompts", None)
    device = next(clip.parameters()).device
    return {k: torch.from_numpy(v).to(device) for k, v in banks.items()}


def build(args, device, with_clip: bool, iters_per_epoch: int = 1):
    """SimpleNamespace(model, criterion, optimizer, clip, banks, configs)."""
    train_cfg, eval_cfg = dataset_configs(args)
    model, _ = build_model(args, train_cfg, device=device)
    optimizer, _ = build_optimizer(args, model, iters_per_epoch)
    clip = CLIP(device=device).eval().requires_grad_(False) if with_clip else None
    return SimpleNamespace(model=model, criterion=build_criterion(args, train_cfg),
                           optimizer=optimizer, clip=clip, train_config=train_cfg,
                           eval_config=eval_cfg)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of training step `step` of a one-process run seeded `seed`."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def needs_distillation(args) -> bool:
    return (args.loss_predicted_region_embed_l1_weight > 1e-32
            or args.loss_feat_seen_softmax_weakly_loss_with_novel_cate_confi_weight > 1e-32
            or args.loss_contrast_object_text > 1e-32)


def last_layer(outputs: dict) -> dict:
    return {k: v[-1] for k, v in outputs.items() if k not in ("query_xyz", "enc_xyz", "enc_inds")}


CROP_KEYS = ("box_corners_xyz", "size_unnormalized")  # what a crop's rect is made from


def train_step(ref, args, banks, batch: dict, lr: float, generator, boxes=None, seen=None):
    """One training step of `ref` on `batch` (tensors on the device, with
    curr_epoch and all_epoch); returns the loss.  Leaves the gradients in
    .grad and the update in the parameters and AdamW's state.

    Stage 1's crops are cut from `boxes` (CROP_KEYS of a last decoder layer)
    where given, else from this forward's own; `seen`, where given, receives
    the boxes, the selection and the targets."""
    model, criterion, optimizer = ref.model, ref.criterion, ref.optimizer
    model.train()
    optimizer.zero_grad()
    outputs = model(batch, generator=generator)
    targets = {k: batch[k] for k in TARGET_KEYS}
    if ref.clip is not None:
        text = banks["train"][: args.train_range_max]
        targets.update(text_features_clip=text,
                       logit_scale=torch.tensor(LOGIT_SCALE, device=text.device))
        if needs_distillation(args):
            with torch.no_grad():
                last = last_layer(outputs)
                b, nq = last["objectness_prob"].shape
                sel = select_distillation_boxes(generator, b, nq, args.distillation_box_num,
                                                None, False, device=text.device)
                crops_from = dict(last, **boxes) if boxes is not None else last
                distill = build_clip_distillation_targets(
                    crops_from, batch, clip_image_fn(ref.clip), sel, text_features=text,
                    logit_scale=LOGIT_SCALE, if_clip_weak_labels=args.if_clip_weak_labels,
                    train_range_max=args.train_range_max)
                targets.update(distill)
                if seen is not None:
                    seen.update(boxes={k: last[k] for k in CROP_KEYS}, sel=sel, **distill)
    loss, _ = criterion(outputs, targets)
    loss.backward()
    optimizer.step(lr)
    return loss.detach()


def clip_image_fn(clip: CLIP):
    def fn(images):
        with torch.no_grad():
            return clip.encode_image(images)
    return fn


@torch.no_grad()
def eval_outputs(ref, batch: dict) -> dict:
    """The eval forward's last layer (every key; sem_cls_prob is the
    detector's own until `clip_eval_scores` replaces it)."""
    ref.model.eval()
    return last_layer(ref.model(batch))


@torch.no_grad()
def clip_eval_scores(ref, banks, boxes: dict, batch: dict) -> torch.Tensor:
    """The CLIP-crop eval's sem_cls_prob of the crops cut from `boxes`
    (CROP_KEYS of a last decoder layer), against the test bank."""
    return clip_crop_scores(boxes, batch, clip_image_fn(ref.clip), banks["test"], LOGIT_SCALE)
