"""Stage-2 online novel-object discovery (PyTorch).

Counterpart of coda_neurips2023_tpu/models/discovery.py.  On the save epochs
of stage 2 the last decoder layer's boxes of a training step are mined for
novel-object pseudo labels (`discover_novel_boxes`, :96-230), in this order:

  1. un-augment the boxes (centre, size, angle, and the corners) back to the
     scene's un-augmented frame;
  2. project the corners to integer image rects (ops/projection.py); a box of
     zero size, a degenerate rect or a corner behind the camera is invalid
     and scores -1;
  3. greedy 2D NMS at IoU 0.25 over the rects (`nms_2d_greedy_mask`);
  4. drop survivors whose axis-aligned 3D IoU with a ground-truth box of the
     scene exceeds 0.25 (`aabb_iou_3d`);
  5. keep those of objectness >= save_objectness;
  6. compact the survivors into `max_discovery_crops` (32) slots by score,
     crop them (`distillation.crop_square_resize_white`), and classify the
     crops with CLIP against the (superset) text bank: a box stays when its
     top probability exceeds clip_driven_keep_thres and its class is not a
     seen one (argmax >= train_range_max);
  7. scatter the slots back to (B, nq, 10) rows [centre(3), size(3), angle,
     class, class probability, objectness] and a (B, nq) mask.

Steps 1-7 run on the device with fixed shapes and no host round trip;
`write_pseudo_labels` (:233-254) appends each scene's rows to its
`_novel_bbox.npy` on the host.  The JAX package has no Pallas kernel here:
the NMS is plain PyTorch, a loop of nq steps over (B, nq) tensors, as the
JAX package's fori_loop is over one scene's nq.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from coda_neurips2023_tpu_torch.models.distillation import (
    crop_square_resize_white,
    preprocess_crops,
)
from coda_neurips2023_tpu_torch.ops.projection import corners_to_image_rects, unaugment_corners

# what `discover_novel_boxes` reports beside its rows: the survivors gate by
# gate, then among the crops CLIP classified, the top class probability's
# largest value and the count whose top class is not a seen one
GATES = ("valid", "nms", "not_seen_gt", "objectness", "clip", "clip_top_prob", "not_seen_class")


def nms_2d_greedy_mask(boxes, scores, iou_threshold: float):
    """torchvision.ops.nms semantics on the device, for a batch of scenes:
    boxes (B, N, 4) [y1, x1, y2, x2] (any consistent corner convention),
    scores (B, N) -> keep mask (B, N) bool.  Each of N steps takes the
    highest-scoring box still alive (the first index among equal scores, as
    torch.argmax and jnp.argmax take it), keeps it, and retires it and every
    box whose IoU with it exceeds the threshold."""
    b, n = scores.shape
    y1, x1, y2, x2 = boxes.unbind(-1)
    area = torch.clamp(y2 - y1, min=0) * torch.clamp(x2 - x1, min=0)
    rows = torch.arange(b, device=scores.device)
    cols = torch.arange(n, device=scores.device)
    keep = torch.zeros((b, n), dtype=torch.bool, device=scores.device)
    alive = torch.ones((b, n), dtype=torch.bool, device=scores.device)
    neg_inf = torch.full_like(scores, -math.inf)
    for _ in range(n):
        cand = torch.where(alive, scores, neg_inf)
        i = torch.argmax(cand, dim=1)
        valid = cand[rows, i] > -math.inf
        keep[rows, i] |= valid

        def at(x):
            return x[rows, i][:, None]

        inter = (torch.clamp(torch.minimum(at(y2), y2) - torch.maximum(at(y1), y1), min=0)
                 * torch.clamp(torch.minimum(at(x2), x2) - torch.maximum(at(x1), x1), min=0))
        iou = inter / torch.clamp(at(area) + area - inter, min=1e-12)
        suppress = (iou > iou_threshold) | (cols[None, :] == i[:, None])
        alive = torch.where(valid[:, None], alive & ~suppress, alive)
    return keep


def aabb_iou_3d(boxes_a, boxes_b):
    """(..., N, 6) x (..., M, 6) [xmin ymin zmin xmax ymax zmax] -> (..., N, M)
    IoU."""
    lo = torch.maximum(boxes_a[..., :, None, :3], boxes_b[..., None, :, :3])
    hi = torch.minimum(boxes_a[..., :, None, 3:], boxes_b[..., None, :, 3:])
    inter = torch.prod(torch.clamp(hi - lo, min=0), dim=-1)
    vol_a = torch.prod(boxes_a[..., 3:] - boxes_a[..., :3], dim=-1)
    vol_b = torch.prod(boxes_b[..., 3:] - boxes_b[..., :3], dim=-1)
    return inter / torch.clamp(vol_a[..., :, None] + vol_b[..., None, :] - inter, min=1e-12)


def _corners_to_aabb(corners):
    return torch.cat([corners.amin(dim=-2), corners.amax(dim=-2)], dim=-1)


def _flip_angle(angle, flip):
    return torch.where(flip[:, None] < 0, math.pi - angle, angle)


@torch.no_grad()
def discover_novel_boxes(outputs_last: dict, batch: dict, clip_image_fn, superset_text_features,
                         logit_scale, train_range_max: int, save_objectness: float = 0.3,
                         clip_driven_keep_thres: float = 0.3, nms_iou: float = 0.25,
                         gt_iou_thres: float = 0.25, max_discovery_crops: int = 32,
                         crop_size: int = 224) -> dict:
    """{"save_box_info": (B, nq, 10), "novel_mask": (B, nq) bool, "gates":
    (len(GATES),) float32, the batch's GATES} on the
    outputs' device.  `outputs_last` holds the last decoder layer's
    box_corners(_xyz), center_unnormalized, size_unnormalized,
    angle_continuous and objectness_prob; `batch` the scenes' images,
    calibration, augmentation and ground truth; `clip_image_fn` maps
    (N, S, S, 3) normalised crops to (N, D)."""
    corners_xyz = outputs_last["box_corners_xyz"]
    b, nq = corners_xyz.shape[:2]
    max_discovery_crops = min(max_discovery_crops, nq)
    objectness = outputs_last["objectness_prob"]
    size_unnorm = outputs_last["size_unnormalized"]

    zx = batch.get("zx_flip_array")
    un_corners = unaugment_corners(corners_xyz, batch["scale_array"], batch["rot_array"],
                                   batch["flip_array"], zx)
    rects, min_depth = corners_to_image_rects(
        un_corners, batch["K"], batch["Rtilt"], batch["ori_width"], batch["ori_height"],
        batch["x_offset"], batch["y_offset"], batch["image_flip_array"], batch["flip_length"],
    )

    # the un-augmented box parameters of the saved rows
    scale = batch["scale_array"][:, None, :]
    ori_center = torch.einsum("bqi,bij->bqj", outputs_last["center_unnormalized"] * scale,
                              batch["rot_array"])
    ori_size = size_unnorm * scale
    ori_angle = outputs_last["angle_continuous"] + batch["rot_angle"][:, None]
    if zx is not None:
        ori_center = ori_center * torch.stack(
            [torch.ones_like(zx), zx, torch.ones_like(zx)], -1)[:, None, :]
        ori_angle = _flip_angle(ori_angle, zx)
    flip = batch["flip_array"]
    ori_center = ori_center * torch.stack(
        [flip, torch.ones_like(flip), torch.ones_like(flip)], -1)[:, None, :]
    ori_angle = _flip_angle(ori_angle, flip)

    valid = ((size_unnorm.amax(dim=-1) >= 1e-16)
             & (rects[..., 2] - rects[..., 0] > 0)
             & (rects[..., 3] - rects[..., 1] > 0)
             & (min_depth >= 0))
    scores = torch.where(valid, objectness, torch.full_like(objectness, -1.0))

    # 2D NMS per scene over [ymin, xmin, ymax, xmax]; an invalid box takes the
    # dummy rect (0, 0, 2, 2), as the reference does
    nms_boxes = torch.stack([rects[..., 1], rects[..., 0], rects[..., 3], rects[..., 2]],
                            dim=-1).to(torch.float32)
    dummy = torch.tensor([0.0, 0.0, 2.0, 2.0], device=nms_boxes.device)
    nms_boxes = torch.where(valid[..., None], nms_boxes, dummy)
    keep_nms = nms_2d_greedy_mask(nms_boxes, scores, nms_iou)

    # drop boxes overlapping the scene's ground truth (axis-aligned 3D IoU)
    iou = aabb_iou_3d(_corners_to_aabb(outputs_last["box_corners"]),
                      _corners_to_aabb(batch["gt_box_corners"]))
    iou = torch.where(batch["gt_box_present"][:, None, :] > 0, iou, torch.zeros_like(iou))
    overlaps_gt = iou.amax(dim=2) > gt_iou_thres

    save_mask = keep_nms & ~overlaps_gt & (scores >= save_objectness) & valid

    # compact the survivors into max_discovery_crops slots by score
    comp_scores = torch.where(save_mask, scores, torch.full_like(scores, -math.inf))
    top_idx = torch.topk(comp_scores, max_discovery_crops, dim=1).indices  # (B, S)
    slot_valid = torch.gather(save_mask, 1, top_idx)
    sel_rects = torch.gather(rects, 1, top_idx[..., None].expand(-1, -1, 4))
    crops = torch.cat([
        crop_square_resize_white(batch["input_image"][i].to(torch.float32), sel_rects[i],
                                 crop_size)
        for i in range(b)
    ])
    emb = clip_image_fn(preprocess_crops(crops)).to(torch.float32)
    emb = emb.reshape(b, max_discovery_crops, -1)
    emb = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-32)
    logits = torch.matmul(emb, superset_text_features.to(torch.float32).t())
    probs = torch.softmax(logits * logit_scale, dim=-1)
    max_score, max_idx = torch.max(probs, dim=-1)
    novel_slot = slot_valid & (max_score > clip_driven_keep_thres) & (max_idx >= train_range_max)

    # scatter the slots back to (B, nq)
    novel_mask = torch.zeros((b, nq), dtype=torch.bool, device=scores.device)
    novel_mask = novel_mask.scatter(1, top_idx, novel_slot)
    cls_full = torch.full((b, nq), -1.0, device=scores.device).scatter(
        1, top_idx, torch.where(novel_slot, max_idx.to(torch.float32), -1.0))
    prob_full = torch.zeros((b, nq), device=scores.device).scatter(
        1, top_idx, torch.where(novel_slot, max_score, 0.0))
    save_box_info = torch.cat([
        ori_center, ori_size, ori_angle[..., None], cls_full[..., None], prob_full[..., None],
        torch.where(novel_mask, scores, torch.zeros_like(scores))[..., None],
    ], dim=-1)
    not_gt = keep_nms & valid & ~overlaps_gt
    gates = torch.stack([valid.sum(), (keep_nms & valid).sum(), not_gt.sum(), save_mask.sum(),
                         novel_mask.sum()]).to(torch.float32)
    gates = torch.cat([gates, torch.stack([
        torch.where(slot_valid, max_score, torch.zeros_like(max_score)).amax(),
        (slot_valid & (max_idx >= train_range_max)).sum().to(torch.float32)])])
    return {"save_box_info": save_box_info, "novel_mask": novel_mask, "gates": gates}


def write_pseudo_labels(save_box_info: np.ndarray, novel_mask: np.ndarray, pseudo_box_paths: list,
                        gt_ori_box_num: np.ndarray, accumulate: bool = True,
                        max_num_obj: int = 64) -> int:
    """Host writer (reference model_3detr.py:1515-1541): each scene's novel
    rows go to its `_novel_bbox.npy` (after the rows already there with
    `accumulate`), at most max_num_obj - gt_ori_box_num of them a round.
    Returns the number of rows written this round."""
    written = 0
    for i, path in enumerate(pseudo_box_paths):
        if not path or path == "_":
            continue
        rows = save_box_info[i][novel_mask[i]]
        budget = max(max_num_obj - int(gt_ori_box_num[i]), 0)
        rows = rows[:budget]
        if rows.shape[0] == 0:
            continue
        written += rows.shape[0]
        if accumulate and os.path.exists(path):
            former = np.load(path)
            rows = rows if former.shape[0] == 0 else np.concatenate([former, rows], 0)
        np.save(path, rows)
    return written
