"""The secondary CLI modes (PyTorch).

Counterpart of coda_neurips2023_tpu/modes.py: each mode writes the same
files, under the same names, as the JAX mode.

  * `show_boxes` (--show_only): each scene's points as PLY, its predicted
    boxes (objectness > 0.5; with --if_after_nms only the 3D-NMS survivors)
    and ground-truth boxes as wireframe OBJ;
  * `save_box_points` (--show_box_points): for every predicted box with
    objectness >= 0.05 holding >= 5 points, its (centre, size, angle,
    objectness) row and those points as .npy;
  * `save_novel_boxes` (--save_novel_only, --save_novel_with_class_only):
    stage 2's discovery on the eval forward, written to each scene's
    `pseudo_box_path` (`StageContext.run_discovery_and_write`);
  * `save_seen_feats` (--save_seen_feat_only): CLIP embeddings of the
    ground-truth boxes' image crops, one .npy a scene;
  * `crop_boxes` (--crop_only): PNG crops of the highest-objectness boxes,
    written with OpenCV (cv2), which it needs;
  * `calculate_class_confusion` (--cal_class_only): counts of (matched
    ground-truth class, predicted class).

Each mode takes host batches (datasets.loader) and runs the forward on
`device`.  A batch's "pad_mask" (the loader's padded tail, which repeats
the last scene) is honoured: the padded rows write nothing and count
nothing.  The JAX package's run_mode drops the tail scenes instead (its
loader keeps drop_last), so on a split that is not a multiple of the batch
the port also writes the tail scenes' files.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from coda_neurips2023_tpu_torch.datasets.loader import to_device
from coda_neurips2023_tpu_torch.engine import DISCOVERY_OUTPUT_KEYS, last_layer
from coda_neurips2023_tpu_torch.models.distillation import crop_square_resize_white, preprocess_crops
from coda_neurips2023_tpu_torch.ops.projection import corners_to_image_rects, unaugment_corners
from coda_neurips2023_tpu_torch.utils.ap_calculator import flip_axis_to_depth_np, points_in_box_mask
from coda_neurips2023_tpu_torch.utils.nms import nms_3d_faster
from coda_neurips2023_tpu_torch.utils.ply import write_bbox_obj, write_ply


def _live(batch) -> int:
    """The rows of a host batch that are real scenes: the loader pads only
    the tail, so they are a prefix."""
    n = len(batch["scan_idx"])
    mask = batch.get("pad_mask")
    return n if mask is None else int(np.asarray(mask, bool).sum())


def _on_device(batch, device) -> dict:
    return to_device({k: v for k, v in batch.items()
                      if not isinstance(v, list) and k != "pad_mask"}, device)


@torch.inference_mode()
def _forward_last(model, batch) -> dict:
    """The eval forward's last decoder layer."""
    model.eval()
    return last_layer(model(batch))


def _to_host(outputs: dict, keys) -> dict:
    return {k: outputs[k].cpu().numpy() for k in keys}


def show_boxes(model, batches, out_dir: str, objectness_thresh: float = 0.5,
               after_nms: bool = False, device="cuda") -> int:
    """--show_only: `{scan:06d}_pc.ply`, `_pred_boxes.obj` and `_gt_boxes.obj`
    a scene; with `after_nms` the predicted boxes are the greedy 3D NMS's
    survivors (IoU 0.25 over the corners' axis-aligned extents).  Returns the
    scenes written."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for batch in batches:
        out = _to_host(_forward_last(model, _on_device(batch, device)),
                       ("objectness_prob", "box_corners_xyz"))
        pcs = np.asarray(batch["point_clouds"])
        for i in range(_live(batch)):
            scan = int(np.asarray(batch["scan_idx"])[i])
            write_ply(pcs[i, :, :3], os.path.join(out_dir, f"{scan:06d}_pc.ply"))
            keep = out["objectness_prob"][i] > objectness_thresh
            if after_nms and keep.any():
                corners = out["box_corners_xyz"][i]
                boxes = np.concatenate(
                    [corners.min(axis=1), corners.max(axis=1), out["objectness_prob"][i][:, None]],
                    axis=1,
                )
                pick = nms_3d_faster(boxes[keep], 0.25)
                idx = np.flatnonzero(keep)[pick]
                keep = np.zeros_like(keep)
                keep[idx] = True
            if keep.any():
                write_bbox_obj(out["box_corners_xyz"][i][keep],
                               os.path.join(out_dir, f"{scan:06d}_pred_boxes.obj"))
            gt_keep = np.asarray(batch["gt_box_present"])[i] > 0
            if gt_keep.any():
                write_bbox_obj(np.asarray(batch["gt_box_corners_xyz"])[i][gt_keep],
                               os.path.join(out_dir, f"{scan:06d}_gt_boxes.obj"))
            n += 1
    return n


def save_novel_boxes(model, batches, stage_ctx, with_class: bool = True, device="cuda") -> int:
    """Stage 2's discovery on the eval forward: each scene's novel rows
    (centre, size, angle, class, class probability, objectness) go to its
    pseudo_box_path.  The rows always carry their class, as the JAX mode's
    do, whatever `with_class` says.  Returns the novel rows found."""
    discovery = stage_ctx.discovery_fn()
    total = 0
    for batch in batches:
        live = _live(batch)
        dev = _on_device(batch, device)
        last = _forward_last(model, dev)
        needed = {k: last[k][:live] for k in DISCOVERY_OUTPUT_KEYS}
        scene = {k: v[:live] for k, v in dev.items()}
        if "pseudo_box_path" in batch:  # the host fields the writer reads
            scene["pseudo_box_path"] = list(batch["pseudo_box_path"][:live])
            scene["gt_ori_box_num"] = np.asarray(batch["gt_ori_box_num"])[:live]
        total += stage_ctx.run_discovery_and_write(discovery, needed, scene)
    return total


def save_seen_feats(model, batches, stage_ctx, out_dir: str, device="cuda") -> int:
    """`{scan:06d}_seen_feat.npy` a scene: the frozen CLIP image tower's
    embeddings of its ground-truth boxes' crops (projected through the
    scene's calibration, white-padded to a square, resized).  Each box's
    crop is independent of the others, so only the present boxes are
    encoded, one scene a tower call.  Returns the boxes written."""
    os.makedirs(out_dir, exist_ok=True)
    size = stage_ctx.crop_size
    n = 0
    for batch in batches:
        dev = _on_device(batch, device)
        b = dev["gt_box_corners_xyz"].shape[0]
        ones = torch.ones((b,), device=dev["ori_width"].device)
        with torch.inference_mode():
            rects, _ = corners_to_image_rects(
                dev["gt_box_corners_xyz"], dev["K"], dev["Rtilt"], dev["ori_width"],
                dev["ori_height"], dev["x_offset"], dev["y_offset"],
                dev.get("image_flip_array", ones), dev.get("flip_length", dev["ori_width"]),
            )
            images = dev["input_image"].to(torch.float32)
            present = np.asarray(batch["gt_box_present"]) > 0
            for i in range(_live(batch)):
                live = torch.from_numpy(present[i]).to(rects.device)
                emb = np.zeros((0, stage_ctx.clip_model.visual.proj.shape[1]), np.float32)
                if present[i].any():
                    crops = crop_square_resize_white(images[i], rects[i][live], size)
                    emb = stage_ctx.clip_image_fn(preprocess_crops(crops)).cpu().numpy()
                scan = int(np.asarray(batch["scan_idx"])[i])
                np.save(os.path.join(out_dir, f"{scan:06d}_seen_feat.npy"), emb)
                n += int(present[i].sum())
    return n


def crop_boxes(model, batches, stage_ctx, out_dir: str, max_per_scene: int = 8,
               device="cuda") -> int:
    """`{scan:06d}_{query:03d}.png`: the 224 x 224 crops of each scene's
    `max_per_scene` highest-objectness boxes (un-augmented by the scale,
    rotation and YZ flip, projected, white-padded to a square, resized).
    Needs OpenCV.  Returns the crops written."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("--crop_only writes PNGs with OpenCV (cv2), which this Python "
                          "does not have") from e

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for batch in batches:
        dev = _on_device(batch, device)
        last = _forward_last(model, dev)
        b = last["objectness_prob"].shape[0]
        ones = torch.ones((b,), device=last["objectness_prob"].device)
        with torch.inference_mode():
            un = unaugment_corners(
                last["box_corners_xyz"],
                dev.get("scale_array", torch.ones((b, 3), device=ones.device)),
                dev.get("rot_array", torch.eye(3, device=ones.device).expand(b, 3, 3)),
                dev.get("flip_array", ones),
            )
            rects, _ = corners_to_image_rects(
                un, dev["K"], dev["Rtilt"], dev["ori_width"], dev["ori_height"],
                dev["x_offset"], dev["y_offset"], dev.get("image_flip_array", ones),
                dev.get("flip_length", dev["ori_width"]),
            )
            objectness = last["objectness_prob"].cpu().numpy()
            for i in range(_live(batch)):
                order = np.argsort(-objectness[i])[:max_per_scene]
                scan = int(np.asarray(batch["scan_idx"])[i])
                img = dev["input_image"][i].to(torch.float32)
                sel = torch.from_numpy(order).to(rects.device)
                crops = crop_square_resize_white(img, rects[i][sel], 224).cpu().numpy()
                for j, crop in zip(order, crops.astype(np.uint8)):
                    cv2.imwrite(os.path.join(out_dir, f"{scan:06d}_{int(j):03d}.png"),
                                cv2.cvtColor(crop, cv2.COLOR_RGB2BGR))
                    n += 1
    return n


def calculate_class_confusion(eval_step, batches, num_classes: int, device="cuda") -> np.ndarray:
    """(num_classes, num_classes) counts of (ground-truth class of the
    nearest ground-truth centre, predicted argmax class) over the boxes with
    objectness > 0.5."""
    confusion = np.zeros((num_classes, num_classes), np.int64)
    for batch in batches:
        out = {k: v.cpu().numpy() for k, v in eval_step(_on_device(batch, device)).items()}
        pred_cls = np.argmax(out["sem_cls_prob"], -1)
        obj = out["objectness_prob"]
        gt_cls = np.asarray(batch["gt_box_sem_cls_label"])
        gt_present = np.asarray(batch["gt_box_present"])
        gt_centers = np.asarray(batch["gt_box_centers"])
        centers = out["center_unnormalized"]
        for i in range(_live(batch)):
            live = gt_present[i] > 0
            if not live.any():
                continue
            gts = gt_centers[i][live]
            gcls = gt_cls[i][live]
            for j in range(pred_cls.shape[1]):
                if obj[i, j] <= 0.5:
                    continue
                d = np.linalg.norm(gts - centers[i, j], axis=1)
                g = int(gcls[np.argmin(d)])
                p = int(pred_cls[i, j])
                if g < num_classes and p < num_classes:
                    confusion[g, p] += 1
    return confusion


def save_box_points(model, batches, out_dir: str, objectness_thresh: float = 0.05,
                    min_points: int = 5, device="cuda") -> int:
    """--show_box_points: for every predicted box with objectness >=
    `objectness_thresh` holding >= `min_points` points (the AP stack's
    in-hull test), `{stem}_{box:04d}_pred_box.npy` (centre, size, angle,
    objectness) and `..._pred_pc.npy` (those points); the stem is the
    image's file name, else the scan index.  Returns the boxes written."""
    os.makedirs(out_dir, exist_ok=True)
    keys = ("box_corners", "objectness_prob", "center_unnormalized", "size_unnormalized",
            "angle_continuous")
    n_written = 0
    for batch in batches:
        out = _to_host(_forward_last(model, _on_device(batch, device)), keys)
        pcs = np.asarray(batch["point_clouds"])
        names = batch.get("im_name")
        for i in range(_live(batch)):
            if names is not None:
                stem = os.path.basename(str(names[i])).rsplit(".", 1)[0]
            else:
                stem = f"{int(np.asarray(batch['scan_idx'])[i]):06d}"
            for j in range(out["box_corners"].shape[1]):
                obj = float(out["objectness_prob"][i, j])
                if obj < objectness_thresh:
                    continue
                box3d = flip_axis_to_depth_np(out["box_corners"][i, j])
                mask = points_in_box_mask(pcs[i, :, :3], box3d)
                if mask.sum() < min_points:
                    continue
                row = np.concatenate([
                    out["center_unnormalized"][i, j], out["size_unnormalized"][i, j],
                    [float(out["angle_continuous"][i, j])], [obj],
                ])[None]
                np.save(os.path.join(out_dir, f"{stem}_{j:04d}_pred_box.npy"), row)
                np.save(os.path.join(out_dir, f"{stem}_{j:04d}_pred_pc.npy"), pcs[i][mask])
                n_written += 1
    return n_written
