"""CLIP crops of predicted boxes: zero-shot scores and distillation targets (PyTorch).

Counterpart of coda_neurips2023_tpu/models/distillation.py.  The eval path of
the baseline detector with --if_with_clip (`clip_crop_scores`, :51-254):

  1. un-augment the predicted corners, project them through K and Rtilt to
     integer crop rects in padded-image coordinates (ops/projection.py), and
     optionally grow each rect to a square (`expand_box`);
  2. crop every rect out of the scene's image, white-pad it to a centred
     square and resize it to the crop size with bicubic+antialias
     (torchvision's tensor path, PIL's a = -0.5 kernel), rounded to integral
     values.  As in the JAX package the resample is two dense interpolation
     matrices over the original image axes plus a separable white-mass term
     (`crop_square_resize_white_plain`), so no square is materialised;
  3. CLIP-normalise the crops, encode them with the frozen image tower, and
     take the softmax of their cosine against a text bank times the logit
     scale; invalid boxes keep all-zero rows.

Steps 2 and 3's crops and normalisation are `clip_crops`, for every scene of
a batch at once: on the card one launch of the crop kernel (csrc/crop.cu,
the same weights and rounding in one pass, nothing read back to the host),
on the CPU the plain path a scene at a time.  Crops go through the tower
one scene at a time (the JAX package maps over scenes the same way), so at
ViT-B/16 and 128 queries a tower call is 128 crops.

The training half (:257-461), stage 1's distillation targets:
`select_distillation_boxes` draws, per scene, the `distillation_box_num`
proposals to crop (a random permutation's prefix; with
--if_select_box_by_objectness, once enabled, foreground boxes first in query
order, then the rest in random order), from an explicit torch.Generator.
The JAX package draws the same selection with jax.random inside
build_clip_distillation_targets (:386-407); the port cannot reproduce those
bits, so the selection is a separate step and the port's
`build_clip_distillation_targets` takes it as `sel`.
That function crops the selected boxes of every scene, sends all B * n_sel
crops through the frozen tower in one call (as the JAX package vmaps them),
and scatters the embeddings and their validity mask back to the proposals;
`keep_novel_boxes_as_gt` (--if_keep_box) appends confident novel boxes to
the ground truth, and --if_clip_weak_labels adds CLIP's weak labels.

`crop_square_resize_white_bilinear` is the JAX package's bilinear crop
variant (:139-163, hat-kernel interpolation matrices, the white padding
masked after the interpolation), which its
scripts/measure_discovery_deviations.py holds against the bicubic path;
no path of either package crops with it.
"""

from __future__ import annotations

import math

import torch

from coda_neurips2023_tpu_torch import _kernels
from coda_neurips2023_tpu_torch.models.clip import IMAGE_MEAN, IMAGE_STD
from coda_neurips2023_tpu_torch.ops.projection import corners_to_image_rects, unaugment_corners
from coda_neurips2023_tpu_torch.utils.spans import span


def _cubic_kernel(x):
    """PIL / torch-antialias cubic convolution kernel, a = -0.5."""
    ax = torch.abs(x)
    near = ((1.5 * ax - 2.5) * ax) * ax + 1.0
    far = ((-0.5 * ax + 2.5) * ax - 4.0) * ax + 2.0
    return torch.where(ax <= 1.0, near, torch.where(ax < 2.0, far, torch.zeros_like(ax)))


def _bicubic_matrix(edge, crop_min, begin, crop_len, size_img: int, out_size: int,
                    max_taps: int):
    """Bicubic+antialias interpolation matrices over the original image axis,
    for a batch of crops (leading dims of the (...,) arguments).

    The crop [crop_min, crop_min + crop_len) sits at offset `begin` in a
    virtual white square of side `edge`, resized to `out_size`:
    center_o = (o + 0.5) * edge / out, filter scale s = max(edge / out, 1),
    window [max(center - 2s + .5, 0), min(center + 2s + .5, edge)) truncated
    at the square, weights cubic((t - center + .5) / s) normalised over the
    full window, white taps included.  Returns (K (..., out, size_img), the
    in-crop weights by image coordinate; m (..., out), their row sums), so the
    white share of a separable crop is 1 - m_y[:, None] * m_x[None].
    `max_taps` must be >= 4 * max(edge / out, 1) + 2 for every edge.
    """
    dev = edge.device
    edge_f = edge.to(torch.float32)[..., None]
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    scale_raw = edge_f / out_size
    center = scale_raw * (o + 0.5)  # (..., out)
    scale = torch.clamp(scale_raw, min=1.0)
    support = 2.0 * scale
    tmin = torch.clamp(torch.floor(center - support + 0.5), min=0.0)
    tend = torch.minimum(torch.floor(center + support + 0.5), edge_f)
    # full-window normaliser, including taps that land on the white padding
    k = torch.arange(max_taps, dtype=torch.float32, device=dev)
    t_full = tmin[..., None] + k
    w_full = _cubic_kernel((t_full - center[..., None] + 0.5) / scale[..., None])
    w_full = w_full * (t_full < tend[..., None])
    norm = torch.sum(w_full, dim=-1)
    norm = torch.where(norm > 0, norm, torch.ones_like(norm))  # degenerate rect
    # dense in-crop weights addressed by image coordinate
    r = torch.arange(size_img, dtype=torch.float32, device=dev)
    t_r = (r - crop_min.to(torch.float32)[..., None] + begin[..., None])[..., None, :]
    w = _cubic_kernel((t_r - center[..., None] + 0.5) / scale[..., None])
    w = w * (t_r >= tmin[..., None]) * (t_r < tend[..., None])
    in_crop = (r >= crop_min[..., None]) & (r < (crop_min + crop_len).to(torch.float32)[..., None])
    kmat = w * in_crop[..., None, :] / norm[..., None]
    return kmat, torch.sum(kmat, dim=-1)


def _crop_max_taps(h_img: int, w_img: int, out_size: int) -> int:
    return int(math.ceil(4.0 * max(1.0, max(h_img, w_img) / out_size))) + 2


def _crop_unrounded(image, rects, out_size: int):
    """The plain path's crops before the clamp and the rounding: the vertical
    sums first, then the horizontal ones, then the white share."""
    h_img, w_img = image.shape[0], image.shape[1]
    xmin, ymin, xmax, ymax = rects.unbind(-1)
    w = ymax - ymin  # vertical extent (the reference's naming)
    h = xmax - xmin  # horizontal extent
    max_edge = torch.maximum(w, h)
    y_begin = ((max_edge - w) // 2).to(torch.float32)
    x_begin = ((max_edge - h) // 2).to(torch.float32)

    max_taps = _crop_max_taps(h_img, w_img, out_size)
    ky, my = _bicubic_matrix(max_edge, ymin, y_begin, w, h_img, out_size, max_taps)
    kx, mx = _bicubic_matrix(max_edge, xmin, x_begin, h, w_img, out_size, max_taps)
    tmp = torch.einsum("...oh,hwc->...owc", ky, image)
    val = torch.einsum("...pw,...owc->...opc", kx, tmp)
    return val + 255.0 * (1.0 - my[..., :, None] * mx[..., None, :])[..., None]


def crop_square_resize_white_plain(image, rects, out_size: int = 224):
    """Plain PyTorch version of `crop_square_resize_white`, on any device."""
    return torch.round(torch.clamp(_crop_unrounded(image, rects, out_size), 0.0, 255.0))


def crop_square_resize_white(image, rects, out_size: int = 224):
    """image (H, W, 3) in [0, 255], float (or uint8 on the card); rects
    (..., 4) int32 [xmin, ymin, xmax, ymax] inside the image ->
    (..., out_size, out_size, 3): each rect cropped, white-padded to a
    centred square, bicubic+antialias resized and rounded (half to even, as
    jnp.round) to integral values in [0, 255].  On a CUDA tensor one launch
    of the crop kernel, else the plain path."""
    if image.device.type == "cpu":
        return crop_square_resize_white_plain(image, rects, out_size)
    flat = rects.reshape(-1, 4)
    scene = torch.zeros((flat.shape[0],), dtype=torch.int32, device=image.device)
    crops = _crop_kernel(image[None], flat, scene, out_size, normalize=False)
    return crops.reshape(*rects.shape[:-1], out_size, out_size, 3)


def _crop_kernel(images, rects, scene, out_size: int, normalize: bool):
    """csrc/crop.cu: images (B, H, W, 3) uint8 or float32, rects (N, 4) and
    scene (N,) int32 -> (N, S, S, 3) float32, each rect of its scene's image
    through crop_square_resize_white and, with `normalize`, preprocess_crops.
    One launch; the taps a window come from H and W (_crop_max_taps)."""
    b, h, w, c = images.shape
    n = rects.shape[0]
    if c != 3 or images.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"crop: images (B, H, W, 3) uint8 or float32, got {tuple(images.shape)} "
                         f"{images.dtype}")
    if rects.shape != (n, 4) or scene.shape != (n,) or rects.dtype != torch.int32 \
            or scene.dtype != torch.int32:
        raise ValueError(f"crop: rects (N, 4) and scene (N,) int32, got {tuple(rects.shape)} "
                         f"{rects.dtype} and {tuple(scene.shape)} {scene.dtype}")
    if not (images.is_contiguous() and rects.is_contiguous() and scene.is_contiguous()):
        raise ValueError("crop: images, rects and scene must be contiguous")
    if not (rects.device == scene.device == images.device):
        raise ValueError("crop: images, rects and scene must be on one device")
    _kernels.check_no_grad("crop", images)
    out = torch.empty((n, out_size, out_size, 3), dtype=torch.float32, device=images.device)
    _kernels.launch("coda_crop", images, rects, scene, out, n, b, h, w, out_size,
                    _crop_max_taps(h, w, out_size), int(images.dtype == torch.uint8),
                    int(normalize))
    return out


def clip_crops(images, rects, out_size: int = 224):
    """images (B, H, W, 3) in [0, 255], uint8 or float; rects (B, n, 4) int32
    -> (B * n, S, S, 3): every scene's rects through crop_square_resize_white
    and preprocess_crops, scene-major.  On a CUDA tensor one launch of the
    crop kernel for the whole batch, with nothing read back; on the CPU the
    plain path a scene at a time."""
    b, n = rects.shape[:2]
    if images.device.type == "cpu":
        return preprocess_crops(torch.cat([
            crop_square_resize_white_plain(images[i].to(torch.float32), rects[i], out_size)
            for i in range(b)
        ]))
    scene = torch.arange(b, dtype=torch.int32, device=images.device)[:, None].expand(b, n)
    return _crop_kernel(images, rects.reshape(b * n, 4).contiguous(), scene.reshape(b * n),
                        out_size, normalize=True)


def _interp_matrix(coords, size: int):
    """Bilinear interpolation matrices (..., out, size): each row the hat
    weights around its source coordinate, clipped into [0, size - 1]; at
    most two taps a row, summing to 1."""
    coords = torch.clamp(coords, 0.0, size - 1.0)
    i = torch.arange(size, dtype=torch.float32, device=coords.device)
    return torch.clamp(1.0 - torch.abs(coords[..., None] - i), 0.0, 1.0)


def crop_square_resize_white_bilinear(image, rects, out_size: int = 224):
    """image (H, W, 3) float in [0, 255]; rects (..., 4) int32 [xmin, ymin,
    xmax, ymax] -> (..., out_size, out_size, 3): each rect centred in a white
    square, resampled bilinearly at the square's pixel centres, and 255
    wherever a sample falls outside the rect's pixels.  Not rounded."""
    h_img, w_img = image.shape[0], image.shape[1]
    xmin, ymin, xmax, ymax = rects.unbind(-1)
    w = (ymax - ymin).to(torch.float32)  # vertical extent (the reference's naming)
    h = (xmax - xmin).to(torch.float32)  # horizontal extent
    max_edge = torch.maximum(w, h)
    y_begin = torch.floor((max_edge - w) / 2)
    x_begin = torch.floor((max_edge - h) / 2)

    o = torch.arange(out_size, dtype=torch.float32, device=image.device)
    grid = (o + 0.5) * max_edge[..., None] / out_size - 0.5  # (..., out)
    sy = grid - y_begin[..., None] + ymin.to(torch.float32)[..., None]
    sx = grid - x_begin[..., None] + xmin.to(torch.float32)[..., None]
    row_in = (sy >= ymin[..., None]) & (sy <= ymax.to(torch.float32)[..., None] - 1)
    col_in = (sx >= xmin[..., None]) & (sx <= xmax.to(torch.float32)[..., None] - 1)
    inside = row_in[..., :, None] & col_in[..., None, :]

    tmp = torch.einsum("...oh,hwc->...owc", _interp_matrix(sy, h_img), image)
    val = torch.einsum("...pw,...owc->...opc", _interp_matrix(sx, w_img), tmp)
    return torch.where(inside[..., None], val, torch.full((), 255.0, device=image.device))


_NORMALISE = {}  # device -> CLIP's mean and std there, copied once


def preprocess_crops(crops):
    """(N, S, S, 3) in [0, 255] -> CLIP-normalised, (x / 255 - mean) / std."""
    consts = _NORMALISE.get(crops.device)
    if consts is None:
        with torch.inference_mode(False):
            consts = _NORMALISE.setdefault(crops.device, (
                torch.from_numpy(IMAGE_MEAN).to(crops.device),
                torch.from_numpy(IMAGE_STD).to(crops.device)))
    mean, std = consts
    return (crops / 255.0 - mean) / std


def expand_box(rects, img_h: int, img_w: int):
    """--if_expand_box: grow the shorter side of each rect (..., 4) to a
    square around the same centre, clamped to the padded image."""
    xmin, ymin, xmax, ymax = rects.unbind(-1)
    bw = xmax - xmin
    bh = ymax - ymin
    dx = torch.where(bh > bw, (bh - bw) // 2, 0)
    dy = torch.where(bh > bw, 0, (bw - bh) // 2)
    return torch.stack(
        [
            torch.clamp(xmin - dx, 0, img_w),
            torch.clamp(ymin - dy, 0, img_h),
            torch.clamp(xmax + dx, 0, img_w),
            torch.clamp(ymax + dy, 0, img_h),
        ],
        dim=-1,
    )


def crop_rects(outputs_last: dict, batch: dict, if_expand_box: bool = False):
    """Predicted boxes -> (rects (B, nq, 4) int32, valid (B, nq) bool).

    A box is invalid when its size is zero, its rect degenerate, or a corner
    lies behind the camera.  The expansion comes before the validity test,
    as in the reference, so it can rescue a zero-width rect.
    """
    corners_xyz = outputs_last["box_corners_xyz"]
    b = corners_xyz.shape[0]
    dev = corners_xyz.device
    ones = torch.ones((b,), device=dev)
    un_corners = unaugment_corners(
        corners_xyz,
        batch.get("scale_array", torch.ones((b, 3), device=dev)),
        batch.get("rot_array", torch.eye(3, device=dev).expand(b, 3, 3)),
        batch.get("flip_array", ones),
        batch.get("zx_flip_array"),
    )
    rects, min_depth = corners_to_image_rects(
        un_corners, batch["K"], batch["Rtilt"], batch["ori_width"], batch["ori_height"],
        batch["x_offset"], batch["y_offset"], batch.get("image_flip_array", ones),
        batch.get("flip_length", batch["ori_width"]),
    )
    if if_expand_box:
        rects = expand_box(rects, batch["input_image"].shape[1], batch["input_image"].shape[2])
    valid = (
        (torch.amax(outputs_last["size_unnormalized"], dim=-1) >= 1e-16)
        & (rects[..., 2] - rects[..., 0] > 0)
        & (rects[..., 3] - rects[..., 1] > 0)
        & (min_depth >= 0)
    )
    return rects, valid


def clip_crop_scores(outputs_last: dict, batch: dict, clip_image_fn, text_features,
                     logit_scale, crop_size: int = 224, expand_box: bool = False):
    """sem_cls_prob (B, nq, ncls) of every predicted box of the last decoder
    layer, by CLIP zero-shot classification of its image crop;
    `clip_image_fn` maps (N, S, S, 3) normalised crops to (N, 512)."""
    rects, valid = crop_rects(outputs_last, batch, expand_box)
    b, nq = rects.shape[:2]
    with span("clip:crops"):
        crops = clip_crops(batch["input_image"], rects, crop_size)
    probs = []
    for i in range(b):
        emb = clip_image_fn(crops[i * nq:(i + 1) * nq]).to(torch.float32)
        probs.append(_clip_softmax(emb, text_features, logit_scale) * valid[i][:, None])
    return torch.stack(probs)


def _clip_softmax(emb, text_features, logit_scale):
    """Softmax over the text bank of the unit-normalized embeddings' cosines
    times the logit scale."""
    norm = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-32)
    logits = torch.matmul(norm, text_features.to(torch.float32).t())
    return torch.softmax(logits * logit_scale, dim=-1)


def select_distillation_boxes(generator, b: int, nq: int, n_sel: int, objectness=None,
                              select_by_objectness=False, device=None):
    """(B, n_sel) int64 proposal indices to crop, drawn from `generator`.

    A uniform random permutation's first n_sel entries per scene (the
    reference's np.random.choice, model_3detr.py:997).  With
    `select_by_objectness` (a bool or a 0-d bool tensor: the epoch gate,
    reference model_3detr.py:990-1005) and `objectness` (B, nq): the boxes
    with objectness > 0.05 first, in query order, then the others in random
    order, as the JAX package ranks them (distillation.py:389-407).
    """
    device = device if device is not None else generator.device
    noise = torch.rand((b, nq), generator=generator, device=device)
    sel = torch.argsort(noise, dim=1)[:, :n_sel]
    if objectness is None or select_by_objectness is False:
        return sel
    idx = torch.arange(nq, device=device, dtype=torch.float32)
    rank = torch.where(objectness > 0.05, idx, nq + noise * nq)
    sel_obj = torch.argsort(rank, dim=1, stable=True)[:, :n_sel]
    return torch.where(torch.as_tensor(select_by_objectness, device=device), sel_obj, sel)


def _take(x, sel):
    """x (B, nq, ...) gathered at sel (B, n_sel) along the proposals."""
    idx = sel.reshape(*sel.shape, *(1,) * (x.dim() - 2)).expand(*sel.shape, *x.shape[2:])
    return torch.gather(x, 1, idx)


def keep_novel_boxes_as_gt(outputs: dict, batch: dict, sel, emb, valid, text_features,
                           logit_scale, keep_objectness: float, train_range_max: int, enabled):
    """--if_keep_box (reference model_3detr.py:1108-1155): among the
    distillation crops, the boxes with objectness > keep_objectness whose crop
    CLIP classifies as a novel class (max probability > 0.5, argmax >=
    train_range_max) are appended to the scene's ground truth (present mask,
    box geometry, angle labels from the predictions), up to max_num_obj.
    `enabled` (a bool or a 0-d bool tensor) is the epoch gate.  Returns the
    updated gt_* targets."""
    b, n_sel = sel.shape
    max_obj = batch["gt_box_present"].shape[1]
    dev = sel.device
    probs = _clip_softmax(emb, text_features, logit_scale)
    max_score, max_idx = torch.max(probs, dim=-1)
    obj_sel = torch.gather(outputs["objectness_prob"], 1, sel)
    keep = (valid & (obj_sel > keep_objectness) & (max_score > 0.5)
            & (max_idx >= train_range_max) & torch.as_tensor(enabled, device=dev))
    nactual = batch["gt_box_present"].sum(dim=1).long()
    pos = nactual[:, None] + torch.cumsum(keep.long(), dim=1) - 1
    pos = torch.where(keep & (pos < max_obj), pos, torch.full_like(pos, max_obj))

    def scatter(target, values):
        # writes at max_obj land in a spare row that is cut off: dropped
        values = values.to(target.dtype)
        spare = torch.cat([target, target[:, :1]], dim=1)
        idx = pos.reshape(b, n_sel, *(1,) * (values.dim() - 2)).expand_as(values)
        return spare.scatter(1, idx, values)[:, :max_obj]

    angle_cls = torch.argmax(_take(outputs["angle_logits"], sel), dim=-1)
    angle_res = torch.gather(_take(outputs["angle_residual"], sel), -1, angle_cls[..., None])[..., 0]
    updates = {
        "gt_box_present": scatter(batch["gt_box_present"], torch.ones_like(obj_sel)),
        "gt_angle_class_label": scatter(batch["gt_angle_class_label"], angle_cls),
        "gt_angle_residual_label": scatter(batch["gt_angle_residual_label"], angle_res),
        "gt_box_sizes_normalized": scatter(batch["gt_box_sizes_normalized"],
                                           _take(outputs["size_normalized"], sel)),
        "gt_box_corners": scatter(batch["gt_box_corners"], _take(outputs["box_corners"], sel)),
        "gt_box_angles": scatter(batch["gt_box_angles"], _take(outputs["angle_continuous"], sel)),
        "gt_box_centers_normalized": scatter(batch["gt_box_centers_normalized"],
                                             _take(outputs["center_normalized"], sel)),
    }
    if "gt_box_sizes" in batch:
        updates["gt_box_sizes"] = scatter(batch["gt_box_sizes"],
                                          _take(outputs["size_unnormalized"], sel))
    if "gt_box_corners_xyz" in batch:
        updates["gt_box_corners_xyz"] = scatter(batch["gt_box_corners_xyz"],
                                                _take(outputs["box_corners_xyz"], sel))
    return updates


def build_clip_distillation_targets(outputs: dict, batch: dict, clip_image_fn, sel,
                                    text_features=None, logit_scale=None,
                                    if_clip_weak_labels: bool = False, crop_size: int = 224,
                                    if_keep_box: bool = False, keep_objectness: float = 0.5,
                                    train_range_max: int = 10, keep_enabled=False) -> dict:
    """The criterion targets of the stage-1 forward (reference
    get_predicted_box_clip_embedding, model_3detr.py:902-1210):
    gt_text_correlation_embedding (B, nq, 512), its mask (B, nq, 1), and
    weak_box_cate_label (B, nq) int64 with weak_confidence_weight (B, nq),
    zeros without --if_clip_weak_labels; with --if_keep_box also the updated
    gt_* targets.

    `outputs` holds the last decoder layer's quantities (detached), `sel`
    the (B, n_sel) proposals to crop (`select_distillation_boxes`), and
    `clip_image_fn` maps (N, S, S, 3) normalised crops to (N, 512).
    """
    outputs = {k: v.detach() for k, v in outputs.items()}
    b, nq = outputs["box_corners_xyz"].shape[:2]
    n_sel = sel.shape[1]
    rects, valid_all = crop_rects(outputs, batch)
    sel_rects = _take(rects, sel)
    valid = torch.gather(valid_all, 1, sel)
    with span("clip:crops"):
        crops = clip_crops(batch["input_image"], sel_rects, crop_size)
    emb = clip_image_fn(crops).to(torch.float32).reshape(b, n_sel, -1)
    emb = emb * valid[..., None]
    width = emb.shape[-1]
    gt_emb = torch.zeros((b, nq, width), dtype=torch.float32, device=emb.device)
    gt_emb = gt_emb.scatter(1, sel[..., None].expand(b, n_sel, width), emb)
    mask = torch.zeros((b, nq, 1), dtype=torch.float32, device=emb.device)
    mask = mask.scatter(1, sel[..., None], valid[..., None].to(torch.float32))
    targets = {
        "gt_text_correlation_embedding": gt_emb,
        "gt_text_correlation_embedding_mask": mask,
    }
    if if_keep_box and text_features is not None:
        targets.update(keep_novel_boxes_as_gt(
            outputs, batch, sel, emb, valid, text_features, logit_scale, keep_objectness,
            train_range_max, keep_enabled,
        ))
    if if_clip_weak_labels and text_features is not None:
        conf, label = torch.max(_clip_softmax(gt_emb, text_features, logit_scale), dim=-1)
        targets["weak_box_cate_label"] = label
        targets["weak_confidence_weight"] = torch.where(mask[..., 0] < 1, 0.0, conf)
    else:
        targets["weak_box_cate_label"] = torch.zeros((b, nq), dtype=torch.int64, device=emb.device)
        targets["weak_confidence_weight"] = torch.zeros((b, nq), device=emb.device)
    return targets
