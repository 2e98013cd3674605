"""CLIP zero-shot classification of predicted boxes by image crops (PyTorch).

Counterpart of coda_neurips2023_tpu/models/distillation.py:51-254, the eval
path of the baseline detector with --if_with_clip (`clip_crop_scores`):

  1. un-augment the predicted corners, project them through K and Rtilt to
     integer crop rects in padded-image coordinates (ops/projection.py), and
     optionally grow each rect to a square (`expand_box`);
  2. crop every rect out of the scene's image, white-pad it to a centred
     square and resize it to the crop size with bicubic+antialias
     (torchvision's tensor path, PIL's a = -0.5 kernel), rounded to integral
     values.  As in the JAX package the resample is two dense interpolation
     matrices over the original image axes plus a separable white-mass term
     (`crop_square_resize_white`), so no square is materialised;
  3. CLIP-normalise the crops, encode them with the frozen image tower, and
     take the softmax of their cosine against a text bank times the logit
     scale; invalid boxes keep all-zero rows.

Crops go through the tower one scene at a time (the JAX package maps over
scenes the same way), so at ViT-B/16 and 128 queries a tower call is 128
crops.  The bilinear crop variant and the training-time target builders are
not ported yet.
"""

from __future__ import annotations

import math

import torch

from coda_neurips2023_tpu_torch.models.clip import IMAGE_MEAN, IMAGE_STD
from coda_neurips2023_tpu_torch.ops.projection import corners_to_image_rects, unaugment_corners


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


def crop_square_resize_white(image, rects, out_size: int = 224):
    """image (H, W, 3) float in [0, 255]; rects (..., 4) int32 [xmin, ymin,
    xmax, ymax] -> (..., out_size, out_size, 3): each rect cropped,
    white-padded to a centred square, bicubic+antialias resized and rounded
    (half to even, as jnp.round) to integral values in [0, 255]."""
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
    val = val + 255.0 * (1.0 - my[..., :, None] * mx[..., None, :])[..., None]
    return torch.round(torch.clamp(val, 0.0, 255.0))


def preprocess_crops(crops):
    """(N, S, S, 3) in [0, 255] -> CLIP-normalised."""
    mean = torch.from_numpy(IMAGE_MEAN).to(crops.device)
    std = torch.from_numpy(IMAGE_STD).to(crops.device)
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
    text = text_features.to(torch.float32)
    probs = []
    for i in range(rects.shape[0]):
        image = batch["input_image"][i].to(torch.float32)
        crops = crop_square_resize_white(image, rects[i], crop_size)
        emb = clip_image_fn(preprocess_crops(crops)).to(torch.float32)
        emb = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-32)
        logits = torch.matmul(emb, text.t()) * logit_scale
        probs.append(torch.softmax(logits, dim=-1) * valid[i][:, None])
    return torch.stack(probs)
