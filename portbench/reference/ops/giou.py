"""Rotated generalized 3D IoU (plain PyTorch, batched, differentiable).

Counterpart of coda_neurips2023_tpu/ops/giou.py :: generalized_box3d_iou,
the same math in the same order:
  * boxes are (..., 8, 3) camera-frame corners (up is -Y), rotated about the
    vertical only; the height overlap comes from corners 0 (top) and 4
    (bottom);
  * the footprint is corners [3, 2, 1, 0] projected onto (x, z), a
    counter-clockwise quad; the intersection area clips one quad against the
    other (Sutherland-Hodgman, strict `inside`, the 1e-32-regularized line
    intersection) with fixed 10-vertex buffers and count masks, so every
    (proposal, ground truth) pair is clipped at once with no Python loop over
    pairs;
  * pairs whose axis-aligned footprint overlap is zero keep intersection 0
    (the reference Cython path's gate);
  * gIoU = IoU - (1 - union / enclosing axis-aligned volume), zeroed for
    malformed boxes and for padded ground-truth columns (k2 >= nums_k2).

The vertex axis leads every intermediate ((V, *pairs)), as in the JAX
package, so the (pairs,) axes stay contiguous.
"""

from __future__ import annotations

from typing import Optional

import torch

_MAX_VERTS = 10  # MAX_INTERSECT_POINTS of the reference's Cython path
_EPS = 1e-8
_VOL_EPS = 1e-6


def _prev_ring(verts: torch.Tensor, count: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """prev[i] = verts[i - 1] for i > 0, verts[count - 1] for i == 0.
    verts (V, 2, *P), count (*P), idx (V, 1, ...)."""
    rolled = torch.roll(verts, 1, dims=0)
    last_sel = (idx == count[None] - 1).to(verts.dtype)  # (V, *P)
    last = torch.sum(verts * last_sel[:, None], dim=0)  # (2, *P)
    return torch.where((idx == 0)[:, None], last[None], rolled)


def clip_area_pairs(subject: torch.Tensor, clip: torch.Tensor) -> torch.Tensor:
    """Intersection area of two convex CCW quads, vertex-major layout.

    subject, clip: (4, 2, *P) -> (*P) areas.
    """
    pshape = subject.shape[2:]
    v = _MAX_VERTS
    dtype, device = subject.dtype, subject.device
    verts = torch.cat([subject, subject.new_zeros((v - 4, 2) + pshape)], dim=0)  # (V, 2, *P)
    count = torch.full(pshape, 4, dtype=torch.int64, device=device)
    idx = torch.arange(v, device=device).reshape((v,) + (1,) * len(pshape))

    def inside(cp1, cp2, px, py):
        """Strictly inside edge cp1 -> cp2 of a CCW polygon.  cp*: (2, *P);
        px, py: (V, *P)."""
        return (cp2[0] - cp1[0])[None] * (py - cp1[1][None]) > (cp2[1] - cp1[1])[None] * (
            px - cp1[0][None]
        )

    for edge in range(4):
        cp1 = clip[(edge - 1) % 4]  # (2, *P)
        cp2 = clip[edge]
        ex, ey = verts[:, 0], verts[:, 1]  # (V, *P)
        s_pts = _prev_ring(verts, count, idx)
        sx, sy = s_pts[:, 0], s_pts[:, 1]

        ins_e = inside(cp1, cp2, ex, ey)
        ins_s = inside(cp1, cp2, sx, sy)
        active = idx < count[None]
        has_inter = active & (ins_e != ins_s)
        keep_e = active & ins_e

        # line-line intersection with the +1e-32 regularizer; an exactly
        # parallel pair is never selected, but its 1/0 would poison the
        # gradient through the masking `where`: keep it finite
        dcx, dcy = cp1[0] - cp2[0], cp1[1] - cp2[1]  # (*P)
        dpx, dpy = sx - ex, sy - ey  # (V, *P)
        n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0]  # (*P)
        n2 = sx * ey - sy * ex  # (V, *P)
        denom = dcx[None] * dpy - dcy[None] * dpx
        safe_denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
        n3 = 1.0 / (safe_denom + 1e-32)
        ix = torch.nan_to_num((n1[None] * dpx - n2 * dcx[None]) * n3, nan=0.0, posinf=1e6, neginf=-1e6)
        iy = torch.nan_to_num((n1[None] * dpy - n2 * dcy[None]) * n3, nan=0.0, posinf=1e6, neginf=-1e6)

        # each vertex emits [its intersection?][itself?], in that order
        firstx = torch.where(has_inter, ix, ex)
        firsty = torch.where(has_inter, iy, ey)
        n_emit = has_inter.to(torch.int64) + keep_e.to(torch.int64)  # (V, *P)
        offset = torch.cumsum(n_emit, dim=0) - n_emit  # exclusive prefix sum
        pos1 = torch.where(n_emit >= 1, offset, v)  # v: dropped
        pos2 = torch.where(n_emit == 2, offset + 1, v)

        # compaction as a one-hot contraction: out[s] = sum_i [pos(i) == s] * val_i
        eq1 = (pos1[None] == idx[:, None]).to(dtype)  # (S, I, *P)
        eq2 = (pos2[None] == idx[:, None]).to(dtype)
        outx = torch.sum(eq1 * firstx[None], dim=1) + torch.sum(eq2 * ex[None], dim=1)
        outy = torch.sum(eq1 * firsty[None], dim=1) + torch.sum(eq2 * ey[None], dim=1)
        verts = torch.stack([outx, outy], dim=1)  # (V, 2, *P)
        count = torch.sum(n_emit, dim=0)

    # shoelace over the live vertices, circular previous vertex
    prev = _prev_ring(verts, count, idx)
    live = (idx < count[None]).to(dtype)
    contrib = (verts[:, 0] * prev[:, 1] - verts[:, 1] * prev[:, 0]) * live
    return 0.5 * torch.abs(torch.sum(contrib, dim=0))


def box3d_vol(corners: torch.Tensor) -> torch.Tensor:
    """(..., 8, 3) -> (...,) volume from three edge lengths."""
    def edge(i, j):
        d2 = torch.sum((corners[..., i, :] - corners[..., j, :]) ** 2, dim=-1)
        return torch.sqrt(torch.clamp(d2, min=_VOL_EPS))

    return edge(0, 1) * edge(1, 2) * edge(0, 4)


def enclosing_box3d_vol(corners1: torch.Tensor, corners2: torch.Tensor) -> torch.Tensor:
    """(B, K1, 8, 3), (B, K2, 8, 3) -> (B, K1, K2) axis-aligned enclosing
    volume, with the reference's Y flip and min/max pairing."""
    flip = corners1.new_tensor([1.0, -1.0, 1.0])
    c1, c2 = corners1 * flip, corners2 * flip
    lo1, hi1 = c1.amin(dim=-2), c1.amax(dim=-2)  # (B, K1, 3)
    lo2, hi2 = c2.amin(dim=-2), c2.amax(dim=-2)

    def pair(a, b, op):
        return op(a[:, :, None], b[:, None, :])

    x_min = pair(lo1[..., 0], lo2[..., 0], torch.minimum)
    y_min = pair(hi1[..., 1], hi2[..., 1], torch.maximum)
    z_min = pair(lo1[..., 2], lo2[..., 2], torch.minimum)
    x_max = pair(hi1[..., 0], hi2[..., 0], torch.maximum)
    y_max = pair(lo1[..., 1], lo2[..., 1], torch.minimum)
    z_max = pair(hi1[..., 2], hi2[..., 2], torch.maximum)
    return torch.abs(x_max - x_min) * torch.abs(y_max - y_min) * torch.abs(z_max - z_min)


def generalized_box3d_iou(
    corners1: torch.Tensor,
    corners2: torch.Tensor,
    nums_k2: Optional[torch.Tensor] = None,
    rotated_boxes: bool = True,
) -> torch.Tensor:
    """corners1 (B, K1, 8, 3) x corners2 (B, K2, 8, 3) -> gIoU (B, K1, K2).

    `nums_k2` (B,) zeroes the padded ground-truth columns.  Differentiable
    with respect to both corner sets.
    """
    corners1 = corners1.float()
    corners2 = corners2.float()
    b, k1 = corners1.shape[:2]
    k2 = corners2.shape[1]

    ymax = torch.minimum(corners1[:, :, 0, 1][:, :, None], corners2[:, :, 0, 1][:, None, :])
    ymin = torch.maximum(corners1[:, :, 4, 1][:, :, None], corners2[:, :, 4, 1][:, None, :])
    height = torch.clamp(ymax - ymin, min=0.0)

    footprint = [3, 2, 1, 0]
    rect1 = corners1[:, :, footprint][..., [0, 2]]  # (B, K1, 4, 2)
    rect2 = corners2[:, :, footprint][..., [0, 2]]

    lt = torch.maximum(rect1[:, :, 1][:, :, None, :], rect2[:, :, 1][:, None, :, :])
    rb = torch.minimum(rect1[:, :, 3][:, :, None, :], rect2[:, :, 3][:, None, :, :])
    wh = torch.clamp(rb - lt, min=0.0)
    non_rot_inter = wh[..., 0] * wh[..., 1]  # (B, K1, K2)

    col_live = None
    if nums_k2 is not None:
        col_live = torch.arange(k2, device=corners2.device)[None, :] < nums_k2[:, None]
        non_rot_inter = non_rot_inter * col_live[:, None, :]

    enclosing_vols = enclosing_box3d_vol(corners1, corners2)
    vols1 = torch.clamp(box3d_vol(corners1), min=_EPS)
    vols2 = torch.clamp(box3d_vol(corners2), min=_EPS)
    sum_vols = vols1[:, :, None] + vols2[:, None, :]
    good_boxes = (enclosing_vols > 2 * _EPS) & (sum_vols > 4 * _EPS)

    if rotated_boxes:
        r1 = rect1.permute(2, 3, 0, 1)  # (4, 2, B, K1)
        r2 = rect2.permute(2, 3, 0, 1)  # (4, 2, B, K2)
        sub = r1[..., None].expand(4, 2, b, k1, k2)
        clp = r2[..., None, :].expand(4, 2, b, k1, k2)
        areas = clip_area_pairs(sub, clp)
        inter_areas = torch.where(non_rot_inter > 0, areas, torch.zeros_like(areas))
    else:
        inter_areas = non_rot_inter

    inter_vols = inter_areas * height
    union_vols = torch.clamp(sum_vols - inter_vols, min=_EPS)
    ious = inter_vols / union_vols
    gious = ious - (1.0 - union_vols / enclosing_vols)
    gious = gious * good_boxes
    if col_live is not None:
        gious = gious * col_live[:, None, :]
    return gious
