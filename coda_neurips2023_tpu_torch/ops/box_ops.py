"""3D box parametrizations and point normalization (PyTorch).

Counterparts of coda_neurips2023_tpu/ops/box_ops.py:20-147, the part the
detector's forward uses: corner parametrizations (camera frame and upright
xyz frame), the depth-to-camera axis flip, and the scene-extent point
normalization.  All functions broadcast over leading dimensions.
"""

from __future__ import annotations

import torch


def _rotation(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def roty_batch(angle: torch.Tensor) -> torch.Tensor:
    """(...,) -> (..., 3, 3) rotation about +Y."""
    c, s = torch.cos(angle), torch.sin(angle)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    return _rotation([[c, zeros, s], [zeros, ones, zeros], [-s, zeros, c]])


def rotz_batch(angle: torch.Tensor) -> torch.Tensor:
    """(...,) -> (..., 3, 3) rotation about +Z."""
    c, s = torch.cos(angle), torch.sin(angle)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    return _rotation([[c, -s, zeros], [s, c, zeros], [zeros, zeros, ones]])


def flip_axis_to_camera(pc: torch.Tensor) -> torch.Tensor:
    """Depth (X right, Y forward, Z up) -> camera (X right, Y down, Z forward)."""
    return torch.stack([pc[..., 0], -pc[..., 2], pc[..., 1]], dim=-1)


def _corners(x, y, z, rot, center):
    corners = torch.stack([x, y, z], dim=-1)  # (..., 8, 3)
    return torch.einsum("...ij,...kj->...ik", corners, rot) + center[..., None, :]


def get_3d_box_batch(box_size, angle, center) -> torch.Tensor:
    """Camera-frame corners (..., 8, 3) of boxes (l, w, h) rotated by roty(angle)."""
    l, w, h = (box_size[..., i : i + 1] / 2 for i in range(3))
    x = torch.cat([l, l, -l, -l, l, l, -l, -l], dim=-1)
    y = torch.cat([h, h, h, h, -h, -h, -h, -h], dim=-1)
    z = torch.cat([w, -w, -w, w, w, -w, -w, w], dim=-1)
    return _corners(x, y, z, roty_batch(angle), center)


def get_3d_box_batch_xyz(box_size, angle, center) -> torch.Tensor:
    """Upright-frame corners (..., 8, 3): rotz(-angle), (x, y, z) = (l, w, h)."""
    l, w, h = (box_size[..., i : i + 1] / 2 for i in range(3))
    x = torch.cat([-l, l, l, -l, -l, l, l, -l], dim=-1)
    y = torch.cat([w, w, -w, -w, w, w, -w, -w], dim=-1)
    z = torch.cat([h, h, h, h, -h, -h, -h, -h], dim=-1)
    return _corners(x, y, z, rotz_batch(-angle), center)


def shift_scale_points(pred_xyz, src_range, dst_range=None) -> torch.Tensor:
    """Map (B, N, 3) points from the src [min, max] box, a pair of (B, 3)
    tensors, to dst (default the unit cube)."""
    src_min, src_max = src_range
    if dst_range is None:
        dst_range = (torch.zeros_like(src_min), torch.ones_like(src_min))
    dst_min, dst_max = dst_range
    src_diff = (src_max - src_min)[:, None, :]
    dst_diff = (dst_max - dst_min)[:, None, :]
    return (pred_xyz - src_min[:, None, :]) * dst_diff / src_diff + dst_min[:, None, :]


def scale_points(pred_xyz, mult_factor) -> torch.Tensor:
    """(B, N, 3) * (B, 3) broadcast scale."""
    return pred_xyz * mult_factor[:, None, :]
