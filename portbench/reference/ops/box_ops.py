"""3D box parametrizations and point normalization (PyTorch).

Counterparts of coda_neurips2023_tpu/ops/box_ops.py:20-147: corner
parametrizations (camera frame, upright xyz frame, and the dataset configs'
my_compute_box_3d), the depth-to-camera axis flip, heading-angle bins, and
the scene-extent point normalization.  All functions broadcast over leading
dimensions.

The `*_np` functions are the numpy twins the ground truth is built with
(box_ops.py:157-250 there), written in the same operations and order so the
synthetic scenes' and the SUN RGB-D samples' box fields are bit-equal to the
JAX package's.
"""

from __future__ import annotations

import numpy as np
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


def my_compute_box_3d(center, size, heading_angle) -> torch.Tensor:
    """The dataset configs' my_compute_box_3d: upright-frame corners (..., 8, 3)
    with `size` taken as the half-extents."""
    l, w, h = (size[..., i : i + 1] for i in range(3))
    x = torch.cat([-l, l, l, -l, -l, l, l, -l], dim=-1)
    y = torch.cat([w, w, -w, -w, w, w, -w, -w], dim=-1)
    z = torch.cat([h, h, h, h, -h, -h, -h, -h], dim=-1)
    return _corners(x, y, z, rotz_batch(-heading_angle), center)


def angle2class(angle: torch.Tensor, num_angle_bin: int):
    """Heading angle -> (bin in [0, num_angle_bin) as int32, residual from the bin centre)."""
    two_pi = 2 * np.pi
    angle = torch.remainder(angle, two_pi)
    angle_per_class = two_pi / float(num_angle_bin)
    shifted = torch.remainder(angle + angle_per_class / 2, two_pi)
    class_id = torch.floor(shifted / angle_per_class).to(torch.int32)
    residual = shifted - (class_id.to(angle.dtype) * angle_per_class + angle_per_class / 2)
    return class_id, residual


def class2angle(pred_cls: torch.Tensor, residual: torch.Tensor, num_angle_bin: int):
    """Inverse of angle2class, wrapped to (-pi, pi]."""
    angle_per_class = 2 * np.pi / float(num_angle_bin)
    angle = pred_cls.to(residual.dtype) * angle_per_class + residual
    return torch.where(angle > np.pi, angle - 2 * np.pi, angle)


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


# ---------------------------------------------------------------- numpy twins


def _roty_batch_np(t):
    c, s = np.cos(t), np.sin(t)
    out = np.zeros(t.shape + (3, 3), np.float32)
    out[..., 0, 0] = c
    out[..., 0, 2] = s
    out[..., 1, 1] = 1
    out[..., 2, 0] = -s
    out[..., 2, 2] = c
    return out


def _rotz_batch_np(t):
    c, s = np.cos(t), np.sin(t)
    out = np.zeros(t.shape + (3, 3), np.float32)
    out[..., 0, 0] = c
    out[..., 0, 1] = -s
    out[..., 1, 0] = s
    out[..., 1, 1] = c
    out[..., 2, 2] = 1
    return out


def flip_axis_to_camera_np(pc: np.ndarray) -> np.ndarray:
    return np.stack([pc[..., 0], -pc[..., 2], pc[..., 1]], axis=-1)


def flip_axis_to_depth_np(pc: np.ndarray) -> np.ndarray:
    return np.stack([pc[..., 0], pc[..., 2], -pc[..., 1]], axis=-1)


def _half_extents_np(box_size):
    box_size = np.asarray(box_size, np.float32)
    return box_size[..., 0:1] / 2, box_size[..., 1:2] / 2, box_size[..., 2:3] / 2


def _corners_np(x, y, z, rot, center):
    corners = np.einsum("...ij,...kj->...ik", np.stack([x, y, z], axis=-1), rot)
    return corners + np.asarray(center, np.float32)[..., None, :]


def get_3d_box_batch_np(box_size, angle, center) -> np.ndarray:
    """numpy `get_3d_box_batch`: camera-frame corners (..., 8, 3)."""
    l, w, h = _half_extents_np(box_size)
    x = np.concatenate([l, l, -l, -l, l, l, -l, -l], axis=-1)
    y = np.concatenate([h, h, h, h, -h, -h, -h, -h], axis=-1)
    z = np.concatenate([w, -w, -w, w, w, -w, -w, w], axis=-1)
    return _corners_np(x, y, z, _roty_batch_np(np.asarray(angle, np.float32)), center)


def get_3d_box_batch_xyz_np(box_size, angle, center) -> np.ndarray:
    """numpy `get_3d_box_batch_xyz`: upright-frame corners (..., 8, 3)."""
    l, w, h = _half_extents_np(box_size)
    x = np.concatenate([-l, l, l, -l, -l, l, l, -l], axis=-1)
    y = np.concatenate([w, w, -w, -w, w, w, -w, -w], axis=-1)
    z = np.concatenate([h, h, h, h, -h, -h, -h, -h], axis=-1)
    return _corners_np(x, y, z, _rotz_batch_np(-np.asarray(angle, np.float32)), center)


def my_compute_box_3d_np(center, size, heading_angle) -> np.ndarray:
    """numpy `my_compute_box_3d`: upright-frame corners, `size` the half-extents."""
    size = np.asarray(size, np.float32)
    l, w, h = size[..., 0:1], size[..., 1:2], size[..., 2:3]
    x = np.concatenate([-l, l, l, -l, -l, l, l, -l], axis=-1)
    y = np.concatenate([w, w, -w, -w, w, w, -w, -w], axis=-1)
    z = np.concatenate([h, h, h, h, -h, -h, -h, -h], axis=-1)
    return _corners_np(x, y, z, _rotz_batch_np(-np.asarray(heading_angle, np.float32)), center)


def angle2class_np(angle, num_angle_bin: int):
    """Heading angle -> (bin in [0, num_angle_bin), residual from the bin centre)."""
    angle = np.asarray(angle, np.float32)
    two_pi = 2 * np.pi
    angle = angle % two_pi
    angle_per_class = two_pi / float(num_angle_bin)
    shifted = (angle + angle_per_class / 2) % two_pi
    class_id = np.floor(shifted / angle_per_class).astype(np.int32)
    residual = shifted - (class_id.astype(angle.dtype) * angle_per_class + angle_per_class / 2)
    return class_id, residual
