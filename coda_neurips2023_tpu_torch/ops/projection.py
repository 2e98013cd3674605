"""Camera projection and crop rects of predicted boxes (PyTorch).

Counterpart of coda_neurips2023_tpu/ops/projection.py:

  SUN RGB-D, upright-depth -> camera:  flip_axis_to_camera(Rtilt^T @ pc)
            camera -> image:           uv_h = pc_cam @ K^T;  u,v = uv_h[:2] / depth
  ScanNet,  world -> camera:           inverse of the 4x4 camera pose
            camera -> image:           the 3x3 block of the 4x4 colour intrinsics

plus the un-augmentation of predicted corners and their integer crop rects
in padded-image coordinates, which pick the projection by the calibration's
shape.  Rects are cast to int32 by truncation, as `astype(jnp.int32)` does.
"""

from __future__ import annotations

import torch

from coda_neurips2023_tpu_torch.ops.box_ops import flip_axis_to_camera


def project_upright_depth_to_image(pc, k_mat, rtilt):
    """pc (..., N, 3) upright-depth points; k_mat, rtilt (..., 3, 3) ->
    (uv (..., N, 2), depth (..., N))."""
    pc_cam = torch.einsum("...ij,...nj->...ni", rtilt.transpose(-1, -2), pc)
    pc_cam = flip_axis_to_camera(pc_cam)
    uvh = torch.einsum("...ni,...ji->...nj", pc_cam, k_mat)
    depth = uvh[..., 2]
    uv = uvh[..., :2] / (depth[..., None] + 1e-32)
    return uv, depth


def project_world_to_image_scannet(pc, k_mat, pose):
    """pc (..., N, 3) world points; k_mat, pose (..., 4, 4), the colour
    intrinsics and the camera-to-world pose -> (uv (..., N, 2), depth
    (..., N))."""
    inv_pose = torch.linalg.inv(pose)
    pc_h = torch.cat([pc, torch.ones_like(pc[..., :1])], dim=-1)
    pc_cam = torch.einsum("...ij,...nj->...ni", inv_pose, pc_h)[..., :3]
    uvh = torch.einsum("...ij,...nj->...ni", k_mat[..., :3, :3], pc_cam)
    depth = uvh[..., 2]
    uv = uvh[..., :2] / (depth[..., None] + 1e-32)
    return uv, depth


def unaugment_corners(corners_xyz, scale_array, rot_array, flip_array, zx_flip_array=None):
    """Invert the point-cloud augmentation on predicted corners.

    corners_xyz (B, Q, 8, 3); scale_array (B, 3); rot_array (B, 3, 3);
    flip_array (B,); zx_flip_array (B,) or None.
    """
    out = corners_xyz * scale_array[:, None, None, :]
    out = torch.einsum("bqki,bij->bqkj", out, rot_array)
    ones = torch.ones_like(flip_array)
    zx = ones if zx_flip_array is None else zx_flip_array
    return out * torch.stack([flip_array, zx, ones], dim=-1)[:, None, None, :]


def corners_to_image_rects(corners_xyz, k_mat, rtilt, ori_width, ori_height, x_offset,
                           y_offset, image_flip_array, flip_length):
    """Un-augmented corners (B, Q, 8, 3) -> (rects (B, Q, 4) int32
    [xmin, ymin, xmax, ymax], min_depth (B, Q)); per-scene calibration,
    K and Rtilt (B, 3, 3) for SUN RGB-D or the intrinsics and pose (B, 4, 4)
    for ScanNet, and image geometry (B,)."""
    b, q = corners_xyz.shape[:2]
    project = project_world_to_image_scannet if k_mat.shape[-1] == 4 else \
        project_upright_depth_to_image
    uv, depth = project(corners_xyz.reshape(b, q * 8, 3), k_mat, rtilt)
    uv = uv.reshape(b, q, 8, 2)
    depth = depth.reshape(b, q, 8)

    def col(x):
        return x[:, None, None]

    u = torch.minimum(torch.clamp(uv[..., 0], min=0), col(ori_width) - 1) + col(y_offset)
    v = torch.minimum(torch.clamp(uv[..., 1], min=0), col(ori_height) - 1) + col(x_offset)
    flip = col(image_flip_array)
    u = u * flip + (1 - flip) * (col(flip_length) - 1 - u)
    rects = torch.stack(
        [u.amin(-1), v.amin(-1), u.amax(-1), v.amax(-1)], dim=-1
    ).to(torch.int32)
    return rects, depth.amin(-1)
