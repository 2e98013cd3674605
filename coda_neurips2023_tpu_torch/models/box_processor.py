"""MLP-head outputs -> 3D boxes (PyTorch).

Counterpart of coda_neurips2023_tpu/models/box_processor.py: centre = query
xyz + offset, normalized into the scene extent; size = sigmoid-normalized
size times the scene extent (clamped at 0.1); angle = arg-max bin centre plus
that bin's residual, wrapped above pi; objectness = 1 - softmax(bg); class
probabilities = softmax over the foreground bins.
"""

from __future__ import annotations

import math

import torch

from coda_neurips2023_tpu_torch.ops.box_ops import scale_points, shift_scale_points


class BoxProcessor:
    def __init__(self, dataset_config):
        self.dataset_config = dataset_config

    def compute_predicted_center(self, center_offset, query_xyz, point_cloud_dims):
        center_unnormalized = query_xyz + center_offset
        center_normalized = shift_scale_points(center_unnormalized, point_cloud_dims)
        return center_normalized, center_unnormalized

    def compute_predicted_size(self, size_normalized, point_cloud_dims):
        scene_scale = torch.clamp(point_cloud_dims[1] - point_cloud_dims[0], min=1e-1)
        return scale_points(size_normalized, scene_scale)

    def compute_predicted_angle(self, angle_logits, angle_residual):
        if angle_logits.shape[-1] == 1:
            # datasets without a heading angle (ScanNet)
            return torch.clamp((angle_logits * 0 + angle_residual * 0)[..., 0], min=0.0)
        angle_per_cls = 2 * math.pi / self.dataset_config.num_angle_bin
        pred_cls = torch.argmax(angle_logits, dim=-1)
        angle_center = angle_per_cls * pred_cls.to(angle_residual.dtype)
        residual = torch.gather(angle_residual, -1, pred_cls[..., None])[..., 0]
        angle = angle_center + residual
        return torch.where(angle > math.pi, angle - 2 * math.pi, angle)

    def compute_objectness_and_cls_prob(self, cls_logits):
        cls_prob = torch.softmax(cls_logits, dim=-1)
        return cls_prob[..., :-1], 1.0 - cls_prob[..., -1]

    def box_parametrization_to_corners(self, center_unnorm, size_unnorm, angle):
        return self.dataset_config.box_parametrization_to_corners(
            center_unnorm, size_unnorm, angle
        )

    def box_parametrization_to_corners_xyz(self, center_unnorm, size_unnorm, angle):
        return self.dataset_config.box_parametrization_to_corners_xyz(
            center_unnorm, size_unnorm, angle
        )
