"""Seeded SUN RGB-D-shaped scenes: the inputs of every cell.

A copy of the port's synthetic scene generator (its
`datasets/synthetic.py`), kept here so that the inputs do not change with
the program: per scene, a point cloud of `num_points` points (room clutter
and samples inside 1 to `max_boxes` oriented boxes), the ground truth the
criterion reads, padded to `max_num_obj` boxes, and a random uint8 RGB image
of `image_hw` with a pinhole calibration, no augmentation.  A scene is a
function of (seed, index) alone, so the same seed gives the same inputs to
the program and to the reference.  Scenes are made on first access, so a
split of any length costs nothing until it is read.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.ops import box_ops


class SceneDataset:
    def __init__(self, num_scenes: int, num_points: int, max_boxes: int, image_hw,
                 max_num_obj: int, num_angle_bin: int, seed: int):
        self.num_scenes = int(num_scenes)
        self.num_points = int(num_points)
        self.max_boxes = int(max_boxes)
        self.image_hw = tuple(int(x) for x in image_hw)
        self.max_num_obj = int(max_num_obj)
        self.num_angle_bin = int(num_angle_bin)
        self.seed = int(seed)

    def __len__(self):
        return self.num_scenes

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng([self.seed, int(idx)])
        max_obj = self.max_num_obj
        nbox = int(rng.integers(1, self.max_boxes + 1))
        centers = np.zeros((max_obj, 3), np.float32)
        sizes = np.zeros((max_obj, 3), np.float32)
        angles = np.zeros((max_obj,), np.float32)
        present = np.zeros((max_obj,), np.float32)
        centers[:nbox] = rng.uniform(-3, 3, (nbox, 3)).astype(np.float32)
        centers[:nbox, 2] = rng.uniform(0.2, 2.0, nbox)  # z-up rooms
        sizes[:nbox] = rng.uniform(0.3, 1.8, (nbox, 3)).astype(np.float32)
        angles[:nbox] = rng.uniform(-np.pi, np.pi, nbox).astype(np.float32)
        present[:nbox] = 1.0

        # points: room clutter, then samples inside each box
        n_clutter = self.num_points // 2
        pts = [np.stack([rng.uniform(-4, 4, n_clutter), rng.uniform(-4, 4, n_clutter),
                         rng.uniform(0, 3, n_clutter)], axis=1).astype(np.float32)]
        per_box = max((self.num_points - n_clutter) // nbox, 1)
        for j in range(nbox):
            local = rng.uniform(-0.5, 0.5, (per_box, 3)).astype(np.float32) * sizes[j]
            c, s = np.cos(angles[j]), np.sin(angles[j])
            rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
            pts.append(local @ rot + centers[j])
        pc = np.concatenate(pts, axis=0)[: self.num_points]
        if pc.shape[0] < self.num_points:
            pad = rng.uniform(-4, 4, (self.num_points - pc.shape[0], 3)).astype(np.float32)
            pc = np.concatenate([pc, pad], axis=0)
        rng.shuffle(pc, axis=0)

        pc_min = pc.min(axis=0)
        pc_max = pc.max(axis=0)
        scene_scale = np.clip(pc_max - pc_min, 1e-1, None)
        ac, ar = box_ops.angle2class_np(angles, self.num_angle_bin)
        angle_cls = ac.astype(np.int64)
        angle_res = ar.astype(np.float32)
        cam = box_ops.flip_axis_to_camera_np(centers[None])
        corners_cam = box_ops.get_3d_box_batch_np(sizes[None], angles[None], cam)[0]
        corners_xyz = box_ops.get_3d_box_batch_xyz_np(sizes[None], angles[None], centers[None])[0]
        box = present[:, None]
        h, w = self.image_hw
        f = 0.8 * max(h, w)
        return {
            "point_clouds": pc.astype(np.float32),
            "point_cloud_dims_min": pc_min.astype(np.float32),
            "point_cloud_dims_max": pc_max.astype(np.float32),
            "gt_box_corners": (corners_cam * box[..., None]).astype(np.float32),
            "gt_box_corners_xyz": (corners_xyz * box[..., None]).astype(np.float32),
            "gt_box_centers": centers * box,
            "gt_box_centers_normalized": (centers - pc_min) / scene_scale * box,
            "gt_box_sizes": sizes * box,
            "gt_box_sizes_normalized": sizes / scene_scale * box,
            "gt_box_angles": angles * present,
            "gt_angle_class_label": (angle_cls * present).astype(np.int64),
            "gt_angle_residual_label": angle_res * present,
            "gt_box_sem_cls_label": np.zeros((max_obj,), np.int64),
            "gt_box_present": present,
            "gt_box_seen_sem_cls_label": np.zeros((max_obj,), np.int64),
            "gt_box_seen_sem_cls_confi": present.astype(np.float32),
            "scan_idx": np.int64(idx),
            "input_image": rng.integers(0, 255, (h, w, 3), dtype=np.uint8),
            "K": np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32),
            "Rtilt": np.eye(3, dtype=np.float32),
            "ori_width": np.float32(w),
            "ori_height": np.float32(h),
            "x_offset": np.float32(0),
            "y_offset": np.float32(0),
            "flip_array": np.float32(1),
            "scale_array": np.ones(3, np.float32),
            "rot_array": np.eye(3, dtype=np.float32),
            "rot_angle": np.float32(0),
            "image_flip_array": np.float32(1),
            "flip_length": np.float32(w),
        }
