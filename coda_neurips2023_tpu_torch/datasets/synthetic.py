"""Synthetic SUN RGB-D-shaped scenes: point clouds, ground truth, images.

Counterpart of coda_neurips2023_tpu/datasets/synthetic.py
(SyntheticDetectionDataset, :30-195). It makes the same numpy draws in the
same order (box count, the empty-scene draw when `empty_scene_rate` > 0,
centres, sizes, angles, clutter, in-box samples, padding, shuffle, image),
so a scene here is bit-equal to the JAX generator's: the point cloud, the
scene extent and the ground-truth box fields the criterion reads (corners in
the camera and upright frames, centres and sizes raw and normalized by the
scene extent, angles with their class and residual, sem-cls labels,
`gt_box_present`, the seen-class fields), padded to `max_num_obj` boxes.
With `with_images` a scene also carries a random uint8 RGB image of
`image_hw` (height, width) and the calibration and augmentation fields the
CLIP crop path reads (a pinhole K, identity Rtilt, no augmentation) and two
string fields, `im_name` and `pseudo_box_path`. With `pseudo_dir`, each
scene reads stage-2 pseudo boxes from its own
`synthetic_{idx:06d}_novel_bbox.npy` there, when the file exists, and merges
them as ground truth (class 0, full extents halved), as the SUN RGB-D
dataset merges its pseudo labels.
"""

from __future__ import annotations

import os

import numpy as np

from coda_neurips2023_tpu_torch.ops import box_ops


class SyntheticDetectionDataset:
    def __init__(
        self,
        dataset_config,
        num_scenes: int = 64,
        num_points: int = 20000,
        max_boxes_per_scene: int = 12,
        seed: int = 0,
        use_angles: bool = True,
        with_images: bool = False,
        image_hw: tuple = (64, 96),
        pseudo_dir: str | None = None,
        empty_scene_rate: float = 0.0,
    ):
        self.dataset_config = dataset_config
        self.num_scenes = num_scenes
        self.num_points = num_points
        self.max_boxes = max_boxes_per_scene
        self.seed = seed
        self.use_angles = use_angles and dataset_config.num_angle_bin > 1
        self.with_images = with_images
        self.image_hw = image_hw
        self.pseudo_dir = pseudo_dir
        # the share of scenes with no ground-truth box (SUN RGB-D has ~0.4%)
        self.empty_scene_rate = float(empty_scene_rate)

    def __len__(self):
        return self.num_scenes

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        max_obj = self.dataset_config.max_num_obj

        nbox = int(rng.integers(1, self.max_boxes + 1))
        if self.empty_scene_rate > 0.0 and rng.random() < self.empty_scene_rate:
            nbox = 0
        centers = np.zeros((max_obj, 3), np.float32)
        sizes = np.zeros((max_obj, 3), np.float32)
        angles = np.zeros((max_obj,), np.float32)
        present = np.zeros((max_obj,), np.float32)
        centers[:nbox] = rng.uniform(-3, 3, (nbox, 3)).astype(np.float32)
        centers[:nbox, 2] = rng.uniform(0.2, 2.0, nbox)  # z-up rooms
        sizes[:nbox] = rng.uniform(0.3, 1.8, (nbox, 3)).astype(np.float32)
        if self.use_angles:
            angles[:nbox] = rng.uniform(-np.pi, np.pi, nbox).astype(np.float32)
        present[:nbox] = 1.0

        # pseudo boxes as ground truth after the real ones (class 0, full
        # extents halved); the points are drawn in the real boxes only
        n_real = nbox
        pseudo_box_path = "_"
        if self.pseudo_dir:
            pseudo_box_path = os.path.join(self.pseudo_dir, f"synthetic_{idx:06d}_novel_bbox.npy")
            if os.path.exists(pseudo_box_path):
                p = np.load(pseudo_box_path)
                if p.ndim == 2 and p.shape[0] > 0 and p.shape[1] >= 7:
                    k = min(p.shape[0], max_obj - nbox)
                    if k > 0:
                        centers[nbox : nbox + k] = p[:k, 0:3]
                        sizes[nbox : nbox + k] = p[:k, 3:6] / 2.0
                        if self.use_angles:
                            angles[nbox : nbox + k] = p[:k, 6]
                        present[nbox : nbox + k] = 1.0
                        nbox += k

        # points: room clutter, then samples inside each box
        n_clutter = self.num_points // 2
        pts = [
            np.stack(
                [
                    rng.uniform(-4, 4, n_clutter),
                    rng.uniform(-4, 4, n_clutter),
                    rng.uniform(0, 3, n_clutter),
                ],
                axis=1,
            ).astype(np.float32)
        ]
        per_box = max((self.num_points - n_clutter) // max(n_real, 1), 1)
        for j in range(n_real):
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
        angle_cls = np.zeros((max_obj,), np.int64)
        angle_res = np.zeros((max_obj,), np.float32)
        if self.use_angles:
            ac, ar = box_ops.angle2class_np(angles, self.dataset_config.num_angle_bin)
            angle_cls = ac.astype(np.int64)
            angle_res = ar.astype(np.float32)
        cam = box_ops.flip_axis_to_camera_np(centers[None])
        corners_cam = box_ops.get_3d_box_batch_np(sizes[None], angles[None], cam)[0]
        corners_xyz = box_ops.get_3d_box_batch_xyz_np(sizes[None], angles[None], centers[None])[0]
        box = present[:, None]

        sample = {
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
        }
        if self.with_images:
            h, w = self.image_hw
            f = 0.8 * max(h, w)
            sample.update({
                "input_image": rng.integers(0, 255, (h, w, 3)).astype(np.uint8),
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
                "im_name": f"synthetic_{idx:06d}.jpg",
                "pseudo_box_path": pseudo_box_path,
                "gt_ori_box_num": np.int64(n_real),
            })
        return sample


def make_batch(dataset, start: int, batch_size: int) -> dict:
    """Scenes start .. start+batch_size-1 stacked into (B, ...) numpy arrays;
    the string fields are left out (datasets.loader.collate keeps them as
    lists)."""
    samples = [dataset[i] for i in range(start, start + batch_size)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]
            if not isinstance(samples[0][k], str)}
