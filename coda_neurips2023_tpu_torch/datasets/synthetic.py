"""Synthetic SUN RGB-D-shaped scenes: point clouds, scene extents, images.

Counterpart of the point-cloud, scene-dims and image part of
coda_neurips2023_tpu/datasets/synthetic.py (SyntheticDetectionDataset,
:65-195).  It makes the same numpy draws in the same order (box count,
centres, sizes, angles, clutter, in-box samples, padding, shuffle, image), so
a scene here is bit-equal to the JAX generator's.  With `with_images` a scene
also carries a random uint8 RGB image of `image_hw` (height, width) and the
calibration and augmentation fields the CLIP crop path reads (a pinhole K,
identity Rtilt, no augmentation).  The ground-truth box fields of the JAX
sample dict come with the criterion; the string fields (`im_name`,
`pseudo_box_path`) with the discovery writer.
"""

from __future__ import annotations

import numpy as np


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
    ):
        self.dataset_config = dataset_config
        self.num_scenes = num_scenes
        self.num_points = num_points
        self.max_boxes = max_boxes_per_scene
        self.seed = seed
        self.use_angles = use_angles and dataset_config.num_angle_bin > 1
        self.with_images = with_images
        self.image_hw = image_hw

    def __len__(self):
        return self.num_scenes

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        max_obj = self.dataset_config.max_num_obj

        nbox = int(rng.integers(1, self.max_boxes + 1))
        centers = np.zeros((max_obj, 3), np.float32)
        sizes = np.zeros((max_obj, 3), np.float32)
        angles = np.zeros((max_obj,), np.float32)
        centers[:nbox] = rng.uniform(-3, 3, (nbox, 3)).astype(np.float32)
        centers[:nbox, 2] = rng.uniform(0.2, 2.0, nbox)  # z-up rooms
        sizes[:nbox] = rng.uniform(0.3, 1.8, (nbox, 3)).astype(np.float32)
        if self.use_angles:
            angles[:nbox] = rng.uniform(-np.pi, np.pi, nbox).astype(np.float32)

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

        sample = {
            "point_clouds": pc.astype(np.float32),
            "point_cloud_dims_min": pc.min(axis=0).astype(np.float32),
            "point_cloud_dims_max": pc.max(axis=0).astype(np.float32),
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
                "gt_ori_box_num": np.int64(nbox),
            })
        return sample


def make_batch(dataset, start: int, batch_size: int) -> dict:
    """Scenes start .. start+batch_size-1 stacked into (B, ...) numpy arrays."""
    samples = [dataset[i] for i in range(start, start + batch_size)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
