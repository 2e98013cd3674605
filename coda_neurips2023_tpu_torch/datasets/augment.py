"""Host-side data augmentations (numpy).

Counterpart of coda_neurips2023_tpu/datasets/augment.py, copied, with the
same draws in the same order from the generator passed in:
  * image: 50% horizontal flip, per-channel brightness (x in [0.8, 1.2]) and
    shift (+- 0.05), per-pixel jitter (+- 0.025), clip to [0, 1];
  * point cloud: 50% YZ-plane flip (x -> -x, angle -> pi - angle), rotz in
    [-30deg, +30deg], global scale in [0.85, 1.15]; the inverse transforms
    (flip_array, rot_array, scale_array) are returned so predicted boxes can
    be projected back into the image;
  * RandomCuboid: a random aspect-checked cuboid crop keeping >= min_points
    points and >= 1 box centre;
  * VirtualObjectAugmentor: object point clouds from .npy files inserted
    into the scene with their boxes;
  * random_sampling: the fixed-size point subsample, the only one the eval
    split uses.
"""

from __future__ import annotations

import numpy as np


def rotz(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def augment_image(rng: np.random.RandomState, image: np.ndarray, image_width: int):
    """Returns (image uint8, image_flip_array (1,), flipped: bool)."""
    image = image.astype(np.float64) / 255.0
    image_flip_array = np.ones(1)
    flipped = False
    if rng.random() > 0.5:
        image = image[:, ::-1, :]
        image_flip_array = np.zeros(1)
        flipped = True
    image = image * (1 + 0.4 * rng.random(3) - 0.2)
    image = image + (0.1 * rng.random(3) - 0.05)
    image = image + (0.05 * rng.random(image.shape[:2]) - 0.025)[..., None]
    image = np.clip(image, 0, 1) * 255.0
    return image.astype(np.uint8), image_flip_array, flipped


def augment_pointcloud(rng, point_cloud: np.ndarray, bboxes: np.ndarray):
    """In the reference's order: flip -> rotz -> scale.  bboxes: (K, >=8)
    [cx cy cz l/2 w/2 h/2 angle cls ...].  Returns
    (point_cloud, bboxes, flip_array (1,), rot_array (3,3), scale_array (1,3),
    rot_angle (1,))."""
    flip_array = np.ones(1)
    if rng.random() > 0.5:
        point_cloud[:, 0] = -point_cloud[:, 0]
        bboxes[:, 0] = -bboxes[:, 0]
        bboxes[:, 6] = np.pi - bboxes[:, 6]
        flip_array = flip_array * -1

    rot_angle = rng.random() * np.pi / 3 - np.pi / 6
    rot_mat = rotz(rot_angle)
    point_cloud[:, 0:3] = point_cloud[:, 0:3] @ rot_mat.T
    bboxes[:, 0:3] = bboxes[:, 0:3] @ rot_mat.T
    rot_array = np.linalg.inv(rot_mat.T)
    bboxes[:, 6] -= rot_angle

    scale_ratio = rng.random() * 0.3 + 0.85
    scale_ratio = np.tile(scale_ratio, 3)[None]
    scale_array = 1.0 / scale_ratio
    point_cloud[:, 0:3] *= scale_ratio
    bboxes[:, 0:3] *= scale_ratio
    bboxes[:, 3:6] *= scale_ratio
    return point_cloud, bboxes, flip_array, rot_array, scale_array, np.array([rot_angle])


def check_aspect(crop_range, aspect_min):
    xy = np.min(crop_range[:2]) / np.max(crop_range[:2])
    xz = np.min(crop_range[[0, 2]]) / np.max(crop_range[[0, 2]])
    yz = np.min(crop_range[1:]) / np.max(crop_range[1:])
    return xy >= aspect_min or xz >= aspect_min or yz >= aspect_min


class RandomCuboid:
    """utils/random_cuboid.py:16-122 (center box-filter policy)."""

    def __init__(self, min_points, aspect=0.75, min_crop=0.75, max_crop=1.0):
        self.min_points = min_points
        self.aspect = aspect
        self.min_crop = min_crop
        self.max_crop = max_crop

    def __call__(self, rng, point_cloud, boxes, box_extras=()):
        """box_extras: tuple of per-box arrays filtered alongside `boxes`.
        Returns (point_cloud, boxes, extras)."""
        range_xyz = np.max(point_cloud[:, 0:3], axis=0) - np.min(
            point_cloud[:, 0:3], axis=0
        )
        for _ in range(100):
            crop_range = self.min_crop + rng.random(3) * (self.max_crop - self.min_crop)
            if not check_aspect(crop_range, self.aspect):
                continue
            center = point_cloud[rng.choice(len(point_cloud)), 0:3]
            half = range_xyz * crop_range / 2.0
            keep = np.all(point_cloud[:, 0:3] <= center + half, axis=1) & np.all(
                point_cloud[:, 0:3] >= center - half, axis=1
            )
            if keep.sum() < self.min_points:
                continue
            new_pc = point_cloud[keep]
            new_boxes, extras = boxes, box_extras
            if boxes.sum() > 0:
                pc_min = new_pc[:, 0:3].min(axis=0)
                pc_max = new_pc[:, 0:3].max(axis=0)
                keep_boxes = np.all(boxes[:, 0:3] >= pc_min, axis=1) & np.all(
                    boxes[:, 0:3] <= pc_max, axis=1
                )
                if keep_boxes.sum() == 0:
                    continue
                new_boxes = boxes[keep_boxes]
                extras = tuple(
                    e[keep_boxes] if isinstance(e, np.ndarray) and len(e) == len(boxes) else e
                    for e in box_extras
                )
            return new_pc, new_boxes, extras
        return point_cloud, boxes, box_extras


class VirtualObjectAugmentor:
    """Virtual-object insertion (reference
    sunrgbd_anonymous_aligned_image_object_aug.py:391-520): point-e generated
    object point clouds are randomly rotated (+-90deg), scaled (0.5-1.1x),
    shifted into the scene bounds, concatenated to the scene, and their
    axis-aligned boxes appended as GT (half-extent convention, like the rest
    of the pipeline)."""

    def __init__(self, object_dir: str, class_id: int = 0, max_objects: int = 1):
        import os

        self.paths = []
        if object_dir and os.path.isdir(object_dir):
            self.paths = sorted(
                os.path.join(object_dir, f)
                for f in os.listdir(object_dir)
                if f.endswith(".npy")
            )
        self.class_id = class_id
        self.max_objects = max_objects

    def __call__(self, rng, point_cloud: np.ndarray, bboxes: np.ndarray):
        if not self.paths:
            return point_cloud, bboxes
        n_obj = int(rng.integers(1, self.max_objects + 1))
        for _ in range(n_obj):
            obj = np.load(self.paths[int(rng.integers(0, len(self.paths)))])[:, :3]
            # random rotation -90..+90 about Z
            rot_angle = rng.random() * np.pi - np.pi / 2
            obj = obj @ rotz(rot_angle).T
            # random scale 0.5-1.1
            obj = obj * (rng.random() * 0.6 + 0.5)
            # shrink while larger than the scene
            scene_ext = point_cloud[:, :3].max(0) - point_cloud[:, :3].min(0)
            while np.any(obj.max(0) - obj.min(0) > scene_ext):
                obj = obj * 0.75
            # random shift into the scene bounds
            lo = point_cloud[:, :3].min(0) - obj.min(0)
            hi = point_cloud[:, :3].max(0) - obj.max(0)
            shift = np.array(
                [rng.uniform(min(lo[d], hi[d]), max(lo[d], hi[d])) for d in range(3)]
            )
            obj = obj + shift
            center = (obj.max(0) + obj.min(0)) / 2
            half = (obj.max(0) - obj.min(0)) / 2
            row = np.zeros((1, bboxes.shape[1] if bboxes.size else 8))
            row[0, 0:3] = center
            row[0, 3:6] = half
            row[0, 6] = -rot_angle
            row[0, 7] = self.class_id
            pad = np.zeros((obj.shape[0], point_cloud.shape[1]))
            pad[:, :3] = obj
            point_cloud = np.concatenate([point_cloud, pad], axis=0)
            bboxes = np.concatenate([bboxes, row], axis=0) if bboxes.size else row
        return point_cloud, bboxes


def random_sampling(rng, pc: np.ndarray, num_sample: int, return_choices=False):
    """utils/pc_util.py:24-33."""
    replace = pc.shape[0] < num_sample
    choices = rng.choice(pc.shape[0], num_sample, replace=replace)
    if return_choices:
        return pc[choices], choices
    return pc[choices]
