"""SUN RGB-D detection datasets (host numpy pipeline).

Counterpart of coda_neurips2023_tpu/datasets/sunrgbd.py, copied: one
parameterized dataset for the reference's SUN RGB-D family, with the same
samples from the same generator state:

  * anonymous OV-training variants ("sunrgbd_anonymous_aligned_image",
    "..._with_novel_cate_confi"): class-agnostic labels (sem cls 0), seen
    class ids and confidences kept apart, optional on-disk pseudo-label
    merge (stage 2);
  * named eval variants ("sunrgbd_image", "sunrgbd_cmp_image"): 46-class or
    cmp-vocabulary labels.

On-disk contract (the reference's):
  {root}_{split}/{scan}_pc.npz ["pc"] (50k, 6), {scan}_bbox.npy (K, 8)
  [cx cy cz l/2 w/2 h/2 angle cls]; stage-2 pseudo labels at
  {root}_noveltrain_pseudo_labels_{setting}/{scan}_novel_bbox.npy (K, >=8,
  full extents halved on load, plus cate-prob / objectness / is-real
  columns); calib {calib_dir}/{scan}.txt (Rtilt, K column-major); image
  {image_dir}/{scan}.jpg (BGR, padded white to width 730, height 531).

`_load_image` imports cv2 when an image is read, as the JAX package does; a
machine without cv2 raises there, and only runs with --if_input_image on
real scans read images.  The sample's string fields (im_name,
pseudo_box_path, calib_name) stay lists on the host through the loader.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from coda_neurips2023_tpu_torch.datasets.augment import (
    RandomCuboid,
    augment_image,
    augment_pointcloud,
    random_sampling,
)
from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
from coda_neurips2023_tpu_torch.ops import box_ops

MEAN_COLOR_RGB = np.array([0.5, 0.5, 0.5])


def load_sunrgbd_calib(calib_path: str):
    """Rtilt + K, column-major reshape (sunrgbd_utils.py:96-104)."""
    lines = [line.rstrip() for line in open(calib_path)]
    rtilt = np.reshape(np.array([float(x) for x in lines[0].split(" ")]), (3, 3), order="F")
    k = np.reshape(np.array([float(x) for x in lines[1].split(" ")]), (3, 3), order="F")
    return rtilt, k


def project_upright_depth_to_image_np(pc, k, rtilt):
    """sunrgbd_utils.py:105-124 (numpy)."""
    pc2 = (rtilt.T @ pc[:, 0:3].T).T
    pc2 = np.stack([pc2[:, 0], -pc2[:, 2], pc2[:, 1]], axis=1)
    uv = pc2 @ k.T
    uv[:, 0] /= uv[:, 2]
    uv[:, 1] /= uv[:, 2]
    return uv[:, 0:2], pc2[:, 2]


class SunrgbdDetectionDataset:
    """split_set in {train, val, trainval, ...}; `anonymous`=True gives the
    class-agnostic OV-training labels; `use_pseudo_labels`=True additionally
    merges stage-2 pseudo labels (the _with_novel_cate_confi variant)."""

    def __init__(
        self,
        dataset_config: SunrgbdAnonymousConfig,
        split_set: str = "train",
        root_dir: Optional[str] = None,
        calib_dir: Optional[str] = None,
        image_dir: Optional[str] = None,
        num_points: int = 20000,
        use_color: bool = False,
        augment: bool = False,
        if_input_image: bool = False,
        if_image_augment: bool = False,
        anonymous: bool = True,
        use_pseudo_labels: bool = False,
        pseudo_setting: str = "setting0",
        confidence_type_in_datalayer: str = "weight_one",
        use_random_cuboid: bool = True,
        random_cuboid_min_points: int = 30000,
        object_aug_dir: Optional[str] = None,
        seed: Optional[int] = None,
    ):
        assert num_points <= 50000
        self.dataset_config = dataset_config
        self.split_set = split_set
        self.data_path = f"{root_dir}_{split_set}" if root_dir else None
        self.calib_dir = calib_dir
        self.image_dir = image_dir
        self.num_points = num_points
        self.use_color = use_color
        self.augment = augment
        self.if_input_image = if_input_image
        self.image_augment = if_image_augment
        self.anonymous = anonymous
        self.use_pseudo_labels = use_pseudo_labels and split_set == "train"
        self.confidence_type_in_datalayer = confidence_type_in_datalayer
        self.image_size = dataset_config.image_size
        self.max_num_obj = dataset_config.max_num_obj
        self.center_normalizing_range = (
            np.zeros((1, 3), np.float32),
            np.ones((1, 3), np.float32),
        )
        self.use_random_cuboid = use_random_cuboid
        self.random_cuboid_augmentor = RandomCuboid(
            min_points=random_cuboid_min_points, aspect=0.75, min_crop=0.75, max_crop=1.0
        )
        # virtual-object insertion (the `_object_aug` dataset variant)
        self.object_augmentor = None
        if object_aug_dir:
            from coda_neurips2023_tpu_torch.datasets.augment import VirtualObjectAugmentor

            self.object_augmentor = VirtualObjectAugmentor(object_aug_dir)
        self.rng = np.random.default_rng(seed)
        if self.data_path and os.path.isdir(self.data_path):
            self.scan_names = sorted(
                {os.path.basename(x)[0:6] for x in os.listdir(self.data_path)}
            )
        else:
            self.scan_names = []
        if self.use_pseudo_labels and self.data_path:
            self.pseudo_data_path = self.data_path.replace(
                "train", "noveltrain_pseudo_labels_" + pseudo_setting
            )
            os.makedirs(self.pseudo_data_path, exist_ok=True)
        else:
            self.pseudo_data_path = None

    def __len__(self):
        return len(self.scan_names)

    # ---------------- raw loading ----------------

    def load_boxes(self, scan_name: str):
        """Reference load_boxes (…with_novel_cate_confi.py:392-431):
        real boxes get [cate_prob=1, objectness=1, is_real=1] columns; pseudo
        boxes have full-extent sizes halved and is_real=0."""
        scan_path = os.path.join(self.data_path, scan_name)
        point_cloud = np.load(scan_path + "_pc.npz")["pc"]
        raw = np.load(scan_path + "_bbox.npy")
        boxes = np.ones((raw.shape[0], 11))
        boxes[:, : raw.shape[1]] = raw

        pseudo_box_path = "_"
        if self.use_pseudo_labels:
            pseudo_path = os.path.join(self.pseudo_data_path, scan_name)
            pseudo_box_path = pseudo_path + "_novel_bbox.npy"
            if os.path.exists(pseudo_box_path):
                p = np.load(pseudo_box_path)
            else:
                p = np.zeros((0, 8))
                np.save(pseudo_box_path, p)
            if p.shape[0] > 0:
                p = p.copy()
                p[:, 3:6] = p[:, 3:6] / 2
                pseudo = np.zeros((p.shape[0], 11))  # is_real column stays 0
                pseudo[:, : p.shape[1]] = p
                boxes = np.concatenate([boxes, pseudo], axis=0)
        return point_cloud, boxes, pseudo_box_path, boxes.shape[0]

    def _filter_boxes(self, boxes_source: np.ndarray):
        """Seen-class filter + per-box seen class/conf columns
        (…with_novel_cate_confi.py:500-565)."""
        cfg = self.dataset_config
        kept, seen_cls, seen_confi = [], [], []
        if self.anonymous:
            # …with_novel_cate_confi.py:522-565: real boxes kept if seen;
            # pseudo boxes always kept; labels anonymized to class 0.
            # This filter applies to EVERY split, not just train: the
            # reference's `if self.split_set == 'train' or 'noveltrain':`
            # (line 643; `or 'toilettrain'` in the non-confi variants) is
            # always true, so the test-range block above it is dead code and
            # the OV "test" split's GT also contains only train-range boxes
            # (live-pinned in tests/test_dataset_live_parity.py; val has no
            # pseudo rows because load_boxes only merges them for train)
            for row in boxes_source:
                is_real = row[-1] == 1
                if is_real:
                    if int(row[7]) in cfg.train_range:
                        seen_cls.append(row[7])
                        kept_row = row[:8].copy()
                        kept_row[7] = 0
                        kept.append(kept_row)
                        seen_confi.append(1.0)
                else:  # pseudo label
                    seen_cls.append(row[7])
                    kept_row = row[:8].copy()
                    kept_row[7] = 0
                    kept.append(kept_row)
                    ct = self.confidence_type_in_datalayer
                    if ct == "clip-max-prob":
                        seen_confi.append(row[8])
                    elif ct == "zero-out":
                        seen_confi.append(0.0)
                    elif ct == "objectness":
                        seen_confi.append(row[9])
                    elif ct == "clip+objectness":
                        seen_confi.append((row[8] + row[9]) / 2.0)
                    else:  # weight_one
                        seen_confi.append(1.0)
        elif getattr(cfg, "test_class_to_dix", None):
            # cmp eval variant (sunrgbd_cmp_image.py:485-507): keep only the
            # 20 OV-3DETR raw class ids, remap to cmp vocabulary order
            for row in boxes_source:
                if int(row[7]) in cfg.test_class_to_dix:
                    kept_row = row[:8].copy()
                    kept_row[7] = cfg.test_class_to_dix[int(row[7])]
                    kept.append(kept_row)
                    seen_cls.append(kept_row[7])
                    seen_confi.append(1.0)
        else:
            # named eval variants (sunrgbd_image.py): test-range classes with
            # their true labels
            for row in boxes_source:
                if int(row[7]) in cfg.test_range:
                    seen_cls.append(
                        row[7] if int(row[7]) in cfg.train_range else cfg.train_max
                    )
                    kept.append(row[:8].copy())
                    seen_confi.append(1.0)
        if not kept:
            return np.zeros((0, 8)), np.zeros((0,)), np.zeros((0,))
        return np.array(kept), np.array(seen_cls), np.array(seen_confi)

    def _load_image(self, scan_name: str):
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                "reading SUN RGB-D images (--if_input_image on real scans) needs OpenCV "
                "(cv2), which this Python does not have"
            ) from e

        image_name = os.path.join(self.image_dir, scan_name + ".jpg")
        img = cv2.imread(image_name).astype(np.float32)
        height, width = img.shape[:2]
        padded = np.ones((self.image_size[1], self.image_size[0], 3), np.uint8) * 255
        x_offset = (self.image_size[1] - height) // 2
        y_offset = (self.image_size[0] - width) // 2
        padded[x_offset : x_offset + height, y_offset : y_offset + width] = img
        padded = cv2.cvtColor(padded, cv2.COLOR_BGR2RGB).astype(np.uint8)
        return padded, image_name, (height, width), (x_offset, y_offset)

    # ---------------- sample assembly ----------------

    def __getitem__(self, idx: int) -> dict:
        rng = self.rng
        cfg = self.dataset_config
        scan_name = self.scan_names[idx]
        point_cloud, boxes_source, pseudo_box_path, ori_num = self.load_boxes(scan_name)
        bboxes, seen_cls, seen_confi = self._filter_boxes(boxes_source)

        ret = {}
        calib = image = None
        x_offset = y_offset = 0
        ori_h = ori_w = 0
        image_name = ""
        if self.if_input_image:
            image, image_name, (ori_h, ori_w), (x_offset, y_offset) = self._load_image(
                scan_name
            )
            rtilt, k = load_sunrgbd_calib(
                os.path.join(self.calib_dir, scan_name + ".txt")
            )
        point_cloud_rgb = point_cloud[:, 0:6]
        if not self.use_color:
            point_cloud = point_cloud[:, 0:3].copy()
        else:
            point_cloud = point_cloud[:, 0:6].copy()
            point_cloud[:, 3:] = point_cloud[:, 3:] - MEAN_COLOR_RGB

        image_flip_array = np.ones(1)
        if self.if_input_image and self.image_augment:
            image, image_flip_array, _ = augment_image(rng, image, self.image_size[0])

        rot_array = np.identity(3)
        scale_array = np.ones((1, 3))
        flip_array = np.ones(1)
        rot_angle = np.zeros(1)
        if self.augment:
            if self.object_augmentor is not None and bboxes.size:
                n_before = bboxes.shape[0]
                point_cloud, bboxes = self.object_augmentor(rng, point_cloud, bboxes)
                n_added = bboxes.shape[0] - n_before
                if n_added:
                    seen_cls = np.concatenate([seen_cls, np.zeros(n_added)])
                    seen_confi = np.concatenate([seen_confi, np.ones(n_added)])
            point_cloud, bboxes, flip_array, rot_array, scale_array, rot_angle = (
                augment_pointcloud(rng, point_cloud, bboxes)
            )
            if self.use_random_cuboid:
                point_cloud, bboxes, (seen_cls, seen_confi) = self.random_cuboid_augmentor(
                    rng, point_cloud, bboxes, (seen_cls, seen_confi)
                )

        # ---- padded labels (…with_novel_cate_confi.py:785-876) ----
        mo = self.max_num_obj
        nbox = bboxes.shape[0]
        if not self.anonymous:
            # named-eval contract (sunrgbd_image.py:805-806): gt_ori_box_num
            # is the KEPT count and no pseudo path is emitted
            ori_num = nbox
            pseudo_box_path = ""
        angle_classes = np.zeros((mo,), np.int64)
        angle_residuals = np.zeros((mo,), np.float32)
        raw_angles = np.zeros((mo,), np.float32)
        raw_sizes = np.zeros((mo, 3), np.float32)
        target_bboxes = np.zeros((mo, 6), np.float32)
        mask = np.zeros((mo,), np.float32)
        mask[:nbox] = 1
        for i in range(nbox):
            bbox = bboxes[i]
            raw_sizes[i] = bbox[3:6] * 2
            ac, ar = _scalar_angle2class(bbox[6], cfg.num_angle_bin)
            angle_classes[i] = ac
            angle_residuals[i] = ar
            corners = _my_compute_box_3d_np(bbox[0:3], bbox[3:6], bbox[6])
            cmin, cmax = corners.min(axis=0), corners.max(axis=0)
            target_bboxes[i, 0:3] = (cmin + cmax) / 2
            target_bboxes[i, 3:6] = cmax - cmin

        point_cloud, choices = random_sampling(
            rng, point_cloud, self.num_points, return_choices=True
        )
        # NB: the reference does NOT subsample the rgb cloud — the
        # `point_cloud_rgb[choices]` at …with_novel_cate_confi.py:830 is
        # commented out, so `point_clouds_rgb` keeps the full on-disk cloud in
        # original order (live-pinned in tests/test_dataset_live_parity.py)

        pc_min = point_cloud[:, 0:3].min(axis=0)
        pc_max = point_cloud[:, 0:3].max(axis=0)
        mult = pc_max - pc_min
        sizes_normalized = raw_sizes / mult[None, :]
        centers = target_bboxes[:, 0:3]
        centers_normalized = (centers - pc_min[None]) / mult[None]
        centers_normalized = centers_normalized * mask[:, None]

        # re-encode angles like the reference (class2angle roundtrip)
        angle_per_class = 2 * np.pi / cfg.num_angle_bin
        raw_angles = angle_classes * angle_per_class + angle_residuals
        raw_angles = np.where(raw_angles > np.pi, raw_angles - 2 * np.pi, raw_angles).astype(
            np.float32
        )

        corners_cam = _corners_np_camera(centers, raw_sizes, raw_angles)
        corners_xyz = _corners_np_xyz(centers, raw_sizes, raw_angles)

        semcls = np.zeros((mo,), np.int64)
        semcls[:nbox] = bboxes[:, 7]
        seen_semcls = np.zeros((mo,), np.int64)
        seen_semconfi = np.zeros((mo,), np.float32)
        seen_semcls[:nbox] = seen_cls
        seen_semconfi[:nbox] = seen_confi
        image_class_label = np.zeros(cfg.train_max, np.int64)
        for i in range(nbox):
            if seen_semcls[i] < cfg.train_max:
                image_class_label[seen_semcls[i]] = 1

        ret.update(
            {
                "point_clouds": point_cloud.astype(np.float32),
                "point_clouds_rgb": point_cloud_rgb.astype(np.float32),
                "gt_box_corners": corners_cam.astype(np.float32),
                "gt_box_corners_xyz": corners_xyz.astype(np.float32),
                "gt_box_centers": centers.astype(np.float32),
                "gt_box_centers_normalized": centers_normalized.astype(np.float32),
                "gt_image_class_label": image_class_label,
                "gt_box_sem_cls_label": semcls,
                "gt_box_seen_sem_cls_label": seen_semcls,
                "gt_box_seen_sem_cls_confi": seen_semconfi,
                "gt_box_present": mask,
                "scan_idx": np.int64(idx),
                "gt_box_sizes": raw_sizes.astype(np.float32),
                "gt_box_sizes_normalized": sizes_normalized.astype(np.float32),
                "gt_box_angles": raw_angles.astype(np.float32),
                "gt_angle_class_label": angle_classes,
                "gt_angle_residual_label": angle_residuals,
                "point_cloud_dims_min": pc_min.astype(np.float32),
                "point_cloud_dims_max": pc_max.astype(np.float32),
                "pseudo_box_path": pseudo_box_path,
                "gt_ori_box_num": np.int64(ori_num),
            }
        )
        if self.if_input_image:
            # reference (…with_novel_cate_confi.py:666-668, 828-831): project
            # the ORIGINAL cloud, add the pad offsets, index by the subsample
            # choices, then round-to-int64 minus 1.  We project the subsampled
            # rows directly (identical values when augment=False, the only
            # path where the reference's uv is aligned at all: under
            # augmentation it indexes pre-crop uv rows with post-crop choices
            # and is a dead/visualization-only output).
            uv_2d, _ = project_upright_depth_to_image_np(point_cloud[:, :3], k, rtilt)
            uv_2d[:, 0] += y_offset
            uv_2d[:, 1] += x_offset
            uv_2d = np.round(uv_2d).astype(np.int64) - 1
            ret.update(
                {
                    "K": k.astype(np.float32),
                    "Rtilt": rtilt.astype(np.float32),
                    "uv_2d": uv_2d.astype(np.float32),
                    "input_image": image,
                    "x_offset": np.float32(x_offset),
                    "y_offset": np.float32(y_offset),
                    "im_name": image_name,
                    # crop_image-mode batch inputs (sunrgbd_image.py:817,822;
                    # trans_mtx is zeros(1) on the live padded path, :450)
                    "calib_name": os.path.join(self.calib_dir, scan_name + ".txt"),
                    "trans_mtx": np.zeros(1, np.float32),
                    "ori_width": np.float32(ori_w),
                    "ori_height": np.float32(ori_h),
                    "flip_array": flip_array.astype(np.float32)[0],
                    "scale_array": scale_array.astype(np.float32)[0],
                    "rot_array": rot_array.astype(np.float32),
                    "rot_angle": rot_angle.astype(np.float32)[0],
                    "image_flip_array": image_flip_array.astype(np.float32)[0],
                    "flip_length": np.float32(self.image_size[0]),
                }
            )
        return ret


def _scalar_angle2class(angle: float, num_class: int):
    two_pi = 2 * np.pi
    angle = angle % two_pi
    angle_per_class = two_pi / num_class
    shifted = (angle + angle_per_class / 2) % two_pi
    cid = int(shifted / angle_per_class)
    return cid, shifted - (cid * angle_per_class + angle_per_class / 2)


def _my_compute_box_3d_np(center, size, heading_angle):
    return box_ops.my_compute_box_3d_np(
        np.asarray(center), np.asarray(size), np.float32(heading_angle)
    )


def _corners_np_camera(centers, sizes, angles):
    cam = box_ops.flip_axis_to_camera_np(np.asarray(centers))
    return box_ops.get_3d_box_batch_np(sizes, angles, cam)


def _corners_np_xyz(centers, sizes, angles):
    return box_ops.get_3d_box_batch_xyz_np(sizes, angles, centers)
