"""OV-ScanNet detection datasets (host numpy pipeline).

Counterpart of coda_neurips2023_tpu/datasets/scannet.py, copied: one
parameterized dataset for the reference's ScanNet family, making the same
numpy draws in the same order, so a seed gives the JAX dataset's samples
bit for bit.  Where it differs from the SUN RGB-D pipeline:

  * on disk: {root}_{split}/{scene}_{seq}_pc.npy (N, 6) and
    {scene}_{seq}_bbox.npy (K, 8) with half extents at columns 3:6 and raw
    ScanNet-200 class ids; stage-2 pseudo labels have their sizes halved and
    their angle negated on load;
  * `root_dir` is the train directory itself; another split reads the
    directory whose basename has `train` replaced by the split's name;
  * the scan list is the directory's `*_pc.npy` files (the reference's
    `listdir`, not `meta_data/scannetv2_{split}.txt`);
  * the subsample happens before augmentation, which is the image flip,
    then the YZ and XZ flips (the latter gives `zx_flip_array`), rotz
    +-30 degrees and a scale of 0.85-1.15; no RandomCuboid;
  * raw_sizes = 2 x half extents and raw_angles = -angle; the calibration is
    the 4x4 camera pose {scene}/pose/{seq}.txt and the 4x4 colour intrinsics
    {scene}/intrinsic/intrinsic_color.txt.

`_load_image` is the one place that decodes an image; it needs OpenCV (cv2)
and raises a clear error without it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from coda_neurips2023_tpu_torch.datasets.augment import augment_image, rotz
from coda_neurips2023_tpu_torch.datasets.config import ScannetAnonymousConfig
from coda_neurips2023_tpu_torch.datasets.sunrgbd import (
    MEAN_COLOR_RGB,
    _corners_np_camera,
    _corners_np_xyz,
    _scalar_angle2class,
)


def load_txt_matrix(path):
    """A whitespace-separated matrix, one row a line, blank lines skipped."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = [float(x) for x in line.strip().split()]
            if vals:
                rows.append(vals)
    return np.array(rows)


class ScannetDetectionDataset:
    def __init__(
        self,
        dataset_config: ScannetAnonymousConfig,
        split_set: str = "train",
        root_dir: Optional[str] = None,
        param_dir: Optional[str] = None,
        num_points: int = 40000,
        use_color: bool = False,
        augment: bool = False,
        if_input_image: bool = False,
        if_image_augment: bool = False,
        anonymous: bool = True,
        use_pseudo_labels: bool = False,
        pseudo_setting: str = "setting0",
        confidence_type_in_datalayer: str = "weight_one",
        seed: Optional[int] = None,
    ):
        self.dataset_config = dataset_config
        self.split_set = split_set
        if root_dir and "train" not in split_set:
            # only the basename's `train` is replaced: a parent such as
            # `training_data/` keeps its name
            head, base = os.path.split(os.path.normpath(root_dir))
            derived = os.path.join(head, base.replace("train", split_set))
            if derived == os.path.normpath(root_dir):
                raise ValueError(
                    f"scannet split {split_set!r}: root_dir basename {base!r} contains "
                    "no 'train' to substitute -- the val split would silently read the "
                    "train directory (root_dir is the train dir)"
                )
            self.data_path = derived
        else:
            self.data_path = root_dir or None
        self.param_dir = param_dir
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
        self.rng = np.random.default_rng(seed)
        if self.data_path and os.path.isdir(self.data_path):
            self.data_names = sorted(
                {x[: -len("_pc.npy")] for x in os.listdir(self.data_path) if x.endswith("_pc.npy")}
            )
        else:
            self.data_names = []
        if self.use_pseudo_labels and self.data_path:
            self.pseudo_data_path = self.data_path.replace(
                "train", "noveltrain_pseudo_labels_" + pseudo_setting
            )
            os.makedirs(self.pseudo_data_path, exist_ok=True)
        else:
            self.pseudo_data_path = None

    def __len__(self):
        return len(self.data_names)

    def load_boxes(self, data_name: str):
        """Real boxes get [cate_prob=1, objectness=1, is_real=1] columns;
        pseudo boxes have their full extents halved, their angle negated and
        is_real=0."""
        scan_path = os.path.join(self.data_path, data_name)
        point_cloud = np.load(scan_path + "_pc.npy")
        raw = np.load(scan_path + "_bbox.npy")
        boxes = np.ones((raw.shape[0], 11))
        boxes[:, : raw.shape[1]] = raw
        pseudo_box_path = "_"
        if self.use_pseudo_labels:
            pseudo_path = os.path.join(self.pseudo_data_path, data_name)
            pseudo_box_path = pseudo_path + "_novel_bbox.npy"
            if os.path.exists(pseudo_box_path):
                p = np.load(pseudo_box_path)
            else:
                p = np.zeros((0, 8))
                np.save(pseudo_box_path, p)
            if p.shape[0] > 0:
                p = p.copy()
                p[:, 3:6] = p[:, 3:6] / 2
                p[:, 6] = p[:, 6] * -1
                pseudo = np.zeros((p.shape[0], 11))
                pseudo[:, : p.shape[1]] = p
                boxes = np.concatenate([boxes, pseudo], axis=0)
        return point_cloud, boxes, pseudo_box_path, boxes.shape[0]

    def _filter_boxes(self, boxes_source):
        """Ground-truth boxes carry raw ScanNet-200 ids.  With the config's
        raw-id lists (the scripts'):
          * anonymous train: a real box is kept if its id is in
            train_range_list, its weak label being the id's position there;
            pseudo boxes are always kept (their class column is already a
            bank row);
          * anonymous val: a box is kept if its id is in test_range_list.
            The reference's own filter raises a KeyError on a novel id here
            (it looks the id up in a map built from train_range_list only);
            no shipped config reaches this path, so novel ids map to
            train_max, the named-eval convention, a graceful superset;
          * named eval (scannet50, cmp): ids in class_id_to_idx, relabelled
            to contiguous eval indices.
        Without the lists (synthetic, tests) contiguous ranges are used."""
        cfg = self.dataset_config
        train_ids = getattr(cfg, "train_range_list", None) or cfg.train_range
        test_ids = getattr(cfg, "test_range_list_raw", None) or cfg.test_range
        reorder = getattr(cfg, "seen_reorder", None)
        eval_remap = getattr(cfg, "class_id_to_idx", None)
        kept, seen_cls, seen_confi = [], [], []
        for row in boxes_source:
            is_real = row[-1] == 1
            if self.anonymous and self.split_set == "train":
                if is_real:
                    if int(row[7]) in train_ids:
                        seen_cls.append(reorder[int(row[7])] if reorder else row[7])
                        r = row[:8].copy()
                        r[7] = 0
                        kept.append(r)
                        seen_confi.append(1.0)
                else:
                    seen_cls.append(row[7])
                    r = row[:8].copy()
                    r[7] = 0
                    kept.append(r)
                    ct = self.confidence_type_in_datalayer
                    if ct == "clip-max-prob":
                        seen_confi.append(row[8])
                    elif ct == "zero-out":
                        seen_confi.append(0.0)
                    elif ct == "objectness":
                        seen_confi.append(row[9])
                    elif ct == "clip+objectness":
                        seen_confi.append((row[8] + row[9]) / 2.0)
                    else:
                        seen_confi.append(1.0)
            elif self.anonymous:
                if int(row[7]) in test_ids:
                    if reorder:
                        seen_cls.append(reorder.get(int(row[7]), cfg.train_max))
                    else:
                        seen_cls.append(row[7] if int(row[7]) in train_ids else cfg.train_max)
                    r = row[:8].copy()
                    r[7] = 0
                    kept.append(r)
                    seen_confi.append(1.0)
            else:
                if eval_remap is not None:
                    if int(row[7]) in eval_remap:
                        r = row[:8].copy()
                        r[7] = eval_remap[int(row[7])]
                        kept.append(r)
                        seen_cls.append(r[7])
                        seen_confi.append(1.0)
                elif int(row[7]) in cfg.test_range:
                    seen_cls.append(row[7] if int(row[7]) in cfg.train_range else cfg.train_max)
                    kept.append(row[:8].copy())
                    seen_confi.append(1.0)
        if not kept:
            return np.zeros((0, 8)), np.zeros((0,)), np.zeros((0,))
        return np.array(kept), np.array(seen_cls), np.array(seen_confi)

    def _load_image(self, data_name: str):
        """The scan's `.jpg` (BGR), padded white to the config's image size
        and turned to RGB; returns (image, path, (height, width),
        (x_offset, y_offset))."""
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                "reading ScanNet images (--if_input_image on real scans) needs OpenCV "
                "(cv2), which this Python does not have"
            ) from e

        image_name = os.path.join(self.data_path, data_name) + ".jpg"
        img = cv2.imread(image_name).astype(np.float32)
        height, width = img.shape[:2]
        padded = np.ones((self.image_size[1], self.image_size[0], 3), np.uint8) * 255
        x_offset = (self.image_size[1] - height) // 2
        y_offset = (self.image_size[0] - width) // 2
        padded[x_offset : x_offset + height, y_offset : y_offset + width] = img
        padded = cv2.cvtColor(padded, cv2.COLOR_BGR2RGB).astype(np.uint8)
        return padded, image_name, (height, width), (x_offset, y_offset)

    def __getitem__(self, idx: int) -> dict:
        rng = self.rng
        cfg = self.dataset_config
        data_name = self.data_names[idx]
        scan_name = "_".join(data_name.split("_")[:2])
        seq_name = data_name.split("_")[-1]
        mesh_vertices, boxes_source, pseudo_box_path, ori_num = self.load_boxes(data_name)
        instance_bboxes, seen_cls, seen_confi = self._filter_boxes(boxes_source)

        image = None
        x_offset = y_offset = 0
        ori_h = ori_w = 0
        image_name = ""
        if self.if_input_image:
            image, image_name, (ori_h, ori_w), (x_offset, y_offset) = self._load_image(
                data_name
            )

        if not self.use_color:
            point_cloud = mesh_vertices[:, 0:3].copy()
            pcl_color = mesh_vertices[:, 3:6]
        else:
            point_cloud = mesh_vertices[:, 0:6].copy()
            point_cloud[:, 3:] = (point_cloud[:, 3:] - MEAN_COLOR_RGB) / 256.0
            pcl_color = point_cloud[:, 3:]

        # the subsample comes before augmentation
        replace = point_cloud.shape[0] < self.num_points
        choices = rng.choice(point_cloud.shape[0], self.num_points, replace=replace)
        point_cloud = point_cloud[choices]
        point_cloud_rgb = mesh_vertices[choices, 0:6]
        pcl_color = pcl_color[choices]

        mo = self.max_num_obj
        mask = np.zeros((mo,), np.float32)
        target_bboxes = np.zeros((mo, 7), np.float64)
        nbox = instance_bboxes.shape[0]
        mask[:nbox] = 1
        target_bboxes[:nbox] = instance_bboxes[:, 0:7]

        image_flip_array = np.ones(1)
        if self.if_input_image and self.image_augment:
            image, image_flip_array, _ = augment_image(rng, image, self.image_size[0])

        rot_array = np.identity(3)
        scale_array = np.ones((1, 3))
        flip_array = np.ones(1)
        zx_flip_array = np.ones(1)
        rot_angle = np.zeros(1)
        if self.augment:
            if rng.random() > 0.5:  # YZ-plane flip
                point_cloud[:, 0] *= -1
                point_cloud_rgb[:, 0] *= -1
                target_bboxes[:, 0] *= -1
                target_bboxes[:, 6] = np.pi - target_bboxes[:, 6]
                flip_array = flip_array * -1
            if rng.random() > 0.5:  # XZ-plane flip
                point_cloud[:, 1] *= -1
                point_cloud_rgb[:, 1] *= -1
                target_bboxes[:, 1] *= -1
                target_bboxes[:, 6] = np.pi - target_bboxes[:, 6]
                zx_flip_array = zx_flip_array * -1
            ra = rng.random() * np.pi / 3 - np.pi / 6
            rot_angle = np.array([ra])
            rot_mat = rotz(ra)
            point_cloud[:, 0:3] = point_cloud[:, 0:3] @ rot_mat.T
            point_cloud_rgb[:, 0:3] = point_cloud_rgb[:, 0:3] @ rot_mat.T
            target_bboxes[:, 0:3] = target_bboxes[:, 0:3] @ rot_mat.T
            rot_array = np.linalg.inv(rot_mat.T)
            target_bboxes[:, 6] -= ra
            scale_ratio = rng.random() * 0.3 + 0.85
            scale_ratio = np.tile(scale_ratio, 3)[None]
            scale_array = 1.0 / scale_ratio
            point_cloud[:, 0:3] *= scale_ratio
            point_cloud_rgb[:, 0:3] *= scale_ratio
            target_bboxes[:, 0:3] *= scale_ratio
            target_bboxes[:, 3:6] *= scale_ratio

        raw_sizes = (target_bboxes[:, 3:6] * 2 * mask[:, None]).astype(np.float32)
        raw_angles = (target_bboxes[:, 6] * -1 * mask).astype(np.float32)
        angle_classes = np.zeros((mo,), np.int64)
        angle_residuals = np.zeros((mo,), np.float32)
        for i in range(nbox):
            ac, ar = _scalar_angle2class(raw_angles[i], cfg.num_angle_bin)
            angle_classes[i] = ac
            angle_residuals[i] = ar
        angle_classes = (angle_classes * mask).astype(np.int64)
        angle_residuals = (angle_residuals * mask).astype(np.float32)

        pc_min = point_cloud[:, 0:3].min(axis=0)
        pc_max = point_cloud[:, 0:3].max(axis=0)
        mult = pc_max - pc_min
        centers = target_bboxes[:, 0:3].astype(np.float32)
        centers_normalized = ((centers - pc_min[None]) / mult[None]) * mask[:, None]
        sizes_normalized = raw_sizes / mult[None, :]

        corners_cam = _corners_np_camera(centers, raw_sizes, raw_angles)
        corners_xyz = _corners_np_xyz(centers, raw_sizes, raw_angles)

        semcls = np.zeros((mo,), np.int64)
        semcls[:nbox] = instance_bboxes[:, 7]
        seen_semcls = np.zeros((mo,), np.int64)
        seen_semconfi = np.zeros((mo,), np.float32)
        seen_semcls[:nbox] = seen_cls
        seen_semconfi[:nbox] = seen_confi

        ret = {
            "point_clouds": point_cloud.astype(np.float32),
            "point_clouds_rgb": point_cloud_rgb.astype(np.float32),
            "gt_box_corners": corners_cam.astype(np.float32),
            "gt_box_corners_xyz": corners_xyz.astype(np.float32),
            "gt_box_centers": centers,
            "gt_box_centers_normalized": centers_normalized.astype(np.float32),
            "gt_box_sem_cls_label": semcls,
            "gt_box_seen_sem_cls_label": seen_semcls,
            "gt_box_seen_sem_cls_confi": seen_semconfi,
            "gt_box_present": mask,
            "scan_idx": np.int64(idx),
            "gt_box_sizes": raw_sizes,
            "gt_box_sizes_normalized": sizes_normalized.astype(np.float32),
            "gt_box_angles": raw_angles,
            "gt_angle_class_label": angle_classes,
            "gt_angle_residual_label": angle_residuals,
            "point_cloud_dims_min": pc_min.astype(np.float32),
            "point_cloud_dims_max": pc_max.astype(np.float32),
            "pseudo_box_path": pseudo_box_path,
            "gt_ori_box_num": np.int64(ori_num),
        }
        if self.if_input_image:
            scan_param_path = os.path.join(self.param_dir or self.data_path, scan_name)
            rtilt = load_txt_matrix(scan_param_path + "/pose/" + seq_name + ".txt")
            k = load_txt_matrix(scan_param_path + "/intrinsic/intrinsic_color.txt")
            ret.update(
                {
                    "K": k.astype(np.float32),
                    "Rtilt": rtilt.astype(np.float32),
                    "input_image": image,
                    "x_offset": np.float32(x_offset),
                    "y_offset": np.float32(y_offset),
                    "im_name": image_name,
                    "ori_width": np.float32(ori_w),
                    "ori_height": np.float32(ori_h),
                    "flip_array": flip_array.astype(np.float32)[0],
                    "zx_flip_array": zx_flip_array.astype(np.float32)[0],
                    "scale_array": scale_array.astype(np.float32)[0],
                    "rot_array": rot_array.astype(np.float32),
                    "rot_angle": rot_angle.astype(np.float32)[0],
                    "image_flip_array": image_flip_array.astype(np.float32)[0],
                    "flip_length": np.float32(self.image_size[0]),
                }
            )
        return ret
