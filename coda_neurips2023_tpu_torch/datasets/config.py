"""Dataset configuration: box parametrization and SUN RGB-D class vocabularies.

Counterpart of coda_neurips2023_tpu/datasets/config.py:
`DatasetConfigBase` (angle bins, box slots, the two corner
parametrizations and my_compute_box_3d), `SunrgbdAnonymousConfig` with its
class vocabulary and train/test ranges, `SunrgbdImageConfig` (the 46-class
eval config), `SunrgbdCmpImageConfig` (the 20-class OV-3DETR comparison
config), ScanNet's three (`ScannetAnonymousConfig`, axis-aligned with one
angle bin; `Scannet50ImageConfig`, the 60-class eval config rebuilt from the
scripts' raw-id lists; `ScannetCmpImageConfig`, the 19-class comparison
config) and the asset loaders the CLIP text banks read.  The class-name
`.npy` files ship with this package, in datasets/assets/ beside this module
(byte-identical copies of the JAX package's); an explicit `asset_dir`
overrides them.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from coda_neurips2023_tpu_torch.ops import box_ops

SUNRGBD_CLASSES_V1 = "all_classes_trainval_v1.npy"
SUNRGBD_CLASSES_V2 = "all_classes_trainval_v2_revised_del_val_less_than_5_classes.npy"
SCANNET_CLASSES = "scannet_200_classname_no_wall_floor.npy"
SCANNET_CLASS2ID = "scannet_200_class2id.npy"
CMP_CLASSES_SUNRGBD = "ov_3detr.npy"
CMP_CLASSES_SCANNET = "ov_3detr_scannet.npy"
SUPERSET_CLASSES = "lvis_1204.npy"

DEFAULT_ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")

# the OV-3DETR comparison vocabulary: raw SUN RGB-D v1 class ids in the
# order of the ov_3detr.npy names
CMP_RAW_IDS_SUNRGBD = [0, 1, 2, 4, 5, 6, 9, 11, 14, 22, 24, 27, 31, 40, 48, 51, 55, 71, 106, 218]
# and for ScanNet: raw ScanNet-200 class ids in the order of ov_3detr_scannet.npy
CMP_RAW_IDS_SCANNET = [17, 11, 2, 36, 4, 7, 18, 13, 14, 42, 27, 9, 34, 35, 5, 21, 26, 28, 47]


def _asset_path(asset_dir: Optional[str], filename: str) -> Optional[str]:
    for d in (asset_dir, DEFAULT_ASSET_DIR):
        if d:
            p = os.path.join(d, filename)
            if os.path.exists(p):
                return p
    return None


def _load_asset(asset_dir: Optional[str], filename: str):
    p = _asset_path(asset_dir, filename)
    return np.load(p, allow_pickle=True) if p else None


def _load_type2class(asset_dir: Optional[str], filename: str, fallback_n: int):
    obj = _load_asset(asset_dir, filename)
    if obj is not None:
        try:
            return dict(obj.item())
        except (ValueError, AttributeError):
            return {str(name): i for i, name in enumerate(list(obj))}
    return {f"class_{i:04d}": i for i in range(fallback_n)}


def load_superset_names(asset_dir: Optional[str] = None):
    """LVIS superset names (lvis_1204.npy without its 'name' header row);
    None when the asset is absent."""
    obj = _load_asset(asset_dir, SUPERSET_CLASSES)
    return [str(n) for n in list(obj)[1:]] if obj is not None else None


def load_cmp_names(asset_dir: Optional[str] = None, scannet: bool = False):
    """OV-3DETR comparison vocabulary names (ov_3detr(_scannet).npy)."""
    obj = _load_asset(asset_dir, CMP_CLASSES_SCANNET if scannet else CMP_CLASSES_SUNRGBD)
    return [str(n) for n in list(obj)] if obj is not None else None


class DatasetConfigBase:
    num_semcls: int = 1
    num_angle_bin: int = 12
    max_num_obj: int = 64

    def angle2class(self, angle):
        return box_ops.angle2class(angle, self.num_angle_bin)

    def class2angle(self, cls, residual):
        return box_ops.class2angle(cls, residual, self.num_angle_bin)

    def class2anglebatch(self, cls, residual):
        return box_ops.class2angle(cls, residual, self.num_angle_bin)

    def box_parametrization_to_corners(self, center_unnorm, size, angle):
        center_upright = box_ops.flip_axis_to_camera(center_unnorm)
        return box_ops.get_3d_box_batch(size, angle, center_upright)

    def box_parametrization_to_corners_xyz(self, center_unnorm, size, angle):
        return box_ops.get_3d_box_batch_xyz(size, angle, center_unnorm)

    def my_compute_box_3d(self, center, size, heading_angle):
        return box_ops.my_compute_box_3d(center, size, heading_angle)


class SunrgbdAnonymousConfig(DatasetConfigBase):
    """OV-SUN RGB-D training config: class-agnostic ground truth (one
    semantic class), 12 heading-angle bins, 64 box slots a scene, and the
    train/test class ranges of the open-vocabulary protocol."""

    def __init__(
        self,
        asset_dir: Optional[str] = None,
        use_v1: bool = True,
        train_range=(0, 10),
        test_range=(0, 46),
        image_size=(730, 531),
    ):
        self.num_semcls = 1
        self.num_angle_bin = 12
        self.max_num_obj = 64
        self.type2class = _load_type2class(
            asset_dir, SUNRGBD_CLASSES_V1 if use_v1 else SUNRGBD_CLASSES_V2, test_range[1]
        )
        self.class2type = {v: k for k, v in self.type2class.items()}
        self.train_range = list(range(*train_range))
        self.test_range = list(range(*test_range))
        self.train_max = train_range[1]
        self.test_max = test_range[1]
        self.image_size = list(image_size)  # (width, height) of the padded image
        self.if_padding_image = True
        # eval-vocabulary names in bank order, and the bank rows of seen classes
        self.vocab_names = [
            self.class2type.get(i, f"class_{i:04d}") for i in range(self.test_max)
        ]
        self.seen_vocab_idx = list(range(self.train_max))


class SunrgbdImageConfig(SunrgbdAnonymousConfig):
    """46-class `sunrgbd_image` eval config: named classes, seen rows [:10]."""

    def __init__(self, asset_dir=None, use_v1=True, num_semcls=46, **kw):
        super().__init__(asset_dir, use_v1, **kw)
        self.num_semcls = num_semcls


class ScannetAnonymousConfig(DatasetConfigBase):
    """OV-ScanNet training config: axis-aligned boxes (one angle bin).

    Ground-truth boxes on disk carry raw ScanNet-200 class ids.  With the
    scripts' `train_range_list`/`test_range_list` the dataset keeps boxes by
    those raw ids, and a seen box's weak label is its id's position in
    `train_range_list` (`seen_reorder`)."""

    def __init__(
        self,
        asset_dir: Optional[str] = None,
        train_range=(0, 10),
        test_range=(0, 60),
        image_size=(1296, 968),
        train_range_list=None,
        test_range_list=None,
    ):
        self.num_semcls = 1
        self.num_angle_bin = 1
        self.max_num_obj = 64
        self.type2class = _load_type2class(asset_dir, SCANNET_CLASSES, test_range[1])
        self.class2type = {v: k for k, v in self.type2class.items()}
        self.train_range = list(range(*train_range))
        self.test_range = list(range(*test_range))
        self.train_max = train_range[1]
        self.test_max = test_range[1]
        self.image_size = list(image_size)
        self.if_padding_image = True
        self.vocab_names = [
            self.class2type.get(i, f"class_{i:04d}") for i in range(self.test_max)
        ]
        self.seen_vocab_idx = list(range(self.train_max))
        self.train_range_list = list(train_range_list) if train_range_list else None
        self.test_range_list_raw = list(test_range_list) if test_range_list else None
        if self.train_range_list:
            # raw id -> weak-label bank row
            self.seen_reorder = {cid: i for i, cid in enumerate(self.train_range_list)}
        else:
            self.seen_reorder = None


class Scannet50ImageConfig(ScannetAnonymousConfig):
    """60-class `scannet50_image` eval config with seen/novel index buckets.

    With `train_range_list` and `test_range_list` the vocabulary is the seen
    ids plus the first `reset_scannet_num` unseen test ids in test-list
    order, sorted; raw ids map to contiguous indices, and the seen and novel
    buckets follow that map.  Without the lists the buckets are contiguous
    index ranges."""

    def __init__(self, asset_dir=None, num_semcls=60, train_range=(0, 10),
                 test_range=(0, 60), train_range_list=None, test_range_list=None,
                 reset_scannet_num=50, **kw):
        super().__init__(asset_dir, train_range, test_range, **kw)
        self.num_semcls = num_semcls
        if train_range_list and test_range_list:
            self.reset_scannet_num = reset_scannet_num
            self.num_semcls = len(train_range_list) + reset_scannet_num
            self.train_range_list = list(train_range_list)
            eval_ids = list(train_range_list)
            cnt = 0
            for cid in test_range_list:
                if cid in train_range_list:
                    continue
                eval_ids.append(cid)
                cnt += 1
                if cnt >= reset_scannet_num:
                    break
            self.test_range_list = sorted(eval_ids)
            self.class_id_to_idx = {cid: i for i, cid in enumerate(self.test_range_list)}
            # names through the name -> raw id table, inverted
            name2id = _load_type2class(asset_dir, SCANNET_CLASS2ID, 0)
            id2name = {v: k for k, v in name2id.items()}
            self.class2type = {
                self.class_id_to_idx[cid]: id2name.get(cid, f"class_{cid:04d}")
                for cid in self.test_range_list
            }
            self.seen_idx_list = [self.class_id_to_idx[c] for c in train_range_list]
            self.novel_idx_list = [
                self.class_id_to_idx[c]
                for c in self.test_range_list
                if c not in train_range_list
            ]
            # bank rows in sorted raw-id order; the seen rows are the train ids'
            self.vocab_names = [self.class2type[i] for i in range(len(self.test_range_list))]
            self.seen_vocab_idx = list(self.seen_idx_list)
        else:
            self.seen_idx_list = list(range(*train_range))
            self.novel_idx_list = [
                i for i in range(*test_range) if i not in self.seen_idx_list
            ]


class SunrgbdCmpImageConfig(SunrgbdAnonymousConfig):
    """20-class OV-3DETR comparison eval config: ground-truth boxes are kept
    for the 20 raw v1 class ids and renumbered in the ov_3detr.npy name
    order; the model classifies against the cmp text bank."""

    def __init__(self, asset_dir=None, use_v1=True, **kw):
        super().__init__(asset_dir, use_v1, **kw)
        self.cmp_raw_ids = list(CMP_RAW_IDS_SUNRGBD)
        self.num_semcls = len(self.cmp_raw_ids)
        # raw v1 id -> cmp index, its position in the ov_3detr name list
        self.test_class_to_dix = {cid: i for i, cid in enumerate(self.cmp_raw_ids)}
        names = load_cmp_names(asset_dir, scannet=False)
        if names is None:
            names = [self.class2type.get(cid, f"class_{cid:04d}") for cid in self.cmp_raw_ids]
        self.class2type = dict(enumerate(names))
        self.type2class = {v: k for k, v in self.class2type.items()}
        self.vocab_names = list(names)
        self.seen_vocab_idx = []


class ScannetCmpImageConfig(ScannetAnonymousConfig):
    """19-class OV-3DETR comparison eval config for ScanNet: raw ScanNet-200
    ids in the ov_3detr_scannet.npy name order."""

    def __init__(self, asset_dir=None, **kw):
        super().__init__(asset_dir, **kw)
        self.cmp_raw_ids = list(CMP_RAW_IDS_SCANNET)
        self.num_semcls = len(self.cmp_raw_ids)
        self.test_class_to_dix = {cid: i for i, cid in enumerate(self.cmp_raw_ids)}
        self.class_id_to_idx = dict(self.test_class_to_dix)
        names = load_cmp_names(asset_dir, scannet=True)
        if names is None:
            name2id = _load_type2class(asset_dir, SCANNET_CLASS2ID, 0)
            id2name = {v: k for k, v in name2id.items()}
            names = [id2name.get(cid, f"class_{cid:04d}") for cid in self.cmp_raw_ids]
        self.class2type = dict(enumerate(names))
        self.type2class = {v: k for k, v in self.class2type.items()}
        self.vocab_names = list(names)
        self.seen_vocab_idx = []
