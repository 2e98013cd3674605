"""Dataset configuration: box parametrization and SUN RGB-D class vocabularies.

Counterpart of coda_neurips2023_tpu/datasets/config.py:27-158:
`DatasetConfigBase` (angle bins, box slots and the two corner
parametrizations), `SunrgbdAnonymousConfig` with its class vocabulary and
train/test ranges, `SunrgbdImageConfig` (the 46-class eval config) and the
asset loaders the CLIP text banks read.  The class-name `.npy` files are the
JAX package's (coda_neurips2023_tpu/datasets/assets/), read by path; an
explicit `asset_dir` overrides them.  ScanNet's configs are not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from coda_neurips2023_tpu_torch.ops import box_ops

SUNRGBD_CLASSES_V1 = "all_classes_trainval_v1.npy"
SUNRGBD_CLASSES_V2 = "all_classes_trainval_v2_revised_del_val_less_than_5_classes.npy"
CMP_CLASSES_SUNRGBD = "ov_3detr.npy"
CMP_CLASSES_SCANNET = "ov_3detr_scannet.npy"
SUPERSET_CLASSES = "lvis_1204.npy"

DEFAULT_ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "coda_neurips2023_tpu", "datasets", "assets",
)


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

    def box_parametrization_to_corners(self, center_unnorm, size, angle):
        center_upright = box_ops.flip_axis_to_camera(center_unnorm)
        return box_ops.get_3d_box_batch(size, angle, center_upright)

    def box_parametrization_to_corners_xyz(self, center_unnorm, size, angle):
        return box_ops.get_3d_box_batch_xyz(size, angle, center_unnorm)


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
