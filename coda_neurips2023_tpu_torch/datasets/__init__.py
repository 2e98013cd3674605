"""Dataset registry and split construction (host numpy pipelines).

Counterpart of coda_neurips2023_tpu/datasets/__init__.py :: build_dataset
(:102-196), for the SUN RGB-D family and the data-free synthetic scenes.  It
makes the reference's four splits: train and test on the OV-anonymous
config, `real_test` on the named eval config (46 classes for SUN RGB-D),
`real_cmp_test` on the OV-3DETR comparison vocabulary.  Without
--dataset_root_dir (or with --dataset_name synthetic) the splits are
synthetic scenes of the same contract (datasets/synthetic.py).  The ScanNet
family is not ported yet and raises.
"""

from __future__ import annotations

import os

from coda_neurips2023_tpu_torch.datasets.config import (
    SunrgbdAnonymousConfig,
    SunrgbdCmpImageConfig,
    SunrgbdImageConfig,
)
from coda_neurips2023_tpu_torch.datasets.sunrgbd import SunrgbdDetectionDataset
from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset

# the wired dataset names (the JAX package's DATASET_NAMES)
DATASET_NAMES = (
    "scannet_anonymous",
    "scannet50_image",
    "scannet_anonymous_aligned_image",
    "scannet_anonymous_aligned_image_with_novel_cate_confi",
    "sunrgbd_image",
    "sunrgbd_anonymous_aligned_image",
    "sunrgbd_anonymous_aligned_image_with_novel_cate_confi",
    "sunrgbd_anonymous_aligned_image_object_aug",
    "sunrgbd_cmp_image",
    "scannet_cmp_image",
    "synthetic",
)


def _sunrgbd_cfg(args, anonymous=True, num_semcls=None, cmp_vocab=False):
    """The anonymous training config, the named eval config, or with
    `cmp_vocab` the 20-class OV-3DETR comparison config."""
    kw = dict(
        asset_dir=getattr(args, "asset_dir", None),
        use_v1=getattr(args, "if_use_v1", True),
        train_range=(args.train_range_min, args.train_range_max),
        test_range=(args.test_range_min, args.test_range_max),
        image_size=(args.image_size_width, args.image_size_height),
    )
    if cmp_vocab:
        return SunrgbdCmpImageConfig(**kw)
    if anonymous:
        return SunrgbdAnonymousConfig(**kw)
    kw["num_semcls"] = num_semcls if num_semcls is not None else args.test_num_semcls
    return SunrgbdImageConfig(**kw)


def build_dataset(args):
    """Returns (datasets {train, test, real_test, real_cmp_test},
    dataset_config, real_test_config, real_cmp_config)."""
    name = args.dataset_name
    if name not in DATASET_NAMES:
        raise ValueError(f"unknown dataset {name}")
    if name.startswith("scannet"):
        raise NotImplementedError(
            f"--dataset_name {name}: the ScanNet family (its configs, dataset and "
            "projection) is not ported yet (ROADMAP Queue 1 item 4)"
        )

    if name == "synthetic" or args.dataset_root_dir is None:
        cmp_cfg = _sunrgbd_cfg(args, cmp_vocab=True)
        cfg = cmp_cfg if name == "sunrgbd_cmp_image" else _sunrgbd_cfg(args, anonymous=True)
        real_cfg = _sunrgbd_cfg(args, anonymous=False)

        def mk(config, **kw):
            return SyntheticDetectionDataset(
                config,
                num_points=getattr(args, "num_points", 20000),
                with_images=getattr(args, "if_input_image", False),
                empty_scene_rate=getattr(args, "synthetic_empty_scene_rate", 0.0),
                **kw,
            )

        n = getattr(args, "synthetic_num_scenes", 256) or 256
        n_eval = max(n // 4, 2)
        # stage-2 discovery in data-free mode writes and merges per-scan
        # pseudo-label files under the checkpoint dir (the train split only)
        pseudo_dir = None
        if (
            getattr(args, "online_nms_update_save_novel_label_clip_driven_with_cate_confidence", False)
            and getattr(args, "checkpoint_dir", None)
        ):
            pseudo_dir = os.path.join(
                args.checkpoint_dir,
                "synthetic_pseudo_labels_" + getattr(args, "pseudo_setting", "setting0"),
            )
            os.makedirs(pseudo_dir, exist_ok=True)
        datasets = {
            "train": mk(cfg, num_scenes=n, seed=args.seed, pseudo_dir=pseudo_dir),
            "test": mk(cfg, num_scenes=n_eval, seed=args.seed + 1),
            "real_test": mk(real_cfg, num_scenes=n_eval, seed=args.seed + 2),
            "real_cmp_test": mk(cmp_cfg, num_scenes=n_eval, seed=args.seed + 3),
        }
        return datasets, cfg, real_cfg, cmp_cfg

    cmp_cfg = _sunrgbd_cfg(args, anonymous=False, cmp_vocab=True)
    cmp_primary = name == "sunrgbd_cmp_image"
    anon_cfg = cmp_cfg if cmp_primary else _sunrgbd_cfg(args, anonymous=True)
    real_cfg = _sunrgbd_cfg(args, anonymous=False)
    use_pseudo = "with_novel_cate_confi" in name
    common = dict(
        root_dir=args.dataset_root_dir,
        calib_dir=args.calib_dir,
        image_dir=args.image_dir,
        num_points=getattr(args, "num_points", 20000),
        use_color=args.use_color,
        if_input_image=args.if_input_image,
        confidence_type_in_datalayer=args.confidence_type_in_datalayer,
        pseudo_setting=args.pseudo_setting,
    )
    datasets = {
        "train": SunrgbdDetectionDataset(
            anon_cfg, "train", augment=True, anonymous=not cmp_primary,
            use_pseudo_labels=use_pseudo,
            if_image_augment=args.if_image_augment,
            object_aug_dir=(
                getattr(args, "object_aug_dir", None) if name.endswith("object_aug") else None
            ),
            **common,
        ),
        "test": SunrgbdDetectionDataset(
            anon_cfg, "val", augment=False, anonymous=not cmp_primary, **common
        ),
        "real_test": SunrgbdDetectionDataset(
            real_cfg, "val", augment=False, anonymous=False, **common
        ),
        "real_cmp_test": SunrgbdDetectionDataset(
            cmp_cfg, "val", augment=False, anonymous=False, **common
        ),
    }
    return datasets, anon_cfg, real_cfg, cmp_cfg
