"""The port's ScanNet family against the JAX package on the CPU.

Fixture scans in ScanNet's on-disk layout (a `scannet_frames_train` dir and
its derived `scannet_frames_val`: `{scene}_{seq}_pc.npy`, `_bbox.npy` with
half extents and raw ScanNet-200 ids drawn from the scripts' lists, a
`.jpg`, and `{scene}/pose/{seq}.txt` and `{scene}/intrinsic/
intrinsic_color.txt`, 4 x 4), made in the test from a seed, go through both
packages:

  * the three configs: equal attributes, with and without the raw-id lists;
  * the 4 x 4 projection and the crop rects: uv within 1e-5 relative, depth
    within 1e-5, rects equal;
  * every split's samples and loader batches: bit for bit (train augmented
    with images and pseudo labels, the OV test split, the 60-class eval
    split, the comparison split; images by cv2 here);
  * build_dataset on every ScanNet name, on the fixture and data-free;
  * what ScanNet changes downstream: the one-bin angle, the ScanNet branch of
    the AP stack, the YZ/XZ un-flip in the CLIP crops and in discovery;
  * one ScanNet training step (one angle bin, so the axis-aligned gIoU in
    the matcher) at a tiny width: each loss within 1e-4 and gradients within
    1e-4 of their norm, the tolerances of the SUN RGB-D step in
    tests/test_torch_port_train.py (measured: 2.8e-5 on the total loss, whose
    terms sum in different orders on the two sides, and 8.9e-6 of the
    gradients' norm);
  * `main --test_only` on the fixture scans: outputs within 1e-4, metrics
    within 5e-3 (the tolerances of tests/test_torch_port_eval.py);
  * the basename-only `train` substitution and its error.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coda_neurips2023_tpu import criterion as jcriterion
from coda_neurips2023_tpu import engine as jengine
from coda_neurips2023_tpu import main as jmain
from coda_neurips2023_tpu import stages as jstages
from coda_neurips2023_tpu.datasets import build_dataset as jbuild_dataset
from coda_neurips2023_tpu.datasets import config as jconfig
from coda_neurips2023_tpu.datasets import loader as jloader
from coda_neurips2023_tpu.datasets.scannet import ScannetDetectionDataset as JaxScannet
from coda_neurips2023_tpu.engine import _TARGET_KEYS as JAX_TARGET_KEYS
from coda_neurips2023_tpu.models import box_processor as jbox
from coda_neurips2023_tpu.models import clip as jclip
from coda_neurips2023_tpu.models import discovery as jdisc
from coda_neurips2023_tpu.models import distillation as jdist
from coda_neurips2023_tpu.models import model_3detr as jmodel
from coda_neurips2023_tpu.ops import projection as jproj
from coda_neurips2023_tpu.utils import ap_calculator as jap
from coda_neurips2023_tpu.utils.torch_convert import export_reference_state_dict

from coda_neurips2023_tpu_torch import engine, stages
from coda_neurips2023_tpu_torch import main as tmain
from coda_neurips2023_tpu_torch.criterion import build_criterion
from coda_neurips2023_tpu_torch.datasets import DATASET_NAMES, build_dataset
from coda_neurips2023_tpu_torch.datasets import config as tconfig
from coda_neurips2023_tpu_torch.datasets import loader as tloader
from coda_neurips2023_tpu_torch.datasets.scannet import ScannetDetectionDataset
from coda_neurips2023_tpu_torch.engine import make_train_step
from coda_neurips2023_tpu_torch.models import discovery as tdisc
from coda_neurips2023_tpu_torch.models import distillation as tdist
from coda_neurips2023_tpu_torch.models.box_processor import BoxProcessor
from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
from coda_neurips2023_tpu_torch.ops import projection as tproj
from coda_neurips2023_tpu_torch.optimizer import build_optimizer
from coda_neurips2023_tpu_torch.utils import ap_calculator as tap
from coda_neurips2023_tpu_torch.utils.weights import grads_from_flax, state_dict_from_flax, to_torch

from test_torch_port_clip import SMALL_CLIP, TINY_CLIP, _jax_clip, _port_clip
from test_torch_port_eval import METRIC_TOL, OUTPUT_TOL, _assert_batches_equal, _assert_metrics_close
from test_torch_port_model import TINY, _assert_no_boundary_flip, _perturb
from test_torch_port_train import BASELINE_ARGS, GRAD_TOL, NO_DROPOUT, STEP_LOSS_TOL
from test_vocab import SCANNET_TEST_LIST, SCANNET_TRAIN_LIST
from torch_one_thread import one_intra_op_thread  # noqa: F401

PROJ_RTOL = 1e-5
NUM_POINTS = 1024
TRAIN_SCANS, VAL_SCANS = 5, 7
IMAGE_HW = (240, 320)
SCANNET_NAMES = [n for n in DATASET_NAMES if n.startswith("scannet")]


# ------------------------------------------------------------------ fixture


def _pose(rng):
    """A 4 x 4 camera-to-world pose: the camera 3 m behind the room's centre,
    1.5 m up, looking along +y, turned a little about z."""
    a = rng.uniform(-0.2, 0.2)
    rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    look = np.array([[1.0, 0, 0], [0, 0, 1], [0, -1, 0]])  # camera x, y (down), z -> world
    pose = np.eye(4)
    pose[:3, :3] = rz @ look
    pose[:3, 3] = [rng.uniform(-0.3, 0.3), -3.0, 1.5]
    return pose


def _intrinsics(h, w):
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 0.9 * w
    k[0, 2], k[1, 2] = w / 2 - 0.5, h / 2 - 0.5
    return k


def write_scannet_fixture(root, n_train, n_val, seed, num_points=1500, image_hw=IMAGE_HW,
                          room=(7.0, 7.0, 3.0), max_boxes=12):
    """Scans in ScanNet's on-disk layout under `root`; returns the train dir
    (the scripts' --dataset_root_dir).  Raw ids come from the scripts' lists:
    seen ids, novel test ids, and ids in neither (wall, floor)."""
    import cv2

    rng = np.random.default_rng(seed)
    novel = [c for c in SCANNET_TEST_LIST if c not in SCANNET_TRAIN_LIST]
    ids = SCANNET_TRAIN_LIST + novel[:60] + [1, 3]
    h, w = image_hw
    for split, n in (("train", n_train), ("val", n_val)):
        d = os.path.join(root, f"scannet_frames_{split}")
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            scene, seq = f"scene{seed * 100 + i:04d}_00", str(10 * i)
            pc = np.zeros((num_points, 6), np.float32)
            pc[:, 0] = rng.uniform(-room[0] / 2, room[0] / 2, num_points)
            pc[:, 1] = rng.uniform(-room[1] / 2, room[1] / 2, num_points)
            pc[:, 2] = rng.uniform(0, room[2], num_points)
            pc[:, 3:] = rng.uniform(0, 255, (num_points, 3))
            np.save(os.path.join(d, f"{scene}_{seq}_pc.npy"), pc)
            k = int(rng.integers(1, max_boxes + 1))
            boxes = np.zeros((k, 8))
            boxes[:, 0] = rng.uniform(-room[0] / 3, room[0] / 3, k)
            boxes[:, 1] = rng.uniform(-room[1] / 3, room[1] / 3, k)
            boxes[:, 2] = rng.uniform(0.3, room[2] - 0.5, k)
            boxes[:, 3:6] = rng.uniform(0.15, 0.8, (k, 3))  # half extents
            boxes[:, 7] = rng.choice(ids, k)
            np.save(os.path.join(d, f"{scene}_{seq}_bbox.npy"), boxes)
            for sub, name, mat in (("pose", f"{seq}.txt", _pose(rng)),
                                   ("intrinsic", "intrinsic_color.txt", _intrinsics(h, w))):
                os.makedirs(os.path.join(d, scene, sub), exist_ok=True)
                np.savetxt(os.path.join(d, scene, sub, name), mat, fmt="%.6f")
            img = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
            cv2.imwrite(os.path.join(d, f"{scene}_{seq}.jpg"), img)
    return os.path.join(root, "scannet_frames_train")


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("scannet")
    train_dir = write_scannet_fixture(str(root), TRAIN_SCANS, VAL_SCANS, seed=3)
    # stage 2's pseudo labels for two scenes (full extents, a bank row, the
    # class probability and objectness columns)
    pseudo = train_dir.replace("train", "noveltrain_pseudo_labels_setting0")
    os.makedirs(pseudo, exist_ok=True)
    rng = np.random.default_rng(9)
    for name in sorted(os.listdir(train_dir))[:2]:
        if name.endswith("_pc.npy"):
            rows = np.zeros((3, 10))
            rows[:, 0:3] = rng.uniform(-2, 2, (3, 3))
            rows[:, 3:6] = rng.uniform(0.3, 1.2, (3, 3))
            rows[:, 6] = rng.uniform(-0.5, 0.5, 3)
            rows[:, 7] = rng.integers(10, 40, 3)
            rows[:, 8:10] = rng.uniform(0.3, 1.0, (3, 2))
            np.save(os.path.join(pseudo, name.replace("_pc.npy", "_novel_bbox.npy")), rows)
    return train_dir


def _cli_args(extra=()):
    return tmain.make_args_parser().parse_args([
        "--train_range_list", *map(str, SCANNET_TRAIN_LIST),
        "--test_range_list", *map(str, SCANNET_TEST_LIST),
        "--test_range_max", "60", "--test_num_semcls", "60", *extra])


# ------------------------------------------------------------------ configs


def _vars(cfg):
    return {k: v for k, v in vars(cfg).items()}


@pytest.mark.parametrize("lists", [False, True], ids=["ranges", "raw_id_lists"])
@pytest.mark.parametrize("name", ["ScannetAnonymousConfig", "Scannet50ImageConfig",
                                  "ScannetCmpImageConfig"])
def test_configs_equal_jax(name, lists):
    kw = {}
    if lists and name != "ScannetCmpImageConfig":
        kw = dict(train_range_list=SCANNET_TRAIN_LIST, test_range_list=SCANNET_TEST_LIST)
    got, want = getattr(tconfig, name)(**kw), getattr(jconfig, name)(**kw)
    assert _vars(got) == _vars(want)
    assert got.num_angle_bin == 1
    if name == "Scannet50ImageConfig" and lists:
        assert got.num_semcls == 60 and len(got.vocab_names) == 60
        assert got.seen_vocab_idx == [got.class_id_to_idx[c] for c in SCANNET_TRAIN_LIST]
        assert not any(n.startswith("class_") for n in got.vocab_names)


def test_scannet_text_banks_take_the_seen_rows_as_jax():
    """The scripts' raw-id lists reach the 60-class eval config through the
    CLI, and its seen rows (the train ids' positions in the sorted
    vocabulary) head the superset bank, in both packages."""
    args = _cli_args(["--dataset_name", "scannet_anonymous_aligned_image_with_novel_cate_confi",
                      "--if_clip_superset", "--reset_scannet_num", "50"])
    jcfg, tcfg = jbuild_dataset(args)[2], build_dataset(args)[2]
    assert tcfg.seen_vocab_idx == [tcfg.class_id_to_idx[c] for c in SCANNET_TRAIN_LIST]
    assert tcfg.seen_vocab_idx != list(range(10))  # 1163 sorts last
    crop = SMALL_CLIP["image_resolution"]
    jctx = jstages.StageContext(args, jcfg, clip_model=jclip.CLIP(**SMALL_CLIP), crop_size=crop)
    params = jax.tree.map(np.asarray, jctx.clip_variables["params"])
    tctx = stages.StageContext(args, tcfg, clip_model=_port_clip(SMALL_CLIP, params),
                               crop_size=crop, device="cpu")
    assert set(tctx.text_banks) == set(jctx.text_banks)
    for key, want in jctx.text_banks.items():
        np.testing.assert_allclose(tctx.text_banks[key].numpy(), np.asarray(want), rtol=0,
                                   atol=OUTPUT_TOL, err_msg=key)
    bank = tctx.text_banks
    assert bank["test"].shape[0] == 60
    np.testing.assert_array_equal(bank["superset"][:10].numpy(),
                                  bank["test"][tcfg.seen_vocab_idx].numpy())


# ------------------------------------------------------------------ projection


def _scannet_corners(seed, b=2, q=6):
    rng = np.random.default_rng(seed)
    corners = np.zeros((b, q, 8, 3), np.float32)
    corners[..., 0] = rng.uniform(-2, 2, (b, q, 8))
    corners[..., 1] = rng.uniform(-1, 2, (b, q, 8))
    corners[..., 2] = rng.uniform(0.2, 2.5, (b, q, 8))
    corners[1, 0, :, 1] = -3.5  # behind the camera
    h, w = 968, 1296
    batch = {
        "scale_array": rng.uniform(0.9, 1.1, (b, 3)).astype(np.float32),
        "rot_array": np.stack([np.eye(3)] * b).astype(np.float32),
        "flip_array": np.array([1, -1], np.float32),
        "zx_flip_array": np.array([-1, 1], np.float32),
        "K": np.stack([_intrinsics(h, w)] * b).astype(np.float32),
        "Rtilt": np.stack([_pose(rng) for _ in range(b)]).astype(np.float32),
        "ori_width": np.array([w, 1200], np.float32),
        "ori_height": np.array([h, 900], np.float32),
        "x_offset": np.array([0, 34], np.float32),
        "y_offset": np.array([0, 48], np.float32),
        "image_flip_array": np.array([1, 0], np.float32),
        "flip_length": np.array([w, w], np.float32),
    }
    return corners, batch


def test_projection_and_rects_on_4x4_calibration_match_jax():
    corners, batch = _scannet_corners(5)
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    b, q = corners.shape[:2]
    pts = corners.reshape(b, q * 8, 3)
    uv, depth = tproj.project_world_to_image_scannet(torch.from_numpy(pts), t["K"], t["Rtilt"])
    want_uv, want_depth = jproj.project_world_to_image_scannet(jnp.asarray(pts), j["K"], j["Rtilt"])
    np.testing.assert_allclose(uv.numpy(), np.asarray(want_uv), rtol=PROJ_RTOL, atol=0)
    np.testing.assert_allclose(depth.numpy(), np.asarray(want_depth), rtol=0, atol=1e-5)
    # no projected coordinate the clip keeps lies near an integer (the rects
    # truncate): the case tests the projection, not rounding
    u64 = np.asarray(want_uv, np.float64).reshape(b, q, 8, 2)
    for c, bound in ((u64[..., 0], batch["ori_width"]), (u64[..., 1], batch["ori_height"])):
        inside = (c > 0) & (c < bound[:, None, None] - 1)
        assert np.abs(c - np.round(c))[inside].min() > 1e-3
    geo = ("K", "Rtilt", "ori_width", "ori_height", "x_offset", "y_offset", "image_flip_array",
           "flip_length")
    got_r, got_d = tproj.corners_to_image_rects(torch.from_numpy(corners), *(t[a] for a in geo))
    want_r, want_d = jproj.corners_to_image_rects(jnp.asarray(corners), *(j[a] for a in geo))
    assert got_r.dtype == torch.int32
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0, atol=1e-5)
    assert (got_d.numpy() < 0).any() and (got_d.numpy() > 0).any()


# ------------------------------------------------------------------ data


SPLIT_CASES = {
    # (dataset name, split, if_input_image, if_image_augment)
    "train_images_pseudo": ("scannet_anonymous_aligned_image_with_novel_cate_confi", "train",
                            True, True),
    "train_points_only": ("scannet_anonymous_aligned_image", "train", False, False),
    "test": ("scannet_anonymous_aligned_image", "test", True, False),
    "real_test": ("scannet_anonymous_aligned_image", "real_test", False, False),
    "real_cmp_test": ("scannet_cmp_image", "real_cmp_test", True, False),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_samples_and_batches_equal_jax(fixture_root, case):
    """Both packages' build_dataset on the fixture with the scripts' flags,
    through both loaders under the same seed: equal batches bit for bit,
    the padded tail and its pad_mask included."""
    name, split, images, image_aug = SPLIT_CASES[case]
    extra = ["--dataset_name", name, "--dataset_root_dir", fixture_root,
             "--num_points", str(NUM_POINTS), "--image_size_width", "1296",
             "--image_size_height", "968"]
    if images:
        extra.append("--if_input_image")
    if image_aug:
        extra += ["--if_image_augment", "True"]
    args = _cli_args(extra)
    jds = jbuild_dataset(args)[0][split]
    tds = build_dataset(args)[0][split]
    assert tds.data_names == jds.data_names and len(tds) == (
        TRAIN_SCANS if split == "train" else VAL_SCANS)
    assert tds.data_path == jds.data_path and tds.pseudo_data_path == jds.pseudo_data_path
    if "pseudo" in case:
        assert tds.pseudo_data_path.endswith("scannet_frames_noveltrain_pseudo_labels_setting0")
    loader_kw = dict(shuffle=split == "train", seed=4, drop_last=False, pad_last=True)
    want = list(jloader.make_loader(jds, 3, num_workers=1, **loader_kw))
    got = list(tloader.make_loader(tds, 3, num_workers=2, **loader_kw))
    assert len(got) == len(want) == -(-len(tds) // 3)
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    present = np.concatenate([w["gt_box_present"] for w in want])
    assert present.sum() > 0
    if images:
        assert want[0]["K"].shape == (3, 4, 4) and want[0]["input_image"].shape == (3, 968, 1296, 3)
    if "pseudo" in case:  # the merged rows: is_real 0, angle negated on load
        assert max(w["gt_ori_box_num"].max() for w in want) > 0


@pytest.mark.parametrize("data", ["fixture", "data_free"])
@pytest.mark.parametrize("name", SCANNET_NAMES)
def test_build_dataset_on_every_scannet_name(fixture_root, name, data):
    extra = ["--dataset_name", name, "--num_points", "256", "--synthetic_num_scenes", "8"]
    if data == "fixture":
        extra += ["--dataset_root_dir", fixture_root]
    args = _cli_args(extra)
    got, want = build_dataset(args), jbuild_dataset(args)
    for g_cfg, w_cfg in zip(got[1:], want[1:]):
        assert type(g_cfg).__name__ == type(w_cfg).__name__
        assert _vars(g_cfg) == _vars(w_cfg)
        assert g_cfg.num_angle_bin == 1
    for split in ("train", "test", "real_test", "real_cmp_test"):
        g, w = got[0][split], want[0][split]
        assert type(g).__name__ == type(w).__name__ and len(g) == len(w) > 0, split
        g.rng, w.rng = np.random.default_rng(5), np.random.default_rng(5)
        _assert_batches_equal(tloader.collate([g[0]]), jloader.collate([w[0]]))


def test_basename_train_substitution_and_its_error(tmp_path):
    cfg = tconfig.ScannetAnonymousConfig()
    parent = tmp_path / "training_data"
    ds = ScannetDetectionDataset(cfg, "val", root_dir=str(parent / "scannet_train"))
    assert ds.data_path == str(parent / "scannet_val")  # the parent keeps its name
    assert ds.data_path == JaxScannet(jconfig.ScannetAnonymousConfig(), "val",
                                      root_dir=str(parent / "scannet_train")).data_path
    with pytest.raises(ValueError, match="contains no 'train'"):
        ScannetDetectionDataset(cfg, "val", root_dir=str(tmp_path / "scannet_frames"))
    train = ScannetDetectionDataset(cfg, "train", root_dir=str(tmp_path / "scannet_frames"))
    assert train.data_path == str(tmp_path / "scannet_frames")


def test_load_image_needs_cv2(fixture_root, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *a, **kw)

    ds = ScannetDetectionDataset(tconfig.ScannetAnonymousConfig(), "train",
                                 root_dir=fixture_root, num_points=256, if_input_image=True)
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="needs OpenCV"):
        ds[0]


# ------------------------------------------------------------------ downstream


def test_one_angle_bin_predicts_angle_zero_as_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 3, 5, 1)).astype(np.float32)
    resid = rng.standard_normal((2, 3, 5, 1)).astype(np.float32)
    got = BoxProcessor(tconfig.ScannetAnonymousConfig()).compute_predicted_angle(
        torch.from_numpy(logits), torch.from_numpy(resid))
    want = jbox.BoxProcessor(jconfig.ScannetAnonymousConfig()).compute_predicted_angle(
        jnp.asarray(logits), jnp.asarray(resid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 0).all()


def test_ap_stack_scannet_branch_equals_jax(monkeypatch):
    """compute_metrics on a 60-class ScanNet eval config: the ScanNet
    branch's seen/novel buckets of the two packages, equal."""
    from test_torch_port_eval import _assert_metrics_equal, _predictions

    monkeypatch.setenv("CODA_AP_WORKERS", "0")
    kw = dict(train_range_list=SCANNET_TRAIN_LIST, test_range_list=SCANNET_TEST_LIST)
    jcfg, tcfg = jconfig.Scannet50ImageConfig(**kw), tconfig.Scannet50ImageConfig(**kw)
    outputs, targets = _predictions(5, 24, 60, seed=6)
    calcs = []
    for mod, cfg in ((jap, jcfg), (tap, tcfg)):
        calc = mod.APCalculator(cfg, ap_iou_thresh=[0.25, 0.5],
                                ap_config_dict=mod.get_ap_config_dict(dataset_config=cfg),
                                dataset_name="scannet_anonymous_aligned_image")
        calc.step_meter({"outputs": outputs}, targets)
        calcs.append(calc)
    want, got = calcs[0].compute_metrics(), calcs[1].compute_metrics()
    _assert_metrics_equal(got, want)
    assert any("seen" in k or "novel" in k for k in got[0.25]), sorted(got[0.25])
    assert calcs[1].metrics_to_str(got) == calcs[0].metrics_to_str(want)


def _scannet_batch_and_outputs(fixture_root, seed=1, nq=16):
    """A train batch of 2 augmented scenes with images (some with the XZ
    flip), and last-layer outputs of nq boxes in front of the camera."""
    args = _cli_args(["--dataset_name", "scannet_anonymous_aligned_image", "--dataset_root_dir",
                      fixture_root, "--num_points", "512", "--if_input_image",
                      "--image_size_width", "1296", "--image_size_height", "968"])
    ds = build_dataset(args)[0]["train"]
    ds.rng = np.random.default_rng(seed)
    samples = []
    while len(samples) < 2:  # one scene with each XZ flip
        s = ds[len(samples)]
        if s["zx_flip_array"] == (-1.0 if not samples else 1.0):
            samples.append(s)
    batch = {k: v for k, v in tloader.collate(samples).items() if not isinstance(v, list)}
    rng = np.random.default_rng(seed + 10)
    b = 2
    centers = np.stack([rng.uniform(-1.5, 1.5, (b, nq)), rng.uniform(-1.0, 2.0, (b, nq)),
                        rng.uniform(0.5, 2.0, (b, nq))], -1).astype(np.float32)
    sizes = rng.uniform(0.3, 1.2, (b, nq, 3)).astype(np.float32)
    angles = np.zeros((b, nq), np.float32)
    from coda_neurips2023_tpu_torch.ops import box_ops

    cam = box_ops.flip_axis_to_camera_np(centers)
    outputs = {
        "box_corners": box_ops.get_3d_box_batch_np(sizes, angles, cam).astype(np.float32),
        "box_corners_xyz": box_ops.get_3d_box_batch_xyz_np(sizes, angles, centers).astype(
            np.float32),
        "center_unnormalized": centers,
        "size_unnormalized": sizes,
        "angle_continuous": angles,
        "objectness_prob": rng.uniform(0.0, 1.0, (b, nq)).astype(np.float32),
    }
    return batch, outputs


def test_clip_crops_unflip_xz_on_4x4_calibration_as_jax(fixture_root):
    """The CLIP crop scores of predicted boxes on ScanNet scenes (one with
    the XZ flip): the rects undo zx_flip_array and project through the pose,
    as the JAX package's; scores within 1e-4 (tests/test_torch_port_clip.py)."""
    batch, outputs = _scannet_batch_and_outputs(fixture_root)
    jm, params = _jax_clip(TINY_CLIP)
    tm = _port_clip(TINY_CLIP, params)
    rng = np.random.default_rng(2)
    text = rng.standard_normal((20, 512)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)

    def jfn(images):
        return jm.apply({"params": params}, images, method=jm.encode_image)

    want = jdist.clip_crop_scores(outputs, {k: jnp.asarray(v) for k, v in batch.items()}, jfn,
                                  jnp.asarray(text), 100.0, crop_size=16)
    t_out = {k: torch.from_numpy(v) for k, v in outputs.items()}
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = tdist.clip_crop_scores(t_out, t_batch, tm.encode_image, torch.from_numpy(text),
                                     100.0, crop_size=16)
        rects, valid = tdist.crop_rects(t_out, t_batch)
        no_flip, _ = tdist.crop_rects(t_out, {k: v for k, v in t_batch.items()
                                              if k != "zx_flip_array"})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=OUTPUT_TOL)
    assert valid.any() and (np.asarray(want).sum(-1) > 0).any()
    assert not torch.equal(rects[0], no_flip[0]) and torch.equal(rects[1], no_flip[1])


def test_discovery_unflips_xz_as_jax(fixture_root):
    batch, outputs = _scannet_batch_and_outputs(fixture_root, seed=2)
    jm, params = _jax_clip(TINY_CLIP)
    tm = _port_clip(TINY_CLIP, params)
    text = np.random.default_rng(3).standard_normal((40, 512)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    kw = dict(train_range_max=10, save_objectness=0.0, clip_driven_keep_thres=0.0, crop_size=16)

    def jfn(images):
        return jm.apply({"params": params}, images, method=jm.encode_image)

    want = jax.tree.map(np.asarray, jdisc.discover_novel_boxes(
        outputs, {k: jnp.asarray(v) for k, v in batch.items()}, jfn, jnp.asarray(text), 100.0,
        **kw))
    with torch.no_grad():
        got = tdisc.discover_novel_boxes({k: torch.from_numpy(v) for k, v in outputs.items()},
                                         {k: torch.from_numpy(v) for k, v in batch.items()},
                                         tm.encode_image, torch.from_numpy(text), 100.0, **kw)
    np.testing.assert_array_equal(got["novel_mask"].numpy(), want["novel_mask"])
    np.testing.assert_allclose(got["save_box_info"].numpy(), want["save_box_info"], rtol=0,
                               atol=1e-5)
    rows = want["save_box_info"][want["novel_mask"]]
    assert rows.shape[0] > 0
    # the rows are in the un-augmented frame: the XZ-flipped scene's y is negated back
    assert want["novel_mask"][0].any()


# ------------------------------------------------------------------ training step


# scripts/coda_scannet_stage1.sh's matcher (gIoU 2, class 1) and losses, the
# detector alone (its distillation loss needs CLIP: the chip run holds it)
SCANNET_ARGS = dict(BASELINE_ARGS, matcher_giou_cost=2, matcher_cls_cost=1,
                    matcher_center_cost=0, matcher_objectness_cost=0, loss_no_object_weight=0.25,
                    base_lr=1.4142e-4)


@pytest.fixture(scope="module")
def scannet_step(fixture_root):
    args = _cli_args(["--dataset_name", "scannet_anonymous_aligned_image", "--dataset_root_dir",
                      fixture_root, "--num_points", str(NUM_POINTS)])
    ds = build_dataset(args)[0]["train"]
    ds.rng = np.random.default_rng(0)
    batch = tloader.collate([ds[0], ds[1]])
    batch = {k: v for k, v in batch.items() if not isinstance(v, list)}
    jcfg, tcfg = jconfig.ScannetAnonymousConfig(), tconfig.ScannetAnonymousConfig()
    jm = jmodel.CoDA3DETR(dataset_config=jcfg, with_text_head=False, **NO_DROPOUT, **TINY)
    fwd = ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")
    variables = jax.jit(lambda r, b: jm.init(r, b, train=False))(
        jax.random.PRNGKey(0), {k: batch[k] for k in fwd})
    variables = _perturb(variables, 0)
    sargs = types.SimpleNamespace(**SCANNET_ARGS)
    crit = jcriterion.build_criterion(sargs, jcfg)
    jbatch = {k: jnp.asarray(batch[k]) for k in (*fwd, *JAX_TARGET_KEYS) if k in batch}

    def loss_fn(params):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"],
                           "constants": variables["constants"]}, jbatch, train=True,
                          rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        return crit(out, {k: jbatch[k] for k in JAX_TARGET_KEYS if k in jbatch})

    (loss, loss_dict), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"],
                              variables["constants"])
    tm = CoDA3DETR(tcfg, with_text_head=False, **NO_DROPOUT, **TINY)
    tm.load_state_dict(to_torch(sd), strict=True)
    opt, sched = build_optimizer(sargs, tm, 600)
    criterion = build_criterion(sargs, tcfg)
    step = make_train_step(tm, criterion, opt, sched)
    _assert_no_boundary_flip(batch, TINY["preenc_npoints"])
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()},
                   torch.Generator().manual_seed(0))
    return dict(want=jax.tree.map(np.asarray, dict(loss=loss, loss_dict=loss_dict, grads=grads)),
                metrics=metrics, grads={n: p.grad.clone() for n, p in tm.named_parameters()},
                criterion=criterion, batch=batch)


def test_scannet_train_step_loss_matches_jax(scannet_step):
    got, want = scannet_step["metrics"], scannet_step["want"]
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=0, atol=STEP_LOSS_TOL)
    for key, w in want["loss_dict"].items():
        np.testing.assert_allclose(float(got[key]), w, rtol=0, atol=STEP_LOSS_TOL, err_msg=key)
    # one angle bin: the angle classification loss is over one class
    assert float(got["loss_angle_cls"]) == 0.0
    assert scannet_step["criterion"].dataset_config.num_angle_bin == 1


def test_scannet_train_step_gradients_match_jax(scannet_step):
    want = grads_from_flax(scannet_step["want"]["grads"])
    got = scannet_step["grads"]
    assert set(got) == set(want)
    norm = np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2) for g in want.values()))
    for name, w in want.items():
        err = np.abs(got[name].numpy() - np.asarray(w)).max() / norm
        assert err <= GRAD_TOL, (name, err)


# ------------------------------------------------------------------ the CLI


def test_cli_test_only_on_scannet_fixture_matches_jax(fixture_root, tmp_path, monkeypatch):
    """`main --test_only --test_ckpt x.pth` of both packages with the release
    script's scannet_stage1 row (and the scripts' raw-id lists) on the
    fixture scans, at the tiny widths: the eval outputs of every batch
    within OUTPUT_TOL, the metrics within METRIC_TOL."""
    monkeypatch.setenv("CODA_AP_WORKERS", "0")
    jcfg = jconfig.ScannetAnonymousConfig()
    jm = jmodel.CoDA3DETR(dataset_config=jcfg, **TINY)
    args = _cli_args(["--dataset_name", "scannet_anonymous_aligned_image", "--dataset_root_dir",
                      fixture_root, "--num_points", str(NUM_POINTS)])
    ds = build_dataset(args)[0]["real_test"]
    batch = tloader.collate([ds[i] for i in range(2)])
    fwd = ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")
    variables = jax.jit(lambda r, b: jm.init(r, b, train=False))(
        jax.random.PRNGKey(1), {k: batch[k] for k in fwd})
    variables = _perturb(variables, 1)
    sd = export_reference_state_dict(variables["params"], variables["batch_stats"],
                                     variables["constants"])
    ckpt = tmp_path / "tiny.pth"
    torch.save({"model": {k: torch.from_numpy(np.asarray(v).copy()) for k, v in sd.items()},
                "epoch": 0}, ckpt)

    contexts, outs = {}, {"jax": [], "port": []}
    jstages_cls, stages_cls = jstages.StageContext, stages.StageContext

    def jax_ctx(args, cfg):
        contexts["jax"] = jstages_cls(args, cfg, clip_model=jclip.CLIP(**TINY_CLIP), crop_size=16)
        return contexts["jax"]

    def port_ctx(args, cfg, device="cuda"):
        params = jax.tree.map(np.asarray, contexts["jax"].clip_variables["params"])
        return stages_cls(args, cfg, clip_model=_port_clip(TINY_CLIP, params), crop_size=16,
                          device=device)

    monkeypatch.setattr(jstages, "StageContext", jax_ctx)
    monkeypatch.setattr(stages, "StageContext", port_ctx)
    jmake, tmake = jengine.make_eval_step, engine.make_eval_step

    def jax_make(*a, **kw):
        step = jmake(*a, **kw)

        def recorded(state, b):
            outs.setdefault("jax_in", []).append(np.asarray(b["point_clouds"]))
            out = step(state, b)
            outs["jax"].append(jax.tree.map(np.asarray, out))
            return out

        return recorded

    def port_make(*a, **kw):
        step = tmake(*a, **kw)

        def recorded(b):
            outs.setdefault("port_in", []).append(b["point_clouds"].numpy().copy())
            out = step(b)
            outs["port"].append({k: v.numpy().copy() for k, v in out.items()})
            return out

        return recorded

    monkeypatch.setattr(jengine, "make_eval_step", jax_make)
    monkeypatch.setattr(engine, "make_eval_step", port_make)

    def argv(log):
        return ["--test_only", "--dataset_name", "scannet_anonymous_aligned_image",
                "--model_name", "3detr_predictedbox_distillation",
                "--dataset_root_dir", fixture_root, "--test_ckpt", str(ckpt),
                "--test_num_semcls", "60", "--test_range_max", "60", "--num_semcls", "2",
                "--batchsize_per_gpu_test", "4", "--if_use_v1", "--num_points", str(NUM_POINTS),
                "--train_range_list", *map(str, SCANNET_TRAIN_LIST),
                "--test_range_list", *map(str, SCANNET_TEST_LIST),
                "--log_file", str(tmp_path / log),
                *[x for k, v in TINY.items() for x in (f"--{k}", str(v))]]

    want = jmain.main(argv("jax.lst"))
    got = tmain.main(argv("port.lst"), device="cpu")
    assert len(outs["port"]) == len(outs["jax"]) == 2
    for g, w in zip(outs["port_in"], outs["jax_in"]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(outs["port"], outs["jax"]):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=OUTPUT_TOL, err_msg=k)
    assert engine.EVAL_STATS["scans"] == VAL_SCANS
    _assert_metrics_close(got, want, METRIC_TOL)
    assert (tmp_path / "port.lst").read_text().startswith("mAP0.25")
