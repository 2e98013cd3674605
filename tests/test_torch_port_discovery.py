"""The PyTorch port's stage-2 discovery and stage-2 loss against the JAX package on the CPU.

The same numpy inputs (seed 0 unless a case says otherwise) go through the
JAX package's models/discovery.py and criterion and the port's:

  * `nms_2d_greedy_mask`: exactly equal keep masks, on scenes with tied
    scores (the first index wins on both sides), identical boxes and invalid
    (-1) scores; the port runs a batch of scenes at once, the JAX function
    one scene;
  * `aabb_iou_3d`: within 1e-6 (products and a division of O(1) values);
  * `discover_novel_boxes` with the tiny CLIP of tests/test_torch_port_clip.py
    (16-pixel crops) on synthetic scenes with 64 x 96 images and random
    boxes in front of the camera: the novel mask exactly (the inputs are
    checked to lie away from the two places where float rounding may flip
    it: no rect coordinate within RECT_MARGIN px of an integer, and no
    crop's top-two CLIP probabilities or top probability and the keep
    threshold within CLIP_MARGIN), the saved rows within ROW_TOL;
  * `write_pseudo_labels`: equal files over two accumulation rounds, the cap
    of 64 boxes a scene included;
  * the stage-2 loss `loss_feat_seen_softmax_weakly_loss_with_novel_cate_confi`
    for both --confidence_type values, every decoder layer, within LOSS_TOL.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coda_neurips2023_tpu import criterion as jcriterion
from coda_neurips2023_tpu.datasets.config import SunrgbdAnonymousConfig as JaxConfig
from coda_neurips2023_tpu.datasets.synthetic import SyntheticDetectionDataset as JaxScenes
from coda_neurips2023_tpu.models import discovery as jdisc

from coda_neurips2023_tpu_torch.criterion import build_criterion
from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
from coda_neurips2023_tpu_torch.datasets.loader import collate
from coda_neurips2023_tpu_torch.models import discovery as tdisc
from coda_neurips2023_tpu_torch.ops import box_ops
from coda_neurips2023_tpu_torch.ops.projection import (
    project_upright_depth_to_image,
    unaugment_corners,
)

from test_torch_port_clip import TINY_CLIP, _jax_clip, _port_clip
from test_torch_port_train import BASELINE_ARGS, _outputs_near_targets, _scenes
from torch_one_thread import one_intra_op_thread  # noqa: F401

IOU_TOL = 1e-6
ROW_TOL = 1e-5
LOSS_TOL = 1e-5
RECT_MARGIN = 1e-3  # px: the two sides' projections differ by ~1e-5 px
CLIP_MARGIN = 1e-4
CROP = 16
NQ = 16
N_CLASSES = 40  # a bank of random unit vectors; rows >= 10 are not seen


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------- NMS, IoU


def _nms_case(seed, b=4, n=24):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 50, (b, n, 2))
    wh = rng.uniform(5, 25, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    boxes[:, 5] = boxes[:, 3]  # identical boxes
    scores = np.round(rng.uniform(0, 1, (b, n)), 1).astype(np.float32)  # many ties
    scores[:, 7:10] = -1.0  # invalid boxes
    scores[1] = 0.5  # a scene of equal scores
    boxes[2, :, 2:] = boxes[2, :, :2] + 3.0  # equal areas
    return boxes, scores


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_matches_jax_exactly_with_ties(seed):
    boxes, scores = _nms_case(seed)
    got = _np(tdisc.nms_2d_greedy_mask(torch.from_numpy(boxes), torch.from_numpy(scores), 0.25))
    jnms = jax.jit(jax.vmap(lambda bx, sc: jdisc.nms_2d_greedy_mask(bx, sc, 0.25)))
    want = np.asarray(jnms(jnp.asarray(boxes), jnp.asarray(scores)))
    np.testing.assert_array_equal(got, want)
    assert got[1].sum() >= 1 and not got[:, 7:10].all()
    # ties go to the first index: in the scene of equal scores box 0 is kept
    assert got[1, 0]


def test_aabb_iou_matches_jax():
    rng = np.random.default_rng(3)
    lo = rng.uniform(-2, 2, (3, 10, 3))
    a = np.concatenate([lo, lo + rng.uniform(0.2, 2, (3, 10, 3))], -1).astype(np.float32)
    lo = rng.uniform(-2, 2, (3, 7, 3))
    b = np.concatenate([lo, lo + rng.uniform(0.2, 2, (3, 7, 3))], -1).astype(np.float32)
    b[:, 0] = a[:, 0]  # identical boxes: IoU 1
    got = _np(tdisc.aabb_iou_3d(torch.from_numpy(a), torch.from_numpy(b)))
    want = np.stack([np.asarray(jdisc.aabb_iou_3d(jnp.asarray(x), jnp.asarray(y)))
                     for x, y in zip(a, b)])
    np.testing.assert_allclose(got, want, rtol=0, atol=IOU_TOL)
    np.testing.assert_allclose(got[:, 0, 0], 1.0, atol=IOU_TOL)
    assert (got > 0).any() and (got == 0).any()


# ---------------------------------------------------------------- discovery


def _discovery_inputs(seed=0, b=2):
    """A host batch of b synthetic scenes with images, and last-layer outputs
    of NQ random boxes in front of the camera: some on a ground-truth box,
    one of zero size."""
    ds = JaxScenes(JaxConfig(), num_scenes=b, num_points=512, seed=seed, with_images=True)
    batch = collate([ds[i] for i in range(b)])
    batch = {k: v for k, v in batch.items() if not isinstance(v, list)}
    rng = np.random.default_rng(seed + 10)
    centers = np.stack([rng.uniform(-1.5, 1.5, (b, NQ)), rng.uniform(2.0, 6.0, (b, NQ)),
                        rng.uniform(0.2, 2.0, (b, NQ))], -1).astype(np.float32)
    sizes = rng.uniform(0.3, 1.5, (b, NQ, 3)).astype(np.float32)
    angles = rng.uniform(-np.pi, np.pi, (b, NQ)).astype(np.float32)
    for i in range(b):  # two boxes on ground truth in front of the camera
        ahead = np.nonzero((batch["gt_box_present"][i] > 0)
                           & (batch["gt_box_centers"][i][:, 1] > 1.0))[0][:2]
        for j, g in enumerate(ahead):
            centers[i, j] = batch["gt_box_centers"][i][g]
            sizes[i, j] = batch["gt_box_sizes"][i][g]
            angles[i, j] = batch["gt_box_angles"][i][g]
    sizes[0, 5] = 0.0
    cam = box_ops.flip_axis_to_camera_np(centers)
    outputs = {
        "box_corners": box_ops.get_3d_box_batch_np(sizes, angles, cam).astype(np.float32),
        "box_corners_xyz": box_ops.get_3d_box_batch_xyz_np(sizes, angles, centers).astype(np.float32),
        "center_unnormalized": centers,
        "size_unnormalized": sizes,
        "angle_continuous": angles,
        "objectness_prob": rng.uniform(0.0, 1.0, (b, NQ)).astype(np.float32),
    }
    text = rng.standard_normal((N_CLASSES, 512)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    return batch, outputs, text


def _assert_rects_away_from_integers(batch, outputs):
    t = {k: torch.from_numpy(v) for k, v in {**batch, **outputs}.items()}
    un = unaugment_corners(t["box_corners_xyz"], t["scale_array"], t["rot_array"],
                           t["flip_array"])
    b, q = un.shape[:2]
    uv, _ = project_upright_depth_to_image(un.reshape(b, q * 8, 3).double(), t["K"].double(),
                                           t["Rtilt"].double())
    hi = torch.stack([t["ori_width"], t["ori_height"]], -1).double()[:, None, None, :] - 1
    uv = torch.minimum(uv.reshape(b, q, 8, 2).clamp(min=0), hi)
    ext = torch.cat([uv.amin(2), uv.amax(2)], -1)
    inside = (ext > 0) & (ext < hi[:, :, 0, [0, 1, 0, 1]])
    near = ((ext - ext.round()).abs() < RECT_MARGIN) & inside
    assert not near.any(), "a rect coordinate lies at an integer: the case tests rounding"


def test_discover_novel_boxes_matches_jax():
    batch, outputs, text = _discovery_inputs()
    _assert_rects_away_from_integers(batch, outputs)
    jm, params = _jax_clip(TINY_CLIP)
    tm = _port_clip(TINY_CLIP, params)
    kw = dict(train_range_max=10, save_objectness=0.3, clip_driven_keep_thres=0.3,
              crop_size=CROP)

    def jclip(images):
        return jm.apply({"params": params}, images, method=jm.encode_image)

    want = jax.jit(lambda o, bt, tx: jdisc.discover_novel_boxes(o, bt, jclip, tx, 100.0, **kw))(
        outputs, batch, text)
    want = jax.tree.map(np.asarray, want)
    probs = []

    def tclip(images):  # the tower, keeping the crops' class probabilities
        emb = tm.encode_image(images)
        unit = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        probs.append(torch.softmax(100.0 * unit @ torch.from_numpy(text).t(), -1))
        return emb

    got = tdisc.discover_novel_boxes({k: torch.from_numpy(v) for k, v in outputs.items()},
                                     {k: torch.from_numpy(v) for k, v in batch.items()},
                                     tclip, torch.from_numpy(text), 100.0, **kw)
    top2 = torch.topk(probs[0], 2, dim=-1).values
    assert ((top2[:, 0] - top2[:, 1]) > CLIP_MARGIN).all(), "two classes tie: rounding decides"
    assert ((top2[:, 0] - 0.3).abs() > CLIP_MARGIN).all(), "a crop sits on the keep threshold"
    np.testing.assert_array_equal(_np(got["novel_mask"]), want["novel_mask"])
    np.testing.assert_allclose(_np(got["save_box_info"]), want["save_box_info"], rtol=0,
                               atol=ROW_TOL)
    gates = dict(zip(tdisc.GATES, _np(got["gates"]).tolist()))
    # the case exercises every gate: each one drops boxes and some survive all
    assert gates["valid"] < 2 * NQ and gates["not_seen_gt"] < gates["nms"]
    assert gates["objectness"] < gates["not_seen_gt"]
    assert 0 < gates["clip"] < gates["objectness"]
    assert gates["clip"] == want["novel_mask"].sum()


def test_write_pseudo_labels_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    b, nq = 3, 40
    dirs = {side: tmp_path / side for side in ("jax", "port")}
    for d in dirs.values():
        d.mkdir()
    gt_ori = np.array([62, 0, 5])  # the first scene may add 2 boxes a round
    for rnd, accumulate in enumerate((True, True, False)):
        info = rng.standard_normal((b, nq, 10)).astype(np.float32)
        mask = rng.uniform(size=(b, nq)) < 0.3
        for side, fn in (("jax", jdisc.write_pseudo_labels), ("port", tdisc.write_pseudo_labels)):
            paths = [str(dirs[side] / f"{i:06d}_novel_bbox.npy") for i in range(2)] + ["_"]
            fn(info, mask, paths, gt_ori, accumulate=accumulate)
        for i in range(2):
            name = f"{i:06d}_novel_bbox.npy"
            got, want = np.load(dirs["port"] / name), np.load(dirs["jax"] / name)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f"round {rnd} scene {i}")
    assert np.load(dirs["port"] / "000000_novel_bbox.npy").shape[0] == 2  # capped, rewritten
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"]))


def test_write_pseudo_labels_counts_rows(tmp_path):
    info = np.arange(2 * 4 * 10, dtype=np.float32).reshape(2, 4, 10)
    mask = np.array([[True, False, True, True], [True, True, False, False]])
    path = str(tmp_path / "a_novel_bbox.npy")
    assert tdisc.write_pseudo_labels(info, mask, [path, "_"], np.array([62, 0])) == 2
    assert tdisc.write_pseudo_labels(info, mask, [path, "_"], np.array([62, 0])) == 2
    np.testing.assert_array_equal(np.load(path), np.concatenate([info[0][[0, 2]]] * 2))


# ---------------------------------------------------------------- the stage-2 loss


@pytest.mark.parametrize("confidence_type", ["non-confidence", "clip-max-prob"])
def test_stage2_loss_matches_jax(confidence_type):
    batch = _scenes(3, seed=4)
    outs = _outputs_near_targets(batch, num_layers=3, nq=16, seed=5)
    rng = np.random.default_rng(6)
    outs["text_correlation_embedding"] = rng.standard_normal((3, 3, 16, 512)).astype(np.float32)
    text = rng.standard_normal((N_CLASSES, 512)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    weak_w = rng.uniform(0.2, 1.0, (3, 16)).astype(np.float32)
    weak_w[rng.uniform(size=(3, 16)) < 0.4] = 0.0  # crops that were not valid
    targets = {k: batch[k] for k in ("gt_box_corners", "gt_box_centers_normalized",
                                     "gt_box_sizes_normalized", "gt_box_angles",
                                     "gt_angle_class_label", "gt_angle_residual_label",
                                     "gt_box_sem_cls_label", "gt_box_present")}
    targets.update(
        gt_box_seen_sem_cls_label=rng.integers(0, 10, batch["gt_box_present"].shape),
        gt_box_seen_sem_cls_confi=(batch["gt_box_present"]
                                   * rng.uniform(0.3, 1.0, batch["gt_box_present"].shape)
                                   ).astype(np.float32),
        weak_box_cate_label=rng.integers(0, N_CLASSES, (3, 16)),
        weak_confidence_weight=weak_w,
        text_features_clip=text, logit_scale=np.float32(100.0),
    )
    args = types.SimpleNamespace(**dict(
        BASELINE_ARGS, loss_feat_seen_softmax_weakly_loss_with_novel_cate_confi_weight=1.0,
        confidence_type=confidence_type))
    jcrit = jcriterion.build_criterion(args, JaxConfig())
    want_total, want = jax.jit(lambda o, t: jcrit(o, t))(outs, targets)
    crit = build_criterion(args, SunrgbdAnonymousConfig())
    total, got = crit({k: torch.from_numpy(v) for k, v in outs.items()},
                      {k: torch.from_numpy(np.asarray(v)) for k, v in targets.items()})
    assert set(got) == set(want)
    name = "loss_feat_seen_softmax_weakly_loss_with_novel_cate_confi"
    for key in [name] + [f"{name}_{i}" for i in range(2)]:
        assert key in got, key
        assert float(got[key]) > 0, key
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), rtol=0, atol=LOSS_TOL,
                                   err_msg=key)
    for key in want:
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), rtol=0, atol=LOSS_TOL,
                                   err_msg=key)
    np.testing.assert_allclose(_np(total), np.asarray(want_total), rtol=0, atol=LOSS_TOL)


def test_stage2_loss_types_differ():
    """non-confidence weighs every kept proposal 1; clip-max-prob by its
    confidence: the two losses differ on the same inputs."""
    from coda_neurips2023_tpu_torch.criterion import SetCriterion

    assert "loss_feat_seen_softmax_weakly_loss_with_novel_cate_confi" in \
        __import__("coda_neurips2023_tpu_torch.criterion", fromlist=["x"]).LOSSES
    rng = np.random.default_rng(7)
    outs = {"text_correlation_embedding": torch.from_numpy(
        rng.standard_normal((2, 1, 4, 8)).astype(np.float32))}
    targets = {"text_features_clip": torch.eye(8)[:5], "logit_scale": torch.tensor(10.0),
               "gt_box_seen_sem_cls_label": torch.zeros((1, 2), dtype=torch.int64),
               "gt_box_seen_sem_cls_confi": torch.tensor([[0.5, 0.0]]),
               "weak_box_cate_label": torch.tensor([[1, 2, 3, 4]]),
               "weak_confidence_weight": torch.tensor([[0.25, 0.0, 0.75, 0.5]])}
    assignments = {"per_prop_gt_inds": torch.zeros((2, 1, 4), dtype=torch.int64),
                   "proposal_matched_mask": torch.tensor([[[1.0, 0, 0, 0]]] * 2)}
    losses = {}
    for ctype in ("non-confidence", "clip-max-prob"):
        crit = SetCriterion.__new__(SetCriterion)
        crit.confidence_type = ctype
        losses[ctype] = crit.loss_feat_seen_softmax_weakly_loss_with_novel_cate_confi(
            outs, targets, assignments)
    assert losses["non-confidence"].shape == (2,)
    assert not torch.allclose(losses["non-confidence"], losses["clip-max-prob"])
