"""The rest of the PyTorch port's criterion against the JAX package on the CPU.

The sixteen losses the shipped scripts leave at weight 0 (JAX
criterion.py:257-684): the discovery-objectness variants of the softmax
loss, the seen-class losses on the embedding-to-text-bank products, and the
losses of model variants the JAX package does not wire (image-level seen
classes, the contrastive and prompt losses).  Each case runs one whole
`SetCriterion.__call__` of the port with every loss of the registry above
weight 0, over 3 decoder layers, so the aux layers' keys and
`_LAST_LAYER_ONLY` are exercised, from numpy inputs (the stacked outputs of
tests/test_torch_port_train.py, whose boxes lie near the ground truth, plus
the keys these losses read, drawn here):

  * `full`: every optional key present, `discovery_novel` and a targets'
    `novel_box_judge` built by hand (nothing in the JAX package makes them),
    seen labels of -1 (novel boxes) among the ground truth;
  * `empty_scene`: the second scene without ground truth;
  * one case for each other --confidence_type;
  * `absent`: no optional key, where the losses that read one give 0;
  * `judge_in_outputs`: the model's own (L, B, nq) `novel_box_judge`.

Each case holds the sixteen losses, each layer's, against the JAX loss
functions called on that layer with the port's assignments: within 1e-5
(float32 on both sides; the sums run in different orders).  The `full` case
also runs the JAX package's whole criterion (one compile) against the
port's: every term and the total within 1e-5 of max(1, its size).
"""

import types

import numpy as np
import pytest
import torch

import jax

from coda_neurips2023_tpu import criterion as jcriterion
from coda_neurips2023_tpu.datasets.config import SunrgbdAnonymousConfig as JaxConfig

from coda_neurips2023_tpu_torch import engine
from coda_neurips2023_tpu_torch.criterion import LOSSES, _LAST_LAYER_ONLY, build_criterion
from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig

from test_torch_port_train import BASELINE_ARGS, _outputs_near_targets, _scenes
from torch_one_thread import one_intra_op_thread  # noqa: F401

LOSS_TOL = 1e-5
NUM_LAYERS, NQ, EMB, NCLS = 3, 16, 16, 12  # NCLS: the text bank, above train_range_max 10
# the sixteen, in the registry's order
NEW_LOSSES = tuple(n for n in LOSSES if n not in (
    "loss_sem_cls", "loss_sem_cls_softmax", "loss_sem_cls_softmax_skip_none_gt_sample",
    "loss_angle", "loss_center", "loss_size", "loss_giou", "loss_region_embed",
    "loss_predicted_region_embed_l1", "loss_predicted_region_embed_l1_only_last_layer",
    "loss_predicted_region_embed_cos", "loss_feat_seen_softmax_weakly_loss_with_novel_cate_confi",
    "loss_contrast_object_text"))
CONFIDENCE = ("non-confidence", "clip-max-prob", "objectness", "clip+objectness")
CASES = ("full", "empty_scene", "clip-max-prob", "objectness", "clip+objectness", "absent",
         "judge_in_outputs")
# the JAX package's engine._TARGET_KEYS that the synthetic batch has
TARGETS = ("gt_box_corners", "gt_box_centers_normalized", "gt_box_sizes_normalized",
           "gt_box_angles", "gt_angle_class_label", "gt_angle_residual_label",
           "gt_box_sem_cls_label", "gt_box_present", "gt_box_seen_sem_cls_label",
           "gt_box_seen_sem_cls_confi")


def _weights():
    """Every registered loss at a weight of its own above 0."""
    w = {name + "_weight": 0.3 + 0.1 * i for i, name in enumerate(LOSSES) if name != "loss_angle"}
    # loss_contrast_object_text's flag has no _weight suffix
    return dict(w, loss_angle_cls_weight=0.1, loss_angle_reg_weight=0.5,
                loss_contrast_object_text=w.pop("loss_contrast_object_text_weight"))


def _inputs(case):
    """(outputs, targets) as numpy arrays for `case`."""
    rng = np.random.default_rng(CASES.index(case))
    batch = _scenes(2, seed=4)
    b = 2
    if case == "empty_scene":
        for k in ("gt_box_present", "gt_box_corners", "gt_box_centers_normalized",
                  "gt_box_sizes_normalized", "gt_angle_class_label", "gt_angle_residual_label"):
            batch[k][1] = 0
    ngt = batch["gt_box_present"].shape[1]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    outs = _outputs_near_targets(batch, NUM_LAYERS, NQ, seed=5)
    outs["text_correlation_embedding"] = f(NUM_LAYERS, b, NQ, EMB)
    text = f(NCLS, EMB)
    targets = {k: batch[k] for k in TARGETS}
    targets.update(
        text_features_clip=text / np.linalg.norm(text, axis=-1, keepdims=True),
        logit_scale=np.float32(20.0),
        # seen labels in [-1, 10): -1 marks a novel box
        gt_box_seen_sem_cls_label=rng.integers(-1, 10, (b, ngt)).astype(np.int64),
        gt_box_seen_sem_cls_confi=np.where(rng.random((b, ngt)) < 0.3, 0.0,
                                           rng.random((b, ngt))).astype(np.float32),
        weak_box_cate_label=rng.integers(0, NCLS, (b, NQ)).astype(np.int64),
        weak_confidence_weight=np.where(rng.random((b, NQ)) < 0.3, 0.0,
                                        rng.random((b, NQ))).astype(np.float32),
        # stage 1's distillation targets, for the losses already ported
        gt_text_correlation_embedding=f(b, NQ, EMB),
        gt_text_correlation_embedding_mask=(rng.random((b, NQ, 1)) < 0.7).astype(np.float32),
    )
    if case == "absent":
        return outs, targets
    targets.update(
        discovery_novel=(rng.random((b, NQ)) < 0.25).astype(np.float32),
        gt_image_class_label=(rng.random((b, 10)) < 0.3).astype(np.float32),
        full_image_embedding=f(b, EMB),
        seen_classes=rng.integers(0, 10, (b,)).astype(np.int64),
    )
    judge = (rng.random((b, NQ)) < 0.25).astype(np.float32)
    judge[1] = 0  # a scene whose only flagged boxes are its ground truth's
    if case == "judge_in_outputs":
        outs["novel_box_judge"] = np.stack([np.roll(judge, i, axis=1)
                                            for i in range(NUM_LAYERS)])
    else:
        targets["novel_box_judge"] = judge
    outs.update(
        seen_class_scores_per_image=f(NUM_LAYERS, b, 10),
        pooled_updated_text_features=f(NUM_LAYERS, b, EMB) / 4,
        image_features_clip=f(NUM_LAYERS, b, EMB) / 4,
        seen_sem_cls_logits=f(NUM_LAYERS, b, NQ, 11),
        prompt_text_correlation_embedding=f(NUM_LAYERS, b, 2, EMB),
        prompt_text_features_clip=f(NUM_LAYERS, b, 10, EMB) / 4,
        prompt_temperature_param=np.float32([2.0, 3.0, 5.0]),
    )
    return outs, targets


def _args(case):
    confidence = case if case in CONFIDENCE else "non-confidence"
    return types.SimpleNamespace(**dict(BASELINE_ARGS, **_weights(), confidence_type=confidence))


def _t(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


@pytest.fixture(scope="module", params=CASES)
def case(request):
    """The port's criterion on `case`'s inputs (its loss dict, weighted),
    and each of the sixteen JAX loss functions on each layer's outputs with
    the port's assignments (the matcher is held against the JAX one in
    tests/test_torch_port_train.py), weighted alike, under the port's key."""
    outs, targets = _inputs(request.param)
    args = _args(request.param)
    crit = build_criterion(args, SunrgbdAnonymousConfig())
    _, got = crit(_t(outs), _t(targets))
    jcrit = jcriterion.build_criterion(args, JaxConfig())
    jtargets = dict(targets)
    jtargets["nactual_gt"] = targets["gt_box_present"].sum(1).astype(np.int32)
    jtargets["num_boxes"] = np.float32(max(jtargets["nactual_gt"].sum(), 1))
    assign = {k: v.numpy() for k, v in crit.last_assignments.items()}
    want = {}
    for layer in range(NUM_LAYERS):
        last = layer == NUM_LAYERS - 1
        louts = {k: v[layer] for k, v in outs.items()}
        lassign = {k: v[layer] for k, v in assign.items()}
        for name in NEW_LOSSES:
            if not last and name in _LAST_LAYER_ONLY:
                continue
            val = jcrit.loss_functions[name](louts, jtargets, lassign)
            key = name if last else f"{name}_{layer}"
            want[key] = np.asarray(val) * jcrit.loss_weight_dict[name + "_weight"]
    return dict(name=request.param, got=got, want=want)


@pytest.mark.parametrize("loss", NEW_LOSSES)
def test_each_loss_matches_jax(case, loss):
    """The loss on every layer (the last layer only for _LAST_LAYER_ONLY)."""
    got, want = case["got"], case["want"]
    keys = [loss] + [f"{loss}_{i}" for i in range(NUM_LAYERS - 1)]
    if loss in _LAST_LAYER_ONLY:
        assert not set(keys[1:]) & (set(got) | set(want))
        keys = keys[:1]
    for key in keys:
        assert key in got and key in want, key
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0, atol=LOSS_TOL,
                                   err_msg=f"{case['name']}: {key}")
    if case["name"] == "absent" and loss in (
            "loss_image_seen_class", "loss_contrastive", "loss_sem_focal_cls",
            "loss_feat_seen_sigmoid_with_full_image_loss", "loss_batchwise_contrastive",
            "loss_prompt_softmax", "loss_prompt_sigmoid"):
        assert all(float(got[k]) == 0.0 for k in keys), loss


def test_whole_criterion_matches_jax():
    """`full`: one whole SetCriterion.__call__ on each side, every weight
    above 0, every key of the loss dict and the total.  The weighted terms
    of the losses ported before reach ~18 here, where 1e-5 is 5 float32
    ulps: each is held within 1e-5 of max(1, its size)."""
    outs, targets = _inputs("full")
    args = _args("full")
    jcrit = jcriterion.build_criterion(args, JaxConfig())
    want_total, want = jax.jit(lambda o, t: jcrit(o, t))(outs, targets)
    crit = build_criterion(args, SunrgbdAnonymousConfig())
    total, got = crit(_t(outs), _t(targets))
    assert set(got) == set(want)
    # a key a layer for each loss (loss_angle's two) and loss_cardinality,
    # the last layer's alone for the four _LAST_LAYER_ONLY losses registered
    last_only = [n for n in LOSSES if n in _LAST_LAYER_ONLY]
    assert len(last_only) == 4
    assert len(got) == NUM_LAYERS * (len(LOSSES) + 2) - (NUM_LAYERS - 1) * len(last_only)
    for key, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=LOSS_TOL * max(1.0, abs(float(w))), err_msg=key)
    np.testing.assert_allclose(total.numpy(), np.asarray(want_total), rtol=0,
                               atol=LOSS_TOL * max(1.0, abs(float(want_total))))
    assert crit.last_assignments["proposal_matched_mask"].sum() > 0


def test_registry_is_the_jax_registry_in_order():
    jcrit = jcriterion.build_criterion(_args("full"), JaxConfig())
    crit = build_criterion(_args("full"), SunrgbdAnonymousConfig())
    assert tuple(crit.loss_functions) == tuple(jcrit.loss_functions) == LOSSES
    assert len(NEW_LOSSES) == 16
    # build_criterion passes every weight flag the JAX package's passes
    assert {k: v for k, v in crit.loss_weight_dict.items() if v} == \
        {k: v for k, v in jcrit.loss_weight_dict.items() if v}


def test_discovery_novel_reaches_the_criterion():
    """engine.TARGET_KEYS carries discovery_novel (JAX engine.py:76): a
    batch that holds it changes the discovery-objectness loss."""
    assert "discovery_novel" in engine.TARGET_KEYS
    from coda_neurips2023_tpu.engine import _TARGET_KEYS as JAX_TARGET_KEYS

    assert set(JAX_TARGET_KEYS) - set(engine.TARGET_KEYS) == {
        "point_clouds", "gt_text_correlation_embedding", "gt_text_correlation_embedding_mask",
        "weak_box_cate_label", "weak_confidence_weight"}  # the forward's, or stage 1's targets
