"""The PyTorch port's stage-1 distillation training step against the JAX package on the CPU.

Stage 1 (scripts/coda_sunrgbd_stage1.sh) trains the CoDA detector with the
detection losses and a distillation loss: the L1 distance between each
proposal's 512-d embedding and the CLIP image embedding of its box's crop.
At tiny widths (the detector of tests/test_torch_port_model.py, the tiny
CLIP of tests/test_torch_port_clip.py with 16-pixel crops, the 2 scenes of
1,024 points of the baseline step's test, seed 0, with 64 x 96 images), the
same numpy inputs go through the JAX package and the port:

  * the ball-query dispatch: which kernel (B, F or G) each setting of
    CODA_BQ_ALGO, CODA_BQ_MXU and CODA_BQ_FUSED_GATHER reaches, the JAX
    package's ValueError on a mistyped CODA_BQ_ALGO, F's four-part gate;
  * the distillation targets, from the same crop selection (the JAX
    package's jax.random draw, computed here and given to the port):
    embeddings within 1e-5, the mask exactly, the keep-box and weak-label
    fields exactly where CLIP's top two probabilities differ by > 1e-4;
  * the stage-1 losses (masked L1 and its last-layer-only twin, cosine,
    region embedding, object-text contrast), every layer: within 1e-5;
  * one whole stage-1 step at dropout 0 against StageContext.
    make_fused_train_step: the total loss within 1e-5 of its size, each
    term within 1e-4 (the baseline step's tolerance in
    tests/test_torch_port_train.py: the two forwards' fp32 sums run in
    different orders, and BatchNorm's batch statistics over 2 scenes carry
    that into every head), gradients within 2e-4 of their global norm;
  * the frozen CLIP: none of its parameters reaches the optimizer, and its
    weights are bitwise unchanged by a step;
  * the entry points build on the card unless asked for the CPU.
"""

import types

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from coda_neurips2023_tpu import criterion as jcriterion
from coda_neurips2023_tpu.datasets.config import SunrgbdAnonymousConfig as JaxConfig
from coda_neurips2023_tpu.engine import TrainState
from coda_neurips2023_tpu.models import clip as jclip
from coda_neurips2023_tpu.models import distillation as jdist
from coda_neurips2023_tpu.ops.grouping import ball_query as jax_ball_query
from coda_neurips2023_tpu.stages import StageContext as JaxStageContext

from coda_neurips2023_tpu_torch import models as tmodels
from coda_neurips2023_tpu_torch.criterion import build_criterion
from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset, make_batch
from coda_neurips2023_tpu_torch.models import distillation as tdist
from coda_neurips2023_tpu_torch.models import model_3detr as tmodel
from coda_neurips2023_tpu_torch.ops import grouping
from coda_neurips2023_tpu_torch.optimizer import build_optimizer
from coda_neurips2023_tpu_torch.stages import StageContext
from coda_neurips2023_tpu_torch.utils.weights import grads_from_flax

from test_torch_port_clip import TINY_CLIP, _jax_clip, _port_clip
from test_torch_port_model import TINY, _assert_no_boundary_flip, _build
from test_torch_port_train import BASELINE_ARGS, _outputs_near_targets, _scenes
from torch_one_thread import one_intra_op_thread  # noqa: F401

EMB_TOL = 1e-5
LOSS_TOL = 1e-5
STEP_LOSS_RTOL = 1e-5  # the total loss, relative to its size
STEP_TERM_TOL = 1e-4  # each loss term, absolute
GRAD_TOL = 2e-4
MARGIN = 1e-4
N_SEL = 8  # distillation_box_num, cut to the tiny detector's 16 queries
CROP = 16  # the tiny CLIP's input resolution

# scripts/coda_sunrgbd_stage1.sh on top of the baseline's flags
STAGE1_ARGS = dict(
    BASELINE_ARGS, model_name="3detr_predictedbox_distillation",
    loss_predicted_region_embed_l1_weight=1.0, loss_no_object_contrast_weight=0.05,
    distillation_box_num=N_SEL, if_clip_weak_labels=False, if_clip_more_prompts=True,
    if_clip_superset=False, test_range_max=46, clip_model_path=None, clip_bpe_path=None,
    dataset_name="sunrgbd_anonymous_aligned_image",
)


def _args(**over):
    return types.SimpleNamespace(**dict(STAGE1_ARGS, **over))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol, what=""):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _jax_sel(rng, b, nq, n_sel):
    """The JAX build_clip_distillation_targets' own draw (distillation.py:387-388)."""
    keys = jax.random.split(rng, b)
    return np.asarray(jax.vmap(lambda k: jax.random.permutation(k, nq)[:n_sel])(keys))


def _image_scenes(num_scenes=2, seed=0):
    ds = SyntheticDetectionDataset(SunrgbdAnonymousConfig(), num_scenes=num_scenes,
                                   num_points=1024, seed=seed, with_images=True)
    return make_batch(ds, 0, num_scenes)


# ---------------------------------------------------------------- (a) dispatch


@pytest.mark.parametrize("env,nsample,n,kernel,fused", [
    ({}, 64, 20000, "coda_ball_query", False),
    ({}, 32, 2048, "coda_ball_query", False),
    ({"CODA_BQ_ALGO": "window"}, 64, 20000, "coda_ball_query", False),
    ({"CODA_BQ_ALGO": "adaptive"}, 64, 20000, "coda_ball_query_tile", False),
    ({"CODA_BQ_ALGO": "adaptive"}, 32, 2048, "coda_ball_query_tile", False),
    ({"CODA_BQ_MXU": "1"}, 64, 20000, "coda_ball_query_tile", False),
    ({"CODA_BQ_MXU": "1"}, 32, 2048, "coda_ball_query", False),
    ({"CODA_BQ_MXU": "1", "CODA_BQ_ALGO": "adaptive"}, 32, 2048, "coda_ball_query_tile", False),
    ({"CODA_BQ_FUSED_GATHER": "1"}, 64, 20000, "coda_ball_query", True),
    ({"CODA_BQ_FUSED_GATHER": "1"}, 64, 4095, "coda_ball_query", False),
    ({"CODA_BQ_FUSED_GATHER": "1"}, 128, 20000, "coda_ball_query", False),
    ({"CODA_BQ_FUSED_GATHER": "1", "CODA_BQ_ALGO": "window"}, 64, 20000, "coda_ball_query", False),
    ({"CODA_BQ_FUSED_GATHER": "1", "CODA_BQ_ALGO": "adaptive"}, 64, 20000,
     "coda_ball_query_tile", False),
    ({"CODA_BQ_FUSED_GATHER": "1", "CODA_BQ_MXU": "1"}, 32, 20000, "coda_ball_query", False),
], ids=["default", "default_small_n", "window", "adaptive", "adaptive_k32", "mxu_k64", "mxu_k32",
        "mxu_k32_adaptive", "fused", "fused_small_n", "fused_k128", "fused_window",
        "fused_adaptive", "fused_mxu"])
def test_ball_query_dispatch_table(monkeypatch, env, nsample, n, kernel, fused):
    """Which kernel each setting reaches (grouping.py:73-124, 223-230 of the
    JAX package): B, G, and F only under its four-part gate."""
    for var in ("CODA_BQ_ALGO", "CODA_BQ_MXU", "CODA_BQ_FUSED_GATHER"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    assert grouping.ball_query_kernel(nsample) == kernel
    assert grouping.fused_gather(nsample, n) is fused
    # query_and_group takes F exactly when the gate says so
    calls = []
    monkeypatch.setattr(grouping, "ball_query_group",
                        lambda *a: calls.append("F") or grouping.ball_query_group_plain(*a))
    monkeypatch.setattr(grouping, "ball_query",
                        lambda *a: calls.append("B or G") or grouping.ball_query_plain(*a))
    xyz = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, n, 3)).astype(np.float32))
    grouping.query_and_group(0.2, nsample, xyz, xyz[:, :5].contiguous())
    assert calls == (["F"] if fused else ["B or G"])


def test_mistyped_algo_raises_as_jax(monkeypatch):
    monkeypatch.delenv("CODA_BQ_MXU", raising=False)
    monkeypatch.setenv("CODA_BQ_ALGO", "sortd")
    with pytest.raises(ValueError) as got:
        grouping.ball_query_kernel(64)
    xyz = jnp.zeros((1, 37, 3), jnp.float32)
    with pytest.raises(ValueError) as want:
        jax_ball_query(0.2, 64, xyz, xyz[:, :5], True)
    assert str(got.value) == str(want.value)
    # a CPU tensor takes the plain version whatever the environment says
    pts = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (1, 50, 3)).astype(np.float32))
    torch.testing.assert_close(grouping.ball_query(0.5, 8, pts, pts[:, :4]),
                               grouping.ball_query_plain(0.5, 8, pts, pts[:, :4]), rtol=0, atol=0)


# ---------------------------------------------------------------- (b) targets


@pytest.fixture(scope="module")
def last_layer_outputs():
    """The tiny CoDA detector's last-layer outputs on 2 scenes with images,
    the tiny CLIP in flax and in the port, and a 20-class text bank."""
    batch = _image_scenes()
    pts = {k: batch[k] for k in ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")}
    jm, variables, _, _ = _build(TINY, pts)
    out = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables, pts)
    last = {k: np.asarray(v[-1]) for k, v in out.items()
            if k not in ("query_xyz", "enc_xyz", "enc_inds")}
    jm_clip, params = _jax_clip(TINY_CLIP)
    text = np.random.default_rng(3).standard_normal((20, 512)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    return dict(batch=batch, last=last, jclip=jm_clip, params=params,
                tclip=_port_clip(TINY_CLIP, params), text=text)


def _top_two_margin(emb, text, scale):
    norm = emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-32)
    logits = (norm @ text.T) * scale
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top = np.sort(p, axis=-1)
    return top[..., -1] - top[..., -2]


@pytest.mark.parametrize("keep_box,weak_labels", [(False, False), (True, True)])
def test_distillation_targets_match_jax(last_layer_outputs, keep_box, weak_labels):
    d = last_layer_outputs
    batch, last, text = d["batch"], d["last"], d["text"]
    rng = jax.random.PRNGKey(11)
    b, nq = last["objectness_prob"].shape
    sel = _jax_sel(rng, b, nq, N_SEL)
    params = d["params"]

    def jax_clip_fn(images):
        return d["jclip"].apply({"params": params}, images, method=d["jclip"].encode_image)

    kw = dict(if_clip_weak_labels=weak_labels, crop_size=CROP, if_keep_box=keep_box,
              keep_objectness=0.3, train_range_max=10)
    want = jax.tree.map(np.asarray, jdist.build_clip_distillation_targets(
        rng, {k: jnp.asarray(v) for k, v in last.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, jax_clip_fn,
        text_features=jnp.asarray(text), logit_scale=jnp.float32(100.0),
        distillation_box_num=N_SEL, keep_enabled=True, **kw))

    def port_clip_fn(images):
        with torch.no_grad():
            return d["tclip"].encode_image(images)

    got = tdist.build_clip_distillation_targets(
        {k: torch.from_numpy(v) for k, v in last.items()},
        {k: torch.from_numpy(v) for k, v in batch.items()}, port_clip_fn,
        torch.from_numpy(sel.astype(np.int64)), text_features=torch.from_numpy(text),
        logit_scale=100.0, keep_enabled=True, **kw)
    assert set(got) == set(want)
    mask = _np(got["gt_text_correlation_embedding_mask"])
    np.testing.assert_array_equal(mask, want["gt_text_correlation_embedding_mask"])
    assert mask.sum() > 0 and mask.sum() <= b * N_SEL
    emb = _np(got["gt_text_correlation_embedding"])
    _close(emb, want["gt_text_correlation_embedding"], EMB_TOL, "embedding")
    assert np.all(emb[mask[..., 0] == 0] == 0)
    # the labels CLIP decides: exact where its top two probabilities stand apart
    rows = np.take_along_axis(emb, sel[..., None], 1)
    valid_rows = np.take_along_axis(mask[..., 0], sel, 1) > 0
    sure = (_top_two_margin(rows, text, 100.0) > MARGIN) | ~valid_rows
    if weak_labels:
        sure_q = (_top_two_margin(emb, text, 100.0) > MARGIN) | (mask[..., 0] == 0)
        np.testing.assert_array_equal(_np(got["weak_box_cate_label"])[sure_q],
                                      want["weak_box_cate_label"][sure_q])
        _close(_np(got["weak_confidence_weight"])[sure_q], want["weak_confidence_weight"][sure_q],
               EMB_TOL, "weak confidence")
        assert (want["weak_confidence_weight"] > 0).sum() == mask.sum()
    else:
        assert not _np(got["weak_box_cate_label"]).any()
        assert not _np(got["weak_confidence_weight"]).any()
    if keep_box:
        # a crop whose class CLIP cannot tell apart would make the appended
        # boxes' order a matter of rounding
        assert sure.all(), "a kept-box decision sits at CLIP's top-two boundary"
        kept = want["gt_box_present"].sum() - batch["gt_box_present"].sum()
        assert kept > 0, "no box was appended: the case does not exercise --if_keep_box"
        for key in ("gt_box_present", "gt_angle_class_label", "gt_angle_residual_label",
                    "gt_box_sizes_normalized", "gt_box_corners", "gt_box_angles",
                    "gt_box_centers_normalized", "gt_box_sizes", "gt_box_corners_xyz"):
            np.testing.assert_array_equal(_np(got[key]), want[key].astype(_np(got[key]).dtype),
                                          err_msg=key)


def test_selection_draws_a_permutation_and_ranks_by_objectness():
    gen = torch.Generator().manual_seed(0)
    sel = tdist.select_distillation_boxes(gen, 3, 40, 12)
    assert sel.shape == (3, 12) and sel.dtype == torch.int64
    assert all(len(set(row.tolist())) == 12 for row in sel)
    again = tdist.select_distillation_boxes(torch.Generator().manual_seed(0), 3, 40, 12)
    assert torch.equal(sel, again)
    obj = torch.full((3, 40), 0.01)
    obj[:, [3, 7, 30]] = 0.9  # three foreground boxes lead, in query order
    by_obj = tdist.select_distillation_boxes(gen, 3, 40, 12, obj, torch.tensor(True))
    assert by_obj[:, :3].tolist() == [[3, 7, 30]] * 3
    assert all(len(set(row.tolist())) == 12 for row in by_obj)
    off = tdist.select_distillation_boxes(torch.Generator().manual_seed(0), 3, 40, 12, obj,
                                          torch.tensor(False))
    assert torch.equal(off, sel)


# ---------------------------------------------------------------- (c) losses


@pytest.mark.parametrize("weights", [
    dict(loss_predicted_region_embed_l1_weight=1.0, loss_contrast_object_text=0.7),
    dict(loss_predicted_region_embed_l1_only_last_layer_weight=2.0,
         loss_predicted_region_embed_cos_weight=0.5, loss_region_embed_weight=0.3),
], ids=["l1_contrast", "last_layer_cos_region"])
def test_stage1_losses_match_jax(weights):
    batch = _scenes(3, seed=4)
    outs = _outputs_near_targets(batch, num_layers=3, nq=16, seed=5)
    rng = np.random.default_rng(6)
    outs["text_correlation_embedding"] = rng.standard_normal((3, 3, 16, 512)).astype(np.float32)
    mask = (rng.uniform(size=(3, 16, 1)) < 0.4).astype(np.float32)
    text = rng.standard_normal((10, 512)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    targets = {k: batch[k] for k in ("gt_box_corners", "gt_box_centers_normalized",
                                     "gt_box_sizes_normalized", "gt_box_angles",
                                     "gt_angle_class_label", "gt_angle_residual_label",
                                     "gt_box_sem_cls_label", "gt_box_present",
                                     "gt_box_seen_sem_cls_confi")}
    targets.update(
        gt_box_seen_sem_cls_label=rng.integers(0, 10, batch["gt_box_present"].shape),
        gt_text_correlation_embedding=(rng.standard_normal((3, 16, 512)) * mask).astype(np.float32),
        gt_text_correlation_embedding_mask=mask,
        text_features_clip=text, logit_scale=np.float32(100.0),
    )
    args = _args(**dict(dict(loss_predicted_region_embed_l1_weight=0.0), **weights))
    jcrit = jcriterion.build_criterion(args, JaxConfig())
    want_total, want = jax.jit(lambda o, t: jcrit(o, t))(outs, targets)
    crit = build_criterion(args, SunrgbdAnonymousConfig())
    total, got = crit({k: torch.from_numpy(v) for k, v in outs.items()},
                      {k: torch.from_numpy(np.asarray(v)) for k, v in targets.items()})
    assert set(got) == set(want)
    for name in weights:
        loss = name[:-len("_weight")] if name.endswith("_weight") else name
        assert loss in got, loss
        if "only_last_layer" in loss:  # no aux-layer keys: the last layer only
            assert f"{loss}_0" not in got and f"{loss}_0" not in want
        else:
            assert f"{loss}_1" in got
    for key in want:
        _close(got[key], want[key], LOSS_TOL, key)
    _close(total, want_total, LOSS_TOL, "total")


def test_unported_stage2_losses_still_raise():
    """The stage-2 weak-label loss by IoU match raised until the rest of the
    criterion was ported: it now builds and is active, in the JAX
    registry's place."""
    name = "loss_feat_seen_softmax_iou_match_weakly_loss_with_novel_cate_confi"
    crit = build_criterion(_args(**{name + "_weight": 1.0}), SunrgbdAnonymousConfig())
    assert crit._active(name)
    jcrit = jcriterion.build_criterion(_args(**{name + "_weight": 1.0}), JaxConfig())
    assert list(crit.loss_functions).index(name) == list(jcrit.loss_functions).index(name)


# ---------------------------------------------------------------- (d) whole step


@pytest.fixture(scope="module")
def stage1():
    """The tiny CoDA detector (dropout 0) and the tiny CLIP, in flax and in
    the port, two StageContexts from the same CLIP weights, and 2 scenes."""
    batch = _image_scenes()
    no_dropout = dict(mlp_dropout=0.0, enc_dropout=0.0, dec_dropout=0.0)
    pts = {k: batch[k] for k in ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")}
    jm, variables, _, tm = _build(dict(TINY, **no_dropout), pts)
    args = _args()
    jctx = JaxStageContext(args, JaxConfig(), clip_model=jclip.CLIP(**TINY_CLIP), crop_size=CROP)
    tclip = _port_clip(TINY_CLIP, jax.tree.map(np.asarray, jctx.clip_variables["params"]))
    tctx = StageContext(args, SunrgbdAnonymousConfig(), clip_model=tclip, crop_size=CROP,
                        device="cpu")
    return dict(batch=batch, jm=jm, variables=variables, tm=tm.train(), jctx=jctx, tctx=tctx,
                args=args)


@pytest.fixture(scope="module")
def jax_stage1_step(stage1):
    """One JAX fused stage-1 step; the optimizer's state keeps the gradients."""
    v, jctx, batch = stage1["variables"], stage1["jctx"], stage1["batch"]
    keep_grads = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))
    crit = jcriterion.build_criterion(stage1["args"], JaxConfig())
    step = jctx.make_fused_train_step(stage1["jm"], crit, keep_grads, lr_schedule=lambda s: 0.0)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], constants=v["constants"],
                       opt_state=keep_grads.init(v["params"]))
    rng = jax.random.PRNGKey(5)
    new_state, metrics = step(state, {k: jnp.asarray(x) for k, x in batch.items()}, rng)
    # the crops the step drew: fold_in(step 0), fold_in(7), split per scene
    nq = TINY["nqueries"]
    sel = _jax_sel(jax.random.fold_in(jax.random.fold_in(rng, 0), 7), 2, nq, N_SEL)
    return dict(metrics=jax.tree.map(np.asarray, metrics),
                grads=jax.tree.map(np.asarray, new_state.opt_state), sel=sel)


@pytest.fixture(scope="module")
def port_stage1_step(stage1, jax_stage1_step):
    _assert_no_boundary_flip(stage1["batch"], TINY["preenc_npoints"])
    tm, tctx, args = stage1["tm"], stage1["tctx"], stage1["args"]
    clip_before = {k: v.clone() for k, v in tctx.clip_model.state_dict().items()}
    opt, sched = build_optimizer(args, tm, 600)
    step = tctx.make_fused_train_step(tm, build_criterion(args, SunrgbdAnonymousConfig()), opt,
                                      lr_schedule=sched)
    batch = {k: torch.from_numpy(v) for k, v in stage1["batch"].items()}
    batch["distillation_sel"] = torch.from_numpy(jax_stage1_step["sel"].astype(np.int64))
    metrics = step(batch, torch.Generator().manual_seed(0))
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    return dict(metrics=metrics, grads=grads, optimizer=opt, clip_before=clip_before)


def test_stage1_step_loss_matches_jax(jax_stage1_step, port_stage1_step):
    got, want = port_stage1_step["metrics"], jax_stage1_step["metrics"]
    assert set(got) == set(want)
    assert float(got["loss_predicted_region_embed_l1"]) > 0
    assert "loss_predicted_region_embed_l1_3" not in got  # aux layers 0, 1 of 3
    _close(got["loss"], want["loss"], STEP_LOSS_RTOL * abs(float(want["loss"])), "loss")
    for key in want:
        if key not in ("loss", "lr"):
            _close(got[key], want[key], STEP_TERM_TOL, key)


def test_stage1_step_gradients_match_jax(jax_stage1_step, port_stage1_step):
    want = grads_from_flax(jax_stage1_step["grads"])
    got = port_stage1_step["grads"]
    assert set(got) == set(want)
    assert np.abs(_np(got["mlp_heads.text_correlation_head.layers.8.weight"])).max() > 0
    norm = np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2) for g in want.values()))
    assert norm > 0
    for name, w in want.items():
        err = np.abs(_np(got[name]) - np.asarray(w)).max() / norm
        assert err <= GRAD_TOL, (name, err)


def test_clip_stays_frozen(stage1, port_stage1_step):
    """The optimizer holds the detector's parameters only, and a step leaves
    CLIP's weights bitwise as they were."""
    clip = stage1["tctx"].clip_model
    opt = port_stage1_step["optimizer"]
    clip_ids = {id(p) for p in clip.parameters()}
    assert not clip_ids & {id(p) for p in opt.params}
    assert len(opt.params) == len(list(stage1["tm"].parameters()))
    assert not any(p.requires_grad for p in clip.parameters())
    assert all(p.grad is None for p in clip.parameters())
    for k, v in clip.state_dict().items():
        assert torch.equal(v, port_stage1_step["clip_before"][k]), k
    assert opt.count == 1


def test_targets_step_restores_batchnorm_and_generator(stage1):
    tm, tctx = stage1["tm"], stage1["tctx"]
    batch = {k: torch.from_numpy(v) for k, v in stage1["batch"].items()}
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    gen = torch.Generator().manual_seed(9)
    targets = tctx.make_targets_step(tm)(batch, gen)
    assert targets["gt_text_correlation_embedding_mask"].sum() > 0
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert torch.equal(gen.get_state(), torch.Generator().manual_seed(9).get_state())


# ---------------------------------------------------------------- (e) device


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(**TINY, enc_type="vanilla", enc_nhead=4, enc_activation="relu", dec_nhead=4,
                 mlp_dropout=0.0, pos_embed="fourier", use_color=False)
    cfg = SunrgbdAnonymousConfig()
    for build in (tmodels.build_model, tmodel.build_3detr_predictedbox_distillation_head,
                  tmodel.build_3detr_multiclasshead):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(args, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StageContext(args, cfg, clip_model=_port_clip(TINY_CLIP, _jax_clip(TINY_CLIP)[1]),
                     crop_size=CROP)
    model, _ = tmodels.build_model(args, cfg, device="cpu")
    assert "text_correlation_head" in model.mlp_heads
    assert {p.device.type for p in model.parameters()} == {"cpu"}
