"""The PyTorch port's training step against the JAX package on the CPU.

The tiny detector of tests/test_torch_port_model.py (TINY, 1,024 points,
batch 2) with weights initialised in flax and bridged to the port, and the
baseline detector's training configuration (scripts/coda_baseline_sunrgbd.sh:
matcher costs cls 1, giou 3, center 5, objectness 5; the skip-none-gt
softmax loss, no-object weight 0.05, angle 0.1 / 0.5, center 5, size 1;
AdamW, weight decay 0.1, clip 0.1).  Each part of the step is held against
its JAX counterpart on the same numpy inputs:

  * synthetic ground truth: bit-equal;
  * BatchNorm in training mode (output and running statistics): 1e-5;
  * rotated gIoU, against the JAX package and the numpy golden model: 1e-5;
  * matcher assignments: equal, or of equal total cost where costs tie;
  * every ported loss term and the total, every layer: 1e-5;
  * LR schedule: equal (host form) and within 1e-6 of base_lr (tensor
    form); optimizer updates given the same gradients: within 1e-6 of the
    update's size, plus the f32 rounding of p + update;
  * one whole train step with dropout 0: loss 1e-4, gradients 1e-4 of their
    global norm, BatchNorm statistics 1e-5 (times the statistic's largest
    entry where that exceeds 1: the first encoder-to-decoder BN's variance
    reaches 4, and E[x^2] - E[x]^2 of the encoder's outputs carries their
    fp32 rounding; the matmuls and reductions of the two sides sum in
    different orders);
  * the autograd Functions of kernels C and D (their CPU path) by gradcheck
    in float64, with and without D's attention-weight dropout, whose mask is
    also held against an independent numpy hash;
  * the fused ball query and group (kernel F's plain path) against the
    two-op path and the JAX Pallas kernel in interpret mode.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from coda_neurips2023_tpu import criterion as jcriterion
from coda_neurips2023_tpu import optimizer as joptimizer
from coda_neurips2023_tpu.datasets.config import SunrgbdAnonymousConfig as JaxConfig
from coda_neurips2023_tpu.datasets.synthetic import SyntheticDetectionDataset as JaxScenes
from coda_neurips2023_tpu.engine import _TARGET_KEYS as JAX_TARGET_KEYS
from coda_neurips2023_tpu.models import helpers as jhelpers
from coda_neurips2023_tpu.models import model_3detr as jmodel
from coda_neurips2023_tpu.ops import giou as jgiou
from coda_neurips2023_tpu.ops import hungarian as jhungarian
from coda_neurips2023_tpu.ops import pallas_ball_query as jbq
from coda_neurips2023_tpu.ops import pallas_ball_query_sorted as jbqs

from coda_neurips2023_tpu_torch.criterion import build_criterion
from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset, make_batch
from coda_neurips2023_tpu_torch.engine import make_train_step, train_one_epoch
from coda_neurips2023_tpu_torch.models.box_processor import BoxProcessor
from coda_neurips2023_tpu_torch.models.helpers import BatchNorm, GenericMLP, reset_parameters
from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
from coda_neurips2023_tpu_torch.ops import box_ops
from coda_neurips2023_tpu_torch.ops.giou import generalized_box3d_iou
from coda_neurips2023_tpu_torch.ops.grouping import (
    GroupPoints,
    ball_query_group,
    group_points_plain,
    query_and_group,
)
from coda_neurips2023_tpu_torch.ops.hungarian import matcher_assignments
from coda_neurips2023_tpu_torch.ops.masked_attention import (
    MaskedAttention,
    attention_keep_mask,
    masked_attention,
    masked_attention_plain,
)
from coda_neurips2023_tpu_torch.optimizer import build_optimizer, make_lr_schedule
from coda_neurips2023_tpu_torch.utils.weights import grads_from_flax, state_dict_from_flax, to_torch

from golden import ball_query_golden, giou_golden
from test_torch_port_model import TINY, _assert_no_boundary_flip, _perturb
from torch_one_thread import one_intra_op_thread  # noqa: F401

NUM_POINTS = 1024
GIOU_TOL = 1e-5
LOSS_TOL = 1e-5
STEP_LOSS_TOL = 1e-4
GRAD_TOL = 1e-4
BN_TOL = 1e-5
OPT_RTOL = 1e-6
NO_DROPOUT = dict(mlp_dropout=0.0, enc_dropout=0.0, dec_dropout=0.0)

# scripts/coda_baseline_sunrgbd.sh with main.py's defaults, bench_train.py's optimizer
BASELINE_ARGS = dict(
    base_lr=1.97e-4, warm_lr=1e-6, warm_lr_epochs=18, final_lr=1e-6, lr_scheduler="cosine",
    weight_decay=0.1, filter_biases_wd=False, clip_gradient=0.1, max_epoch=1080,
    matcher_cls_cost=1, matcher_giou_cost=3, matcher_center_cost=5, matcher_objectness_cost=5,
    loss_giou_weight=0.0, loss_sem_cls_weight=0.0, loss_sem_cls_softmax_weight=0.0,
    loss_sem_cls_softmax_skip_none_gt_sample_weight=1.0, loss_no_object_weight=0.05,
    loss_no_object_contrast_weight=0.05, loss_angle_cls_weight=0.1, loss_angle_reg_weight=0.5,
    loss_center_weight=5.0, loss_size_weight=1.0, loss_predicted_region_embed_l1_weight=0.0,
    loss_feat_seen_softmax_weakly_loss_with_novel_cate_confi_weight=0.0,
    loss_contrast_object_text=0.0, train_range_max=10, confidence_type="non-confidence",
)


def _args(**over):
    return types.SimpleNamespace(**dict(BASELINE_ARGS, **over))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol, what=""):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _scenes(num_scenes=2, seed=0, num_points=NUM_POINTS):
    ds = SyntheticDetectionDataset(SunrgbdAnonymousConfig(), num_scenes=num_scenes,
                                   num_points=num_points, seed=seed)
    return make_batch(ds, 0, num_scenes)


# ---------------------------------------------------------------- (a) data


@pytest.mark.parametrize("seed,max_boxes", [(0, 12), (5, 1), (11, 30)])
def test_ground_truth_bit_equal(seed, max_boxes):
    keys = ("gt_box_corners", "gt_box_corners_xyz", "gt_box_centers", "gt_box_centers_normalized",
            "gt_box_sizes", "gt_box_sizes_normalized", "gt_box_angles", "gt_angle_class_label",
            "gt_angle_residual_label", "gt_box_sem_cls_label", "gt_box_present",
            "gt_box_seen_sem_cls_label", "gt_box_seen_sem_cls_confi")
    jds = JaxScenes(JaxConfig(), num_scenes=3, num_points=777, seed=seed,
                    max_boxes_per_scene=max_boxes)
    tds = SyntheticDetectionDataset(SunrgbdAnonymousConfig(), num_scenes=3, num_points=777,
                                    seed=seed, max_boxes_per_scene=max_boxes)
    for i in range(3):
        want, got = jds[i], tds[i]
        assert got["gt_box_present"].sum() >= 1
        for key in keys:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{key} scene {i}")


# ---------------------------------------------------------------- (b) BatchNorm


def test_batchnorm_train_mode_matches_flax():
    import flax.linen as nn

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 4, 16, 24)) * 2.0 + 5.0).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    bias = rng.normal(0, 0.1, 24).astype(np.float32)
    mean0 = rng.normal(0, 0.1, 24).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    jbn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    want, mutated = jbn.apply(
        {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), mutable=["batch_stats"],
    )
    bn = BatchNorm(24)
    bn.load_state_dict(to_torch({"weight": scale, "bias": bias, "running_mean": mean0,
                                 "running_var": var0,
                                 "num_batches_tracked": np.asarray(0, np.int64)}))
    got = bn.train()(torch.from_numpy(x))
    _close(got, want, BN_TOL, "output")
    _close(bn.running_mean, mutated["batch_stats"]["mean"], BN_TOL, "mean")
    _close(bn.running_var, mutated["batch_stats"]["var"], BN_TOL, "var")
    assert int(bn.num_batches_tracked) == 1


def test_generic_mlp_train_mode_matches_flax():
    """A head (bn1d, dropout 0) in training mode: output and both BNs' statistics."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 2, 16, 32)).astype(np.float32)
    jmlp = jhelpers.GenericMLP(hidden_dims=(32, 32), output_dim=5, norm="bn1d", dropout=0.0)
    variables = _perturb(jmlp.init(jax.random.PRNGKey(0), jnp.asarray(x)), 0)
    want, mutated = jmlp.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    mlp = GenericMLP(32, (32, 32), 5, norm="bn1d", dropout=0.0)
    p, s = variables["params"], variables["batch_stats"]
    sd = {}
    for i, (h, idx) in enumerate((("layer0", 0), ("layer1", 4))):
        sd[f"layers.{idx}.weight"] = np.asarray(p[h]["kernel"]).T[..., None]
        bn = s[f"norm{i}"]
        sd.update({f"layers.{idx + 1}.weight": p[f"norm{i}"]["scale"],
                   f"layers.{idx + 1}.bias": p[f"norm{i}"]["bias"],
                   f"layers.{idx + 1}.running_mean": bn["mean"],
                   f"layers.{idx + 1}.running_var": bn["var"],
                   f"layers.{idx + 1}.num_batches_tracked": np.asarray(0, np.int64)})
    sd["layers.8.weight"] = np.asarray(p["out"]["kernel"]).T[..., None]
    sd["layers.8.bias"] = p["out"]["bias"]
    mlp.load_state_dict(to_torch(sd), strict=True)
    _close(mlp.train()(torch.from_numpy(x)), want, BN_TOL, "output")
    for i, idx in ((0, 1), (1, 5)):
        _close(mlp.layers[idx].running_mean, mutated["batch_stats"][f"norm{i}"]["mean"], BN_TOL)
        _close(mlp.layers[idx].running_var, mutated["batch_stats"][f"norm{i}"]["var"], BN_TOL)


def test_dropout_draws_from_the_generator():
    mlp = reset_parameters(GenericMLP(8, (16,), 4, dropout=0.5), torch.Generator().manual_seed(0))
    x = torch.ones(64, 8)
    a = mlp(x, torch.Generator().manual_seed(3))
    b = mlp(x, torch.Generator().manual_seed(3))
    c = mlp(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(mlp.eval()(x, torch.Generator().manual_seed(4)), mlp(x))


# ---------------------------------------------------------------- (c) gIoU


def _boxes(rng, b, k, rotated=True, centre_scale=2.0):
    centers = rng.uniform(-centre_scale, centre_scale, (b, k, 3)).astype(np.float32)
    sizes = rng.uniform(0.3, 2.0, (b, k, 3)).astype(np.float32)
    angles = (rng.uniform(-np.pi, np.pi, (b, k)) if rotated else np.zeros((b, k))).astype(np.float32)
    return box_ops.get_3d_box_batch_np(sizes, angles, centers).astype(np.float32)


def _giou_case(case):
    rng = np.random.default_rng(10)
    if case == "random":
        return _boxes(rng, 2, 6), _boxes(rng, 2, 5), np.array([5, 3], np.int32), True
    if case == "axis_aligned":
        return _boxes(rng, 2, 6, False), _boxes(rng, 2, 5, False), np.array([5, 2], np.int32), False
    if case == "disjoint":  # far apart: gIoU is the enclosing term alone
        c1 = _boxes(rng, 1, 4)
        return c1, c1[:, :3] + np.float32(20.0), np.array([3], np.int32), True
    if case == "nested":  # each box inside a larger rotated copy of itself
        centers = rng.uniform(-1, 1, (1, 4, 3)).astype(np.float32)
        sizes = rng.uniform(0.5, 1.0, (1, 4, 3)).astype(np.float32)
        angles = rng.uniform(-np.pi, np.pi, (1, 4)).astype(np.float32)
        inner = box_ops.get_3d_box_batch_np(sizes, angles, centers)
        outer = box_ops.get_3d_box_batch_np(sizes * 1.25, angles + np.float32(0.05), centers)
        return inner.astype(np.float32), outer.astype(np.float32), np.array([4], np.int32), True
    raise ValueError(case)


@pytest.mark.parametrize("case", ["random", "axis_aligned", "disjoint", "nested"])
def test_giou_matches_jax_and_golden(case):
    c1, c2, nums, rotated = _giou_case(case)
    got = generalized_box3d_iou(torch.from_numpy(c1), torch.from_numpy(c2),
                                torch.from_numpy(nums), rotated)
    want = jax.jit(jgiou.generalized_box3d_iou, static_argnums=3)(c1, c2, nums, rotated)
    _close(got, want, GIOU_TOL, "jax")
    _close(got, giou_golden(c1, c2, nums, rotated), GIOU_TOL, "golden")
    if case == "nested":  # each box overlaps its own outer copy most
        g = _np(got)[0]
        assert np.all(np.argmax(g, axis=1) == np.arange(4))
    if case == "disjoint":
        assert np.all(_np(got) < 0)


def test_giou_is_differentiable():
    rng = np.random.default_rng(12)
    c1 = torch.from_numpy(_boxes(rng, 1, 3, centre_scale=0.3)).requires_grad_()
    c2 = torch.from_numpy(_boxes(rng, 1, 2, centre_scale=0.3))
    generalized_box3d_iou(c1, c2, torch.tensor([2])).sum().backward()
    assert torch.isfinite(c1.grad).all() and c1.grad.abs().sum() > 0

    def jax_sum(c):
        return jnp.sum(jgiou.generalized_box3d_iou(c, jnp.asarray(c2.numpy()), jnp.asarray([2])))

    _close(c1.grad, jax.jit(jax.grad(jax_sum))(jnp.asarray(c1.detach().numpy())), GIOU_TOL, "grad")


# ---------------------------------------------------------------- (d) matcher


def _total(cost, per_prop, matched):
    rows = np.nonzero(matched)[0]
    return cost[rows, per_prop[rows]].sum()


@pytest.mark.parametrize("nprop,ngt,nactual", [(16, 8, (5, 0, 8)), (8, 20, (12, 3, 8))])
def test_matcher_matches_jax(nprop, ngt, nactual):
    rng = np.random.default_rng(nprop + ngt)
    cost = rng.standard_normal((3, nprop, ngt)).astype(np.float32)
    nactual = np.asarray(nactual, np.int32)
    got = matcher_assignments(torch.from_numpy(cost)[None], torch.from_numpy(nactual))
    want = jhungarian.matcher_assignments(jnp.asarray(cost), jnp.asarray(nactual))
    np.testing.assert_array_equal(got["per_prop_gt_inds"][0].numpy(), np.asarray(want["per_prop_gt_inds"]))
    np.testing.assert_array_equal(got["proposal_matched_mask"][0].numpy(),
                                  np.asarray(want["proposal_matched_mask"]))


def test_matcher_ties_have_equal_total_cost():
    rng = np.random.default_rng(3)
    cost = np.round(rng.uniform(0, 2, (4, 12, 6)), 0).astype(np.float32)  # many ties
    cost[:, :, 3] = cost[:, :, 1]  # two interchangeable ground-truth columns
    nactual = np.asarray([6, 4, 5, 1], np.int32)
    got = matcher_assignments(torch.from_numpy(cost), torch.from_numpy(nactual))
    want = jax.tree.map(np.asarray, jhungarian.matcher_assignments(jnp.asarray(cost),
                                                                   jnp.asarray(nactual)))
    for b in range(4):
        g_inds, g_mask = got["per_prop_gt_inds"][b].numpy(), got["proposal_matched_mask"][b].numpy()
        assert g_mask.sum() == want["proposal_matched_mask"][b].sum() == nactual[b]
        assert sorted(g_inds[g_mask > 0]) == list(range(nactual[b]))
        assert _total(cost[b], g_inds, g_mask) == pytest.approx(
            _total(cost[b], want["per_prop_gt_inds"][b], want["proposal_matched_mask"][b]), abs=1e-5)


# ---------------------------------------------------------------- (e) losses


ALL_WEIGHTS = dict(loss_giou_weight=2.0, loss_sem_cls_weight=0.5, loss_sem_cls_softmax_weight=0.7,
                   loss_sem_cls_softmax_skip_none_gt_sample_weight=1.0)


def _outputs_near_targets(batch, num_layers, nq, seed):
    """Stacked (L, B, nq, ...) outputs whose boxes lie near the ground truth."""
    rng = np.random.default_rng(seed)
    bp = BoxProcessor(SunrgbdAnonymousConfig())
    b = batch["point_clouds"].shape[0]
    shape = (num_layers, b, nq)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    pick = rng.integers(0, 3, shape)
    centers = batch["gt_box_centers"][np.arange(b)[None, :, None], pick] + 0.2 * f(*shape, 3)
    sizes = rng.uniform(0.3, 1.8, shape + (3,)).astype(np.float32)
    angle_logits, residual, cls_logits = f(*shape, 12), 0.3 * f(*shape, 12), f(*shape, 2)
    t = torch.from_numpy
    dims = (t(batch["point_cloud_dims_min"]), t(batch["point_cloud_dims_max"]))
    angle = bp.compute_predicted_angle(t(angle_logits), t(residual) * np.pi / 12)
    probs = torch.softmax(t(cls_logits), -1)
    outs = {
        "sem_cls_logits": cls_logits, "sem_cls_prob": probs[..., :-1],
        "objectness_prob": 1 - probs[..., -1],
        "center_normalized": box_ops.shift_scale_points(t(centers).flatten(0, 1).reshape(
            num_layers, b, nq, 3).permute(1, 0, 2, 3).reshape(b, num_layers * nq, 3), dims
        ).reshape(b, num_layers, nq, 3).permute(1, 0, 2, 3),
        "box_corners": bp.box_parametrization_to_corners(t(centers), t(sizes), angle),
        "angle_logits": angle_logits, "angle_residual_normalized": residual,
        "size_normalized": rng.uniform(0, 1, shape + (3,)),
    }
    return {k: np.ascontiguousarray(_np(v), dtype=np.float32) for k, v in outs.items()}


@pytest.mark.parametrize("empty_scene", [False, True])
def test_every_loss_matches_jax(empty_scene):
    batch = _scenes(3, seed=4)
    if empty_scene:  # a scene without ground truth: the skip-none-gt normalizer
        for k in ("gt_box_present", "gt_box_corners", "gt_box_centers_normalized",
                  "gt_box_sizes_normalized", "gt_angle_class_label", "gt_angle_residual_label"):
            batch[k][1] = 0
    outs = _outputs_near_targets(batch, num_layers=3, nq=16, seed=5)
    args = _args(**ALL_WEIGHTS)
    targets = {k: batch[k] for k in JAX_TARGET_KEYS if k in batch}
    jcrit = jcriterion.build_criterion(args, JaxConfig())
    want_total, want = jax.jit(lambda o, t: jcrit(o, t))(outs, targets)
    crit = build_criterion(args, SunrgbdAnonymousConfig())
    total, got = crit({k: torch.from_numpy(v) for k, v in outs.items()},
                      {k: torch.from_numpy(v) for k, v in targets.items()})
    assert set(got) == set(want)
    assert {"loss_giou", "loss_giou_0", "loss_giou_1", "loss_sem_cls", "loss_angle_reg_1",
            "loss_cardinality_0"} <= set(got)
    for key in want:
        _close(got[key], want[key], LOSS_TOL, key)
    _close(total, want_total, LOSS_TOL, "total")
    assert crit.last_assignments["proposal_matched_mask"].sum() > 0


def test_unported_losses_raise():
    """A weight for these two losses raised until the rest of the criterion
    was ported: each now builds, is active, and gives its term on every
    layer (held against the JAX package in
    tests/test_torch_port_criterion_rest.py)."""
    batch = _scenes(2, seed=4)
    outs = {k: torch.from_numpy(v) for k, v in _outputs_near_targets(batch, 3, 16, 5).items()}
    targets = {k: torch.from_numpy(batch[k]) for k in JAX_TARGET_KEYS if k in batch}
    for name in ("loss_sem_focal_cls",
                 "loss_sem_cls_softmax_skip_none_gt_sample_en_discovery_objectness"):
        crit = build_criterion(_args(**{name + "_weight": 1.0}), SunrgbdAnonymousConfig())
        assert crit._active(name)
        _, losses = crit(outs, targets)
        assert {name, name + "_0", name + "_1"} <= set(losses)
        assert all(torch.isfinite(losses[k]) for k in (name, name + "_0", name + "_1"))


# ---------------------------------------------------------------- (f) LR + optimizer


@pytest.mark.parametrize("scheduler", ["cosine", "constant"])
def test_lr_schedule_matches_jax(scheduler):
    args = _args(warm_lr_epochs=2, max_epoch=6, lr_scheduler=scheduler)
    steps = [0, 1, 19, 20, 21, 33, 59, 60]  # 10 iterations an epoch: warm-up ends at step 20
    host, jhost = make_lr_schedule(args, 10, host=True), joptimizer.make_lr_schedule(args, 10, host=True)
    dev, jdev = make_lr_schedule(args, 10), joptimizer.make_lr_schedule(args, 10)
    for s in steps:
        assert host(s) == jhost(s), s
        # float32 on both sides: within 1e-6 of base_lr (the cosine tail is a
        # difference of nearly equal terms)
        np.testing.assert_allclose(float(dev(s)), float(jdev(s)), rtol=0,
                                   atol=OPT_RTOL * args.base_lr, err_msg=str(s))
    assert host(20) == pytest.approx(args.base_lr)  # the inclusive boundary


@pytest.fixture(scope="module")
def tiny_flax():
    """The tiny baseline detector (no text head, dropout 0) in flax,
    perturbed, and the port loaded from it."""
    batch = _scenes(2)
    jm = jmodel.CoDA3DETR(dataset_config=JaxConfig(), with_text_head=False, **NO_DROPOUT, **TINY)
    fwd_keys = ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")
    variables = jax.jit(lambda r, b: jm.init(r, b, train=False))(
        jax.random.PRNGKey(0), {k: batch[k] for k in fwd_keys})
    variables = _perturb(variables, 0)
    return dict(batch=batch, jm=jm, variables=variables)


def _port_model(variables, **kw):
    v = variables
    sd = state_dict_from_flax(v["params"], v["batch_stats"], v["constants"])
    tm = CoDA3DETR(SunrgbdAnonymousConfig(), with_text_head=False, **NO_DROPOUT, **TINY, **kw)
    tm.load_state_dict(to_torch(sd), strict=True)
    return tm


@pytest.mark.parametrize("filter_biases_wd,clip", [(False, 0.1), (True, 0.1), (False, 1e6)])
def test_optimizer_update_matches_optax(tiny_flax, filter_biases_wd, clip):
    args = _args(filter_biases_wd=filter_biases_wd, clip_gradient=clip)
    params = tiny_flax["variables"]["params"]
    tx, _ = joptimizer.build_optimizer(args, params, 600)
    opt_state = tx.init(params)
    tm = _port_model(tiny_flax["variables"])
    opt, _ = build_optimizer(args, tm, 600)
    names = [n for n, _ in tm.named_parameters()]
    @jax.jit
    def jax_update(grads, opt_state, jparams, lr):
        updates, opt_state = tx.update(grads, opt_state, jparams)
        return jax.tree.map(lambda p, u: p - lr * u, jparams, updates), opt_state

    rng = np.random.default_rng(7)
    jparams = params
    stats = tiny_flax["variables"]["batch_stats"]
    port = dict(tm.named_parameters())
    for lr in (1e-2, 3e-3, 1e-2):
        grads = jax.tree.map(lambda x: rng.standard_normal(np.shape(x)).astype(np.float32), params)
        for name, g in grads_from_flax(grads).items():
            port[name].grad = torch.from_numpy(np.array(g))
        # both sides start the step from the same parameters
        old = state_dict_from_flax(jparams, stats, {})
        with torch.no_grad():
            for name in names:
                port[name].copy_(torch.from_numpy(np.array(old[name])))
        jparams, opt_state = jax_update(grads, opt_state, jparams, lr)
        opt.step(lr)
        want = state_dict_from_flax(jparams, stats, {})
        for name in names:
            new, want_new = _np(port[name]), np.asarray(want[name])
            # 1e-6 of the update, plus the f32 rounding of p + update
            tol = OPT_RTOL * np.abs(want_new - old[name]).max() + np.spacing(np.abs(want_new))
            assert np.all(np.abs(new - want_new) <= tol), name


# ---------------------------------------------------------------- (g) whole step


@pytest.fixture(scope="module")
def jax_step(tiny_flax):
    """Loss, loss dict, gradients and updated BatchNorm statistics of one
    JAX training step (the forward in train mode and the criterion)."""
    jm, v, batch = tiny_flax["jm"], tiny_flax["variables"], tiny_flax["batch"]
    crit = jcriterion.build_criterion(_args(), JaxConfig())
    jbatch = {k: jnp.asarray(batch[k]) for k in ("point_clouds", "point_cloud_dims_min",
                                                  "point_cloud_dims_max", *JAX_TARGET_KEYS)
              if k in batch}

    def loss_fn(params):
        out, mutated = jm.apply({"params": params, "batch_stats": v["batch_stats"],
                                 "constants": v["constants"]}, jbatch, train=True,
                                rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        loss, loss_dict = crit(out, {k: jbatch[k] for k in JAX_TARGET_KEYS if k in jbatch})
        return loss, (loss_dict, mutated["batch_stats"])

    (loss, (loss_dict, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    return jax.tree.map(np.asarray, dict(loss=loss, loss_dict=loss_dict, stats=stats, grads=grads))


@pytest.fixture(scope="module")
def port_step(tiny_flax):
    _assert_no_boundary_flip(tiny_flax["batch"], TINY["preenc_npoints"])
    tm = _port_model(tiny_flax["variables"])
    args = _args()
    opt, sched = build_optimizer(args, tm, 600)
    step = make_train_step(tm, build_criterion(args, SunrgbdAnonymousConfig()), opt, sched)
    batch = {k: torch.from_numpy(v) for k, v in tiny_flax["batch"].items()}
    metrics = step(batch, torch.Generator().manual_seed(0))
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    return dict(model=tm, metrics=metrics, grads=grads)


def test_train_step_loss_matches_jax(jax_step, port_step):
    got = port_step["metrics"]
    _close(got["loss"], jax_step["loss"], STEP_LOSS_TOL, "loss")
    assert set(got) == set(jax_step["loss_dict"]) | {"loss", "lr"}
    for key, want in jax_step["loss_dict"].items():
        _close(got[key], want, STEP_LOSS_TOL, key)
    assert float(got["lr"]) == pytest.approx(1e-6)  # the schedule's step 0


def test_train_step_gradients_match_jax(jax_step, port_step):
    want = grads_from_flax(jax_step["grads"])
    got = port_step["grads"]
    assert set(got) == set(want)
    norm = np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2) for g in want.values()))
    assert norm > 0
    for name, w in want.items():
        err = np.abs(_np(got[name]) - np.asarray(w)).max() / norm
        assert err <= GRAD_TOL, (name, err)


def test_train_step_batchnorm_statistics_match_jax(jax_step, tiny_flax, port_step):
    v = tiny_flax["variables"]
    want = state_dict_from_flax(v["params"], jax_step["stats"], v["constants"])
    got = port_step["model"].state_dict()
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * (3 + 3 + 2 * 5)  # SA 3, enc-to-dec 3, five heads of 2
    for name in names:  # 1e-5 of the statistic's size where it exceeds 1
        _close(got[name], want[name], BN_TOL * max(1.0, np.abs(want[name]).max()), name)
    # the statistics did move: training mode updated them
    moved = max(np.abs(_np(got[n]) - np.asarray(sd_v)).max()
                for n, sd_v in state_dict_from_flax(v["params"], v["batch_stats"], {}).items()
                if n in names)
    assert moved > 1e-3


def test_train_one_epoch_aborts_on_a_non_finite_loss():
    calls = []

    def fake_step(batch, generator):
        calls.append(batch["lr"])
        return {"loss": torch.tensor(float("nan") if len(calls) == 3 else 1.0)}

    with pytest.raises(SystemExit):
        train_one_epoch(fake_step, [{}] * 6, log_every=4, lr_fn=lambda it: 0.1 * it, log=lambda s: None)
    assert len(calls) == 5  # read back at iterations 0 and 4: the abort comes at 4
    assert train_one_epoch(fake_step, [{}] * 2, lr_fn=lambda it: 0.0, log=lambda s: None)["loss"] == 1.0


# ---------------------------------------------------------------- (h) autograd Functions


def test_group_points_function_gradcheck():
    rng = np.random.default_rng(2)
    feats = torch.from_numpy(rng.standard_normal((2, 9, 3))).requires_grad_()
    idx = torch.from_numpy(rng.integers(0, 9, (2, 4, 5)).astype(np.int32))  # repeats: the add
    assert torch.autograd.gradcheck(lambda f: GroupPoints.apply(f, idx), (feats,))
    f32 = feats.detach().float().requires_grad_()
    g = torch.from_numpy(rng.standard_normal((2, 4, 5, 3)).astype(np.float32))
    (GroupPoints.apply(f32, idx) * g).sum().backward()
    ref = f32.detach().clone().requires_grad_()
    (group_points_plain(ref, idx) * g).sum().backward()
    torch.testing.assert_close(f32.grad, ref.grad, rtol=0, atol=1e-6)


@pytest.mark.parametrize("radius", [0.0, 0.6])
def test_masked_attention_function_gradcheck(radius):
    rng = np.random.default_rng(3)
    b, h, sq, skv, d = 1, 2, 5, 7, 4
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((b, h, sq, d), (b, h, d, skv), (b, h, skv, d)))
    kxyz = rng.uniform(-1, 1, (b, skv, 3))
    qxyz = torch.from_numpy(kxyz[:, :sq].copy())
    kxyz_t = torch.from_numpy(np.ascontiguousarray(kxyz.transpose(0, 2, 1)))
    fn = lambda q, k, v: MaskedAttention.apply(q, k, v, qxyz, kxyz_t, radius)
    assert torch.autograd.gradcheck(fn, (q, k, v))
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    plain = [t.detach().float().requires_grad_() for t in (q, k, v)]
    g = torch.from_numpy(rng.standard_normal((b, h, sq, d)).astype(np.float32))
    (MaskedAttention.apply(*leaves, qxyz.float(), kxyz_t.float(), radius) * g).sum().backward()
    (masked_attention_plain(*plain, qxyz.float(), kxyz_t.float(), radius) * g).sum().backward()
    for a, c in zip(leaves, plain):
        torch.testing.assert_close(a.grad, c.grad, rtol=0, atol=1e-6)


def _lowbias32_np(x):
    x = np.asarray(x, np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def test_attention_dropout_matches_flax_semantics():
    """flax MHA's broadcast dropout: one (Sq, Skv) keep mask for every batch
    row and head, kept softmax weights scaled by 1 / (1 - rate)."""
    rng = np.random.default_rng(4)
    b, h, sq, skv, d, rate = 2, 3, 48, 80, 8, 0.1
    q = torch.from_numpy((rng.standard_normal((b, h, sq, d)) / np.sqrt(d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, h, d, skv)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, h, skv, d)).astype(np.float32))
    seed = torch.tensor(123456789012, dtype=torch.int64)
    keep = attention_keep_mask(seed, sq, skv, rate)
    ij = np.arange(sq * skv, dtype=np.uint32)
    want_keep = _lowbias32_np(_lowbias32_np(np.uint32(123456789012 & 0xFFFFFFFF)) ^ ij) >= np.uint32(
        int(rate * 2 ** 32))
    np.testing.assert_array_equal(keep.numpy(), want_keep.reshape(sq, skv))
    assert abs(float(keep.float().mean()) - (1 - rate)) < 0.02
    got = masked_attention(q, k, v, dropout=rate, seed=seed)
    weights = torch.softmax(q @ k, dim=-1) * keep / np.float32(1 - rate)
    torch.testing.assert_close(got, weights @ v, rtol=0, atol=1e-6)
    assert torch.equal(got, masked_attention_plain(q, k, v, None, None, 0.0, dropout=rate, seed=seed))
    other = masked_attention(q, k, v, dropout=rate, seed=seed + 1)
    assert not torch.equal(got, other)
    with pytest.raises(ValueError):
        masked_attention(q, k, v, dropout=rate)  # no seed


def test_attention_dropout_function_gradcheck():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((1, 2, 6, 4), (1, 2, 4, 9), (1, 2, 9, 4)))
    seed = torch.tensor(7, dtype=torch.int64)
    fn = lambda q, k, v: MaskedAttention.apply(q, k, v, None, None, 0.0, 0.3, seed)
    assert torch.autograd.gradcheck(fn, (q, k, v))


def test_train_mode_dropout_draws_from_the_generator(tiny_flax):
    """With the shipped rates, the train forward is a function of the
    generator's seed; at eval it draws nothing."""
    tm = _port_model(tiny_flax["variables"]).train()
    for module in tm.modules():  # the shipped rates: heads 0.3, encoder and decoder 0.1
        if hasattr(module, "dropout") and isinstance(module.dropout, float):
            module.dropout = 0.1
        if type(module).__name__ == "Dropout":
            module.rate = 0.3
    batch = {k: torch.from_numpy(v) for k, v in tiny_flax["batch"].items()}
    out = lambda seed: tm(batch, generator=torch.Generator().manual_seed(seed))["sem_cls_logits"]
    with torch.no_grad():
        a, b, c = out(0), out(0), out(1)
        assert torch.equal(a, b) and not torch.equal(a, c)
        tm.eval()
        assert torch.equal(tm(batch)["sem_cls_logits"],
                           tm(batch, generator=torch.Generator())["sem_cls_logits"])


# ---------------------------------------------------------------- (i) fused ball query + group


def _fused_inputs(seed, b, n, m, scale):
    rng = np.random.default_rng(seed)
    xyz = (rng.standard_normal((b, n, 3)) * scale).astype(np.float32)
    new_xyz = np.concatenate([xyz[:, : m - 2], np.full((b, 2, 3), 50.0, np.float32)], axis=1)
    return xyz, new_xyz  # the last two centres have no hit


@pytest.mark.parametrize("normalize", [False, True])
def test_query_and_group_fused_equals_two_op(monkeypatch, normalize):
    xyz, new_xyz = map(torch.from_numpy, _fused_inputs(1, 2, 300, 33, 0.25))
    monkeypatch.setenv("CODA_BQ_FUSED_GATHER", "0")
    two_op, _ = query_and_group(0.5, 8, xyz, new_xyz, normalize_xyz=normalize)
    monkeypatch.setenv("CODA_BQ_FUSED_GATHER", "1")
    fused, same = query_and_group(0.5, 8, xyz, new_xyz, normalize_xyz=normalize)
    assert fused is same
    assert torch.equal(fused, two_op)


@pytest.mark.parametrize("b,n,m,radius,nsample,scale", [(2, 300, 33, 0.5, 8, 0.25),
                                                         (1, 300, 17, 0.15, 8, 1.0)])
def test_fused_plain_path_matches_pallas(monkeypatch, b, n, m, radius, nsample, scale):
    xyz, new_xyz = _fused_inputs(13, b, n, m, scale)
    idx, grouped = ball_query_group(radius, nsample, torch.from_numpy(xyz), torch.from_numpy(new_xyz))
    want_idx = ball_query_golden(radius, nsample, xyz, new_xyz)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(grouped[:, -2:].numpy(), np.broadcast_to(xyz[:, None, None, 0],
                                                                             (b, 2, nsample, 3)))
    monkeypatch.setattr(jbq, "_NC", 128)
    monkeypatch.setattr(jbqs, "_BLK", 128)
    monkeypatch.setattr(jbqs, "_WS", 128)
    monkeypatch.setattr(jbqs, "_TM", 8)
    monkeypatch.setattr(jbqs, "_LANE", 8)
    with pltpu.force_tpu_interpret_mode():
        j_idx, j_grouped = jax.tree.map(np.asarray, jbqs.ball_query_and_group_sorted(
            radius, nsample, jnp.asarray(xyz), jnp.asarray(new_xyz)))
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    np.testing.assert_array_equal(grouped.numpy(), j_grouped)
