"""The bf16 detector's training (--compute_dtype bf16) in the PyTorch port, on the CPU.

The tiny CoDA detector of tests/test_torch_port_model.py (TINY) with flax's
perturbed weights, dropout 0, 2 scenes of 1,024 points with images (the
stage-1 test's), in bf16 on both sides.  The JAX package trains it with
flax's stock bf16 attention; the port keeps kernel D-bf16's numerics (fp32
scores and softmax, p rounded to bf16) in the encoder and the decoder's
cross-attention.  Checked, each tolerance with its reason:

  * the plain bf16 dropout: flax's multiplier bf16(1) / bf16(1 - rate)
    (1.109375 at 0.1) on p rounded to bf16, the product rounded again, 0
    where kernel D's hash drops; split keys drop the same pairs;
  * `MaskedAttention` in bf16: its backward equals autograd of the plain
    bf16 path bit for bit (it is that recompute), dropout and split on;
  * one baseline step (scripts/coda_baseline_sunrgbd.sh's criterion) and
    one fused stage-1 step (coda_sunrgbd_stage1.sh's, the bf16 CLIP tower)
    against the JAX package's bf16 steps, one JAX compile each.  Where the
    two matchers' costs differ by bf16 rounding an assignment may differ:
    both sides then take the JAX step's assignments (the port's matcher on
    the JAX step's outputs), provided the port's own is no cheaper than
    them by more than TIE_COST under the port's costs; the rows concerned
    are counted and printed.  The flax-versus-D-bf16 rounding is measured:
    the same port step with flax's bf16 attention numerics in place of
    D-bf16's (bf16 scores, a bf16 softmax, bf16 PV sums) is held at the
    tighter FLAX_* tolerances, and the step as it runs at the STEP_*
    ones; both errors are printed.  Gradients are compared as their
    largest error over the global gradient norm, BatchNorm's running
    statistics by their largest error over the statistic's size.  Also
    the difference's norm over the gradient's: bf16 against fp32 is far
    (0.32) by that measure, BatchNorm's training backward cancelling most of
    each term, and the steps are held to lie no farther apart than that;
  * the port's bf16 step against its fp32 step on the same weights;
  * --remat equal to no remat bit for bit, with every dropout on;
  * `main --compute_dtype bf16`: stage 1's and stage 2's training for one
    epoch, and each mode flag (the baseline's training through main:
    tests/test_torch_port_bf16.py::test_cli_bf16_detector_only_at_eval).
"""

import math
import os
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
from coda_neurips2023_tpu.engine import _TARGET_KEYS as JAX_TARGET_KEYS
from coda_neurips2023_tpu.models import clip as jclip
from coda_neurips2023_tpu.models import model_3detr as jmodel
from coda_neurips2023_tpu.stages import StageContext as JaxStageContext

from coda_neurips2023_tpu_torch import main as tmain
from coda_neurips2023_tpu_torch.criterion import build_criterion
from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
from coda_neurips2023_tpu_torch.engine import make_train_step
from coda_neurips2023_tpu_torch.models import transformer
from coda_neurips2023_tpu_torch.models.helpers import flax_softmax
from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
from coda_neurips2023_tpu_torch.ops.masked_attention import (
    attention_keep_mask,
    bf16_dropout_multiplier,
    masked_attention,
    masked_attention_plain,
    masked_attention_split_plain,
)
from coda_neurips2023_tpu_torch.optimizer import build_optimizer
from coda_neurips2023_tpu_torch.stages import StageContext
from coda_neurips2023_tpu_torch.utils.weights import grads_from_flax, state_dict_from_flax, to_torch

from test_torch_port_clip import TINY_CLIP, _port_clip
from test_torch_port_model import TINY, _assert_no_boundary_flip, _build
from test_torch_port_stage1 import CROP, N_SEL, STAGE1_ARGS, _image_scenes, _jax_sel
from test_torch_port_train import BASELINE_ARGS
from torch_one_thread import one_intra_op_thread  # noqa: F401

BF16 = torch.bfloat16
NO_DROPOUT = dict(mlp_dropout=0.0, enc_dropout=0.0, dec_dropout=0.0)
FWD_KEYS = ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")
# a (layer, scene)'s matching cost sums up to 9 matched pairs of terms
# weighted up to 5, each a probability, distance or gIoU carrying bf16's
# relative rounding of 2^-9 through the heads: about 5e-2 in all
TIE_COST = 5e-2
# the total loss, and each term, relative to the total: measured 7.5e-4
# (baseline) and 4.3e-4 (stage 1) with D-bf16, 5.6e-4 and 1.1e-4 with
# flax's bf16 attention numerics; bf16 rounds each Dense product, so a term
# moves by a few 2^-9 of its size where the two frameworks sum in other
# orders
STEP_LOSS_RTOL, FLAX_LOSS_RTOL = 2e-3, 1.5e-3
# the gradients' largest error over their global norm: measured 2.07e-2
# (baseline) and 1.94e-2 (stage 1) with D-bf16, 1.82e-2 and 1.67e-2 with
# flax's numerics, so the attention's rounding adds ~2e-3.  The largest are
# the pre-encoder's conv weights (printed): its bf16 conv outputs tie
# within a neighbourhood of 64 at bf16's 8 bits, the max-pool shares the
# gradient among the tied ones, and a product that lands one ulp off on
# one side makes or breaks a tie, which moves a whole share
STEP_GRAD_TOL = FLAX_GRAD_TOL = 4e-2
# the norm of the gradients' difference over the gradient's norm: measured
# 0.287 / 0.284 (baseline / stage 1, D-bf16), 0.266 / 0.214 (flax's
# numerics), and the port's bf16 step against its own fp32 step 0.320:
# spread over every element, where BatchNorm's training-mode backward
# (dy less its mean and its projection on the normalized input) cancels
# most of each term, so the terms' bf16 rounding (2^-9) is a large share of
# what is left.  The bound: no farther from the JAX step than bf16 lies from
# fp32, with a margin
GRAD_NORM_RTOL = 0.4
# BatchNorm's running statistics, over max(1, the statistic's size):
# measured 2.97e-3, the statistics of bf16 conv outputs (2^-8 = 3.9e-3 a
# bf16 ulp at 1)
BN_RTOL = 8e-3
# the bf16 step against the fp32 step on the same weights: loss measured
# 6.9e-5 relative, gradients 2.31e-2 of their norm (the pre-encoder as
# above), the difference's norm as above; loss_cardinality, a log-only count of argmax classes, is not
# compared (a flipped argmax moves it by 1 / B)
FP32_LOSS_RTOL, FP32_GRAD_TOL = 2e-3, 4e-2


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# ------------------------------------------------------------ the attention


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.05])
def test_bf16_dropout_multiplier_is_flax(rate):
    """flax's dot_product_attention_weights at dtype bf16:
    multiplier = keep.astype(bf16) / jnp.asarray(keep_prob, dtype=bf16)."""
    keep_prob = 1.0 - rate
    want = jnp.asarray(True).astype(jnp.bfloat16) / jnp.asarray(keep_prob, dtype=jnp.bfloat16)
    assert bf16_dropout_multiplier(rate) == float(want)
    if rate == 0.1:
        assert bf16_dropout_multiplier(rate) == 1.109375 != float(np.float32(1 / 0.9))


def _qkv(seed, b, h, sq, skv, d, grad=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(BF16)
    q, k, v = f(b, h, sq, d) / math.sqrt(d), f(b, h, d, skv), f(b, h, skv, d)
    return [t.requires_grad_(grad) for t in (q, k, v)]


def test_plain_bf16_dropout_order():
    """p rounded to bf16, kept where the hash keeps, times the multiplier,
    the product rounded again; the split-key version drops the same pairs."""
    q, k, v = _qkv(0, 2, 2, 40, 37, 16)
    seed, rate = torch.tensor(1234), 0.1
    got = masked_attention_plain(q, k, v, None, None, 0.0, "bfloat16", rate, seed)
    scores = torch.matmul(q.float(), k.float())
    p = torch.softmax(scores, -1).to(BF16)
    keep = attention_keep_mask(seed, 40, 37, rate)
    assert 0.8 < keep.float().mean() < 0.95
    dropped = torch.where(keep, (p.float() * 1.109375).to(BF16), torch.zeros((), dtype=BF16))
    want = torch.matmul(dropped.float(), v.float()).to(BF16)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-2)  # the two softmaxes' order
    # a query whose every key is dropped but one gives that key's value alone
    one_v = torch.zeros_like(v)
    one_v[..., 5, :] = 1.0
    out = masked_attention_plain(q, k, one_v, None, None, 0.0, "bfloat16", rate, seed)
    zero = ~keep[:, 5]
    assert torch.equal(out[:, :, zero], torch.zeros_like(out[:, :, zero]))
    split = masked_attention_split_plain(q, k, one_v, None, None, 0.0, 16, "bfloat16", rate, seed)
    assert torch.equal(split[:, :, zero], torch.zeros_like(split[:, :, zero]))
    assert (split[:, :, ~zero] != 0).all()


@pytest.mark.parametrize("radius", [0.0, 1.5])
def test_masked_attention_bf16_backward_is_the_plain_autograd(radius):
    q, k, v = _qkv(1, 2, 2, 24, 24, 16, grad=True)
    rng = np.random.default_rng(2)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (2, 24, 3)).astype(np.float32))
    qxyz, kxyz_t = (xyz, xyz.transpose(1, 2).contiguous()) if radius else (None, None)
    seed = torch.tensor(77)
    out = masked_attention(q, k, v, qxyz, kxyz_t, radius, "bfloat16", 0.2, seed)
    assert out.dtype == BF16 and out.grad_fn.name().endswith("MaskedAttentionBackward")
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32)).to(BF16)
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = masked_attention_plain(q, k, v, qxyz, kxyz_t, radius, "bfloat16", 0.2, seed)
    assert torch.equal(out, ref)
    want = torch.autograd.grad(ref, (q, k, v), g)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == BF16
        assert torch.equal(a, b), name
        assert a.abs().sum() > 0, name


# ------------------------------------------------------------ the steps


def _flax_bf16_attention(q, k, v, qxyz=None, kxyz_t=None, radius=0.0, compute_dtype="float32",
                         dropout=0.0, seed=None):
    """flax's stock bf16 attention numerics in place of D-bf16's (no
    dropout): bf16 scores, flax's bf16 softmax, a bf16 PV product."""
    assert dropout == 0.0 and q.dtype == BF16
    return torch.matmul(flax_softmax(torch.matmul(q, k)), v)


class _TieMatcher:
    """The port's matcher, returning `want`'s assignments (L, B, nq) where
    the port's own differ, after checking that the port's costs of the two
    differ by at most TIE_COST on each such (layer, scene); `rows` counts
    them and `excess` keeps the largest cost difference."""

    def __init__(self, matcher, want):
        self.matcher, self.want = matcher, want
        self.rows, self.excess = 0, 0.0

    def _total(self, cost, a):
        sel = torch.gather(cost, -1, a["per_prop_gt_inds"][..., None])[..., 0]
        return (sel * a["proposal_matched_mask"]).sum(-1)  # (L, B)

    def __call__(self, outputs, targets):
        own = self.matcher(outputs, targets)
        m = self.matcher
        index = targets["gt_box_sem_cls_label"].long()[None, :, None, :].expand(
            *outputs["sem_cls_prob"].shape[:3], -1)
        cost = (m.cost_class * -torch.gather(outputs["sem_cls_prob"], -1, index)
                + m.cost_objectness * -outputs["objectness_prob"][..., None]
                + m.cost_center * outputs["center_dist"] + m.cost_giou * -outputs["gious"]).detach()
        differ = ((own["per_prop_gt_inds"] != self.want["per_prop_gt_inds"])
                  | (own["proposal_matched_mask"] != self.want["proposal_matched_mask"])).any(-1)
        excess = (self._total(cost, self.want) - self._total(cost, own))[differ]
        self.rows = int(differ.sum())
        self.excess = float(excess.max()) if self.rows else 0.0
        return self.want


@pytest.fixture(scope="module")
def tiny():
    """The tiny CoDA detector (dropout 0) in flax, perturbed, its bf16 twin
    in flax, the 2 scenes with images, the stage-1 contexts from one bf16
    CLIP tower."""
    batch = _image_scenes()
    pts = {k: batch[k] for k in FWD_KEYS}
    _assert_no_boundary_flip(batch, TINY["preenc_npoints"])
    _, variables, sd, _ = _build(dict(TINY, **NO_DROPOUT), pts)
    jm = jmodel.CoDA3DETR(dataset_config=JaxConfig(), compute_dtype=jnp.bfloat16, **NO_DROPOUT,
                          **TINY)
    args = types.SimpleNamespace(**dict(STAGE1_ARGS, compute_dtype="bf16"))
    jctx = JaxStageContext(args, JaxConfig(), clip_model=jclip.CLIP(dtype=jnp.bfloat16,
                                                                    **TINY_CLIP), crop_size=CROP)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), jctx.clip_variables["params"])
    tctx = StageContext(args, SunrgbdAnonymousConfig(), clip_model=_port_clip(TINY_CLIP, params),
                        crop_size=CROP, device="cpu")
    return dict(batch=batch, variables=variables, sd=sd, jm=jm, args=args, jctx=jctx, tctx=tctx)


def _port_model(tiny, dtype=BF16, **kw):
    tm = CoDA3DETR(SunrgbdAnonymousConfig(), compute_dtype=dtype, **dict(TINY, **NO_DROPOUT, **kw))
    tm.load_state_dict(to_torch(tiny["sd"]), strict=True)
    return tm.train()


def _targets(batch):
    return {k: jnp.asarray(batch[k]) for k in JAX_TARGET_KEYS if k in batch}


@pytest.fixture(scope="module")
def jax_steps(tiny):
    """The JAX package's bf16 baseline step (loss, gradients, BatchNorm
    statistics, outputs) and bf16 fused stage-1 step (metrics, gradients)."""
    v, jm, batch = tiny["variables"], tiny["jm"], tiny["batch"]
    crit = jcriterion.build_criterion(types.SimpleNamespace(**BASELINE_ARGS), JaxConfig())
    jbatch = {k: jnp.asarray(batch[k]) for k in FWD_KEYS}

    def loss_fn(params):
        out, mutated = jm.apply({"params": params, "batch_stats": v["batch_stats"],
                                 "constants": v["constants"]}, jbatch, train=True,
                                rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        loss, loss_dict = crit(out, _targets(batch))
        return loss, (loss_dict, mutated["batch_stats"], out)

    (loss, (loss_dict, stats, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    baseline = jax.tree.map(np.asarray, dict(loss=loss, loss_dict=loss_dict, stats=stats,
                                             grads=grads, out=out))
    keep_grads = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))
    jctx = tiny["jctx"]
    step = jctx.make_fused_train_step(jm, jcriterion.build_criterion(tiny["args"], JaxConfig()),
                                      keep_grads, lr_schedule=lambda s: 0.0)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], constants=v["constants"],
                       opt_state=keep_grads.init(v["params"]))
    rng = jax.random.PRNGKey(5)
    new_state, metrics = step(state, {k: jnp.asarray(x) for k, x in batch.items()}, rng)
    sel = _jax_sel(jax.random.fold_in(jax.random.fold_in(rng, 0), 7), 2, TINY["nqueries"], N_SEL)
    stage1 = dict(metrics=jax.tree.map(np.asarray, metrics),
                  grads=jax.tree.map(np.asarray, new_state.opt_state), sel=sel)
    return dict(baseline=baseline, stage1=stage1)


@pytest.fixture(scope="module")
def jax_assignments(tiny, jax_steps):
    """The port's matcher on the JAX bf16 step's outputs: the JAX step's
    assignments (the matchers are held equal in tests/test_torch_port_train.py)."""
    crit = build_criterion(types.SimpleNamespace(**BASELINE_ARGS), SunrgbdAnonymousConfig())
    out = {k: torch.from_numpy(np.asarray(v, np.float32))
           for k, v in jax_steps["baseline"]["out"].items()}
    targets = {k: torch.from_numpy(tiny["batch"][k]) for k in JAX_TARGET_KEYS if k in tiny["batch"]}
    with torch.no_grad():
        crit(out, targets)
    return crit.last_assignments


def _run_step(tiny, want_assign, dtype=BF16, stage1=False, attention=None, monkeypatch=None,
              sel=None):
    """One port step (baseline, or with `stage1` the fused stage-1 step):
    (metrics, gradients, model, tie matcher)."""
    if attention is not None:
        monkeypatch.setattr(transformer, "masked_attention", attention)
    tm = _port_model(tiny, dtype)
    args = tiny["args"] if stage1 else types.SimpleNamespace(**BASELINE_ARGS)
    crit = build_criterion(args, SunrgbdAnonymousConfig())
    crit.matcher = tie = _TieMatcher(crit.matcher, want_assign)
    opt, sched = build_optimizer(args, tm, 600)
    batch = {k: torch.from_numpy(v) for k, v in tiny["batch"].items()}
    if stage1:
        step = tiny["tctx"].make_fused_train_step(tm, crit, opt, lr_schedule=sched)
        batch["distillation_sel"] = torch.from_numpy(sel.astype(np.int64))
    else:
        step = make_train_step(tm, crit, opt, sched)
    metrics = step(batch, torch.Generator().manual_seed(0))
    if attention is not None:
        monkeypatch.undo()
    return metrics, _grads(tm), tm, tie


def _grads(tm):
    """Each parameter's gradient, fp32 as the parameter (zeros where the
    loss does not reach it: the baseline's criterion leaves the text head)."""
    assert all(p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
               for p in tm.parameters())
    return {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for n, p in tm.named_parameters()}


def _grad_err(got, want):
    """(the largest element's error, the difference's norm), each over the
    global norm of `want`; the three largest errors printed."""
    norm = math.sqrt(sum(float(np.sum(np.asarray(w, np.float64) ** 2)) for w in want.values()))
    assert norm > 0
    diff = {n: _np(got[n]).astype(np.float64) - np.asarray(w) for n, w in want.items()}
    errs = {n: float(np.abs(d).max()) / norm for n, d in diff.items()}
    rel = math.sqrt(sum(float(np.sum(d ** 2)) for d in diff.values())) / norm
    worst = sorted(errs, key=errs.get)[-3:]
    print("  largest gradient errors:", ", ".join(f"{n} {errs[n]:.2e}" for n in worst),
          f"; the difference's norm {rel:.3e} of the gradient's")
    return max(errs.values()), rel


def _loss_err(got, want, skip=()):
    """(total's relative error, each term's largest error over the total)."""
    total = abs(float(want["loss"]))
    terms = max(abs(float(got[k]) - float(w)) for k, w in want.items()
                if k not in ("loss", "lr") and not k.startswith(skip))
    return abs(float(got["loss"]) - float(want["loss"])) / total, terms / total


@pytest.mark.parametrize("which", ["baseline", "stage1"])
def test_bf16_step_matches_jax(tiny, jax_steps, jax_assignments, which, monkeypatch):
    want = jax_steps[which]
    stage1 = which == "stage1"
    sel = jax_steps["stage1"]["sel"]
    want_metrics = want["metrics"] if stage1 else dict(want["loss_dict"], loss=want["loss"])
    want_grads = grads_from_flax(want["grads"])
    errs = {}
    for label, attention in (("flax numerics", _flax_bf16_attention), ("D-bf16", None)):
        metrics, grads, tm, tie = _run_step(tiny, jax_assignments, stage1=stage1,
                                            attention=attention, monkeypatch=monkeypatch, sel=sel)
        assert set(metrics) >= set(want_metrics) - {"lr"}
        loss_err, term_err = _loss_err(metrics, want_metrics)
        grad_err, grad_rel = _grad_err(grads, want_grads)
        errs[label] = (loss_err, term_err, grad_err, grad_rel)
        print(f"{which} bf16 step, {label} attention: loss rel err {loss_err:.3e}, terms "
              f"{term_err:.3e} of the loss, gradients {grad_err:.3e} of their norm; "
              f"{tie.rows} (layer, scene) rows took the JAX assignments (cost excess "
              f"{tie.excess:.3e})")
        assert tie.excess <= TIE_COST
        if not stage1 and attention is None:
            v = tiny["variables"]
            want_sd = state_dict_from_flax(v["params"], want["stats"], v["constants"])
            got_sd = tm.state_dict()
            names = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
            bn = max(float(np.abs(_np(got_sd[n]) - want_sd[n]).max()
                           / max(1.0, np.abs(want_sd[n]).max())) for n in names)
            print(f"{which}: BatchNorm statistics {bn:.3e} of their size")
            assert bn <= BN_RTOL
    flax_loss, flax_terms, flax_grads, flax_rel = errs["flax numerics"]
    loss, terms, grads, rel = errs["D-bf16"]
    assert flax_loss <= FLAX_LOSS_RTOL and flax_terms <= FLAX_LOSS_RTOL
    assert flax_grads <= FLAX_GRAD_TOL and flax_rel <= GRAD_NORM_RTOL
    assert loss <= STEP_LOSS_RTOL and terms <= STEP_LOSS_RTOL and grads <= STEP_GRAD_TOL
    assert rel <= GRAD_NORM_RTOL


def test_bf16_step_matches_the_fp32_step(tiny, jax_assignments):
    bf, bf_grads, _, _ = _run_step(tiny, jax_assignments)
    fp, fp_grads, _, _ = _run_step(tiny, jax_assignments, dtype=torch.float32)
    loss_err, term_err = _loss_err(bf, fp, skip=("loss_cardinality",))
    grad_err, grad_rel = _grad_err(bf_grads, {n: _np(g) for n, g in fp_grads.items()})
    print(f"bf16 step against fp32: loss rel err {loss_err:.3e}, terms {term_err:.3e}, "
          f"gradients {grad_err:.3e}, the difference's norm {grad_rel:.3e}")
    assert loss_err <= FP32_LOSS_RTOL and term_err <= FP32_LOSS_RTOL
    assert grad_err <= FP32_GRAD_TOL and grad_rel <= GRAD_NORM_RTOL


def test_remat_equals_no_remat_bit_for_bit_in_bf16(tiny):
    """Every dropout on (mlp 0.3, encoder and decoder 0.1, attention
    weights through D-bf16's mask): the recompute draws the forward's."""
    results = []
    for remat in (False, True):
        tm = CoDA3DETR(SunrgbdAnonymousConfig(), compute_dtype=BF16, remat=remat, **TINY)
        tm.load_state_dict(to_torch(tiny["sd"]), strict=True)
        args = types.SimpleNamespace(**BASELINE_ARGS)
        opt, sched = build_optimizer(args, tm, 600)
        step = make_train_step(tm, build_criterion(args, SunrgbdAnonymousConfig()), opt, sched)
        batch = {k: torch.from_numpy(v) for k, v in tiny["batch"].items()}
        metrics = step(batch, torch.Generator().manual_seed(11))
        results.append((metrics, _grads(tm),
                        {k: b.clone() for k, b in tm.state_dict().items() if b is not None}))
    (m0, g0, s0), (m1, g1, s1) = results
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert math.isfinite(float(m0["loss"]))


# ------------------------------------------------------------ the CLI

BF16_FLAGS = ["--compute_dtype", "bf16", "--synthetic_num_scenes", "8", "--max_epoch", "1"]


@pytest.fixture(scope="module")
def bf16_cli(tmp_path_factory):
    """`main --compute_dtype bf16` with the stage-1 script's flags, then
    stage 2's from its checkpoint (discovery after each step of epoch 0),
    one epoch of 8 synthetic scenes each (2 steps),
    the tiny CLIP pinned as in tests/test_torch_port_stage2_loop.py; each
    step's loss kept."""
    from coda_neurips2023_tpu_torch import engine
    from test_torch_port_stage2_loop import STAGE2_FLAGS, _install_tiny_clip
    from test_torch_port_train_resume import STAGE1_FLAGS

    tmp = tmp_path_factory.mktemp("bf16_cli")
    mp = pytest.MonkeyPatch()
    mp.setenv("CODA_AP_WORKERS", "0")
    _install_tiny_clip(mp, pinned=True)
    losses = {}
    train_one_epoch = engine.train_one_epoch

    def record(train_step, batches, **kw):
        def step(batch, generator):
            out = train_step(batch, generator)
            losses[run].append(float((out[0] if isinstance(out, tuple) else out)["loss"]))
            return out
        return train_one_epoch(step, batches, **kw)

    mp.setattr(engine, "train_one_epoch", record)
    runs = {
        "stage1": STAGE1_FLAGS,
        "stage2": STAGE2_FLAGS + ["--checkpoint_file", str(tmp / "stage1" / "last_checkpoint")],
    }
    models = {}
    try:
        for run, flags in runs.items():
            losses[run] = []
            models[run] = tmain.main(flags + BF16_FLAGS + ["--checkpoint_dir", str(tmp / run)],
                                     device="cpu")
    finally:
        mp.undo()
    return dict(tmp=tmp, losses=losses, models=models)


@pytest.mark.parametrize("run", ["stage1", "stage2"])
def test_main_trains_in_bf16(bf16_cli, run):
    model, losses = bf16_cli["models"][run], bf16_cli["losses"][run]
    assert model.compute_dtype == BF16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses), losses
    out = bf16_cli["tmp"] / run
    assert {"checkpoint.pth", "last_checkpoint.pth", "metrics.jsonl"} <= set(os.listdir(out))
    if run == "stage2":  # discovery wrote pseudo labels after the bf16 steps
        pseudo = out / "synthetic_pseudo_labels_setting0"
        assert any(np.load(pseudo / n).shape[0] > 0 for n in os.listdir(pseudo))


@pytest.mark.parametrize("mode", tmain._MODE_FLAGS)
def test_main_runs_each_mode_in_bf16(bf16_cli, mode, tmp_path, monkeypatch):
    """Each mode flag through main with a bf16 detector (stage 1's bf16
    checkpoint) and the bf16 tower: it runs and returns its count or
    matrix."""
    from test_torch_port_stage2_loop import _install_tiny_clip
    from test_torch_port_train_resume import STAGE1_FLAGS

    monkeypatch.setenv("CODA_AP_WORKERS", "0")
    _install_tiny_clip(monkeypatch)
    built = {}
    build = tmain.build_everything

    def keep(*a, **kw):
        built.update(build(*a, **kw))
        return built

    monkeypatch.setattr(tmain, "build_everything", keep)
    got = tmain.main(STAGE1_FLAGS + BF16_FLAGS + [
        "--test_only", f"--{mode}", "--checkpoint_dir", str(tmp_path),
        "--test_ckpt", str(bf16_cli["tmp"] / "stage1" / "checkpoint.pth")], device="cpu")
    assert built["model"].compute_dtype == BF16
    assert built["stage_ctx"].clip_model.dtype == BF16
    if mode == "cal_class_only":
        assert got.shape == (46, 46) and got.sum() >= 0
    else:
        assert int(got) >= 0
