"""Set-prediction criterion: matcher and the detection losses (PyTorch).

Counterpart of coda_neurips2023_tpu/criterion.py: the `Matcher` (:101-127),
the `SetCriterion` assembly (:129-193, :685-784) and `build_criterion`
(:786-863), with every loss of the JAX package's registry, in its order:

  the detection losses (loss_sem_cls (focal), loss_sem_cls_softmax,
  loss_sem_cls_softmax_skip_none_gt_sample, loss_angle (cls + reg),
  loss_center, loss_size, loss_giou, and the log-only loss_cardinality);
  the distillation losses on the CLIP crop embeddings of the predicted boxes
  (targets from models/distillation.py): loss_predicted_region_embed_l1, its
  _only_last_layer twin, loss_predicted_region_embed_cos, loss_region_embed;
  loss_contrast_object_text against the text bank (targets
  text_features_clip and logit_scale); stage 2's weak-label losses (targets
  weak_box_cate_label and weak_confidence_weight, CLIP's weak labels);
  the discovery-objectness variants of the softmax loss (target
  discovery_novel (B, nq), or novel_box_judge from the targets or the
  outputs); the seen-class losses on the embedding-to-text-bank logits; and
  the losses of model variants the JAX package does not wire (image-level
  seen classes, the contrastive and prompt losses), each 0 where its output
  key is absent, as in the JAX package.

The JAX package's quirks are kept: its 1e-16 and 1e-32 normalizers where
it has each, `n_matched * nq` in loss_feat_seen_softmax_loss, the 10
classes hard-coded in loss_prompt_sigmoid.  A label of -1 (a novel box's
seen label) indexes the last class, as jnp.take_along_axis wraps it.

The forward's outputs carry a leading decoder-layer axis L, and the
criterion works on all L layers at once, as the JAX package vmaps over
them: the gIoU and the centre distances are formed for every layer, the
matcher builds the cost of all layers on the device and solves it with one
host round trip (`ops.hungarian`), and each loss comes out as an (L,)
vector; the aux layers' keys get the `_k` suffix (k = 0 .. L-2), the last
layer's none.  A loss the JAX package applies to the last layer only
(_LAST_LAYER_ONLY) is masked to it over the layer axis and has no aux keys.

Losses are normalized as the JAX package normalizes them over its global
batch: matched sums by the global ground-truth count, weighted means by the
global weight sum, batch means over the global batch.  Over several ranks
(parallel/ddp.py) each rank holds B rows of that batch, and each loss is
the rank's share of the JAX package's global scalar: its local sum over the
global normalizer (a no_grad all-reduce, `parallel.dist.global_sum`), so the
shares sum to the global loss, the gradients are summed over the ranks, and
the loss dict a train step logs is the all-reduced sum.  The one exception
is the JAX package's per-replica normalizer of
loss_sem_cls_softmax_skip_none_gt_sample (`per_replica_norm`, its
criterion.py:221-243, on by default): the global batch's rows fall into
per_replica_norm contiguous groups, each normalized by its own count of
scenes with objects, and the groups' losses are averaged; a rank's groups
are its own rows, so that count stays rank-local.  The two contrastive
losses pair a batch's rows with each other, so over several ranks they
raise where their features are present (no model of the port makes them).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from coda_neurips2023_tpu_torch.ops.giou import generalized_box3d_iou
from coda_neurips2023_tpu_torch.ops.hungarian import matcher_assignments
from coda_neurips2023_tpu_torch.parallel.dist import get_world_size, global_sum

# the JAX package's registry (its criterion.py:160-191), in its order
LOSSES = (
    "loss_sem_cls",
    "loss_sem_cls_softmax",
    "loss_sem_cls_softmax_skip_none_gt_sample",
    "loss_sem_cls_softmax_skip_none_gt_sample_en_discovery_objectness",
    "loss_sem_cls_softmax_skip_none_gt_sample_keep_discovery_objectness",
    "loss_sem_cls_softmax_discovery_novel_objectness",
    "loss_sem_cls_softmax_2d_box_iou_supervised_skip_none_gt_sample",
    "loss_angle",
    "loss_center",
    "loss_size",
    "loss_giou",
    "loss_region_embed",
    "loss_predicted_region_embed_l1",
    "loss_predicted_region_embed_l1_only_last_layer",
    "loss_predicted_region_embed_cos",
    "loss_feat_seen_softmax_weakly_loss_with_novel_cate_confi",
    "loss_feat_seen_softmax_iou_match_weakly_loss_with_novel_cate_confi",
    "loss_contrast_object_text",
    "loss_image_seen_class",
    "loss_contrastive",
    "loss_sem_focal_cls",
    "loss_feat_seen_sigmoid_loss",
    "loss_feat_seen_sigmoid_with_full_image_loss",
    "loss_feat_seen_softmax_loss",
    "loss_feat_seen_softmax_weakly_loss",
    "loss_feat_seen_softmax_loss_with_novel_cate_confi",
    "loss_batchwise_contrastive",
    "loss_prompt_softmax",
    "loss_prompt_sigmoid",
)

# losses the JAX package applies to the last decoder layer only (its
# criterion.py:50-56, the reference's single_output_forward)
_LAST_LAYER_ONLY = (
    "loss_contrastive",
    "loss_image_seen_class",
    "loss_batchwise_contrastive",
    "loss_3d_2d_region_embed",
    "loss_predicted_region_embed_l1_only_last_layer",
)


def huber_loss(error, delta: float = 1.0):
    abs_error = torch.abs(error)
    quadratic = torch.clamp(abs_error, max=delta)
    linear = abs_error - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    """torchvision.ops.sigmoid_focal_loss, reduction='none', as the JAX
    package writes it."""
    p = torch.sigmoid(logits)
    ce = torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def _cross_entropy(logits, labels, class_weights=None):
    """w[y] * nll, reduction 'none'; a label of -1 takes the last class, as
    jnp.take_along_axis wraps a negative index."""
    labels = torch.where(labels < 0, labels + logits.shape[-1], labels)
    nll = -torch.gather(F.log_softmax(logits, dim=-1), -1, labels[..., None])[..., 0]
    if class_weights is not None:
        nll = nll * class_weights[labels]
    return nll


def _one_hot(labels, n, dtype):
    """jax.nn.one_hot: an all-zero row for a label outside [0, n)."""
    return (labels[..., None] == torch.arange(n, device=labels.device)).to(dtype)


def _gather_per_prop(x, per_prop_gt_inds):
    """Ground-truth side (B, ngt, ...) -> proposal side (L, B, nprop, ...)
    for assignments (L, B, nprop)."""
    idx = per_prop_gt_inds
    x = x.expand(idx.shape[0], *x.shape)
    idx = idx.reshape(*idx.shape, *(1,) * (x.dim() - idx.dim()))
    return torch.gather(x, 2, idx.expand(*idx.shape[:3], *x.shape[3:]))


def _layer_sum(t):
    """(L, ...) -> (L,): the sum over everything but the layer."""
    return t.flatten(1).sum(1)


def _unit(emb):
    return emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-32)


class Matcher:
    """Cost = cls * -p(gt class) + objectness * -p(object) + center * L1
    distance + giou * -gIoU, over every decoder layer at once."""

    def __init__(self, cost_class, cost_objectness, cost_giou, cost_center):
        self.cost_class = cost_class
        self.cost_objectness = cost_objectness
        self.cost_giou = cost_giou
        self.cost_center = cost_center

    @torch.no_grad()
    def __call__(self, outputs, targets):
        """outputs: (L, B, nq, ...) tensors plus `gious` and `center_dist`
        (L, B, nq, ngt) -> assignments with a leading L axis."""
        sem_cls_prob = outputs["sem_cls_prob"]  # (L, B, nq, n_fg)
        gt_labels = targets["gt_box_sem_cls_label"].long()  # (B, ngt)
        nq = sem_cls_prob.shape[-2]
        index = gt_labels[None, :, None, :].expand(*sem_cls_prob.shape[:2], nq, -1)
        class_mat = -torch.gather(sem_cls_prob, -1, index)
        cost = (
            self.cost_class * class_mat
            + self.cost_objectness * -outputs["objectness_prob"][..., None]
            + self.cost_center * outputs["center_dist"]
            + self.cost_giou * -outputs["gious"]
        )
        return matcher_assignments(cost, targets["nactual_gt"])


class SetCriterion:
    def __init__(self, matcher: Matcher, dataset_config, loss_weight_dict: dict,
                 train_range_max: int = 10, confidence_type: str = "non-confidence",
                 per_replica_norm: int = 0):
        self.matcher = matcher
        # > 1: loss_sem_cls_softmax_skip_none_gt_sample normalized per group of
        # the global batch's rows, as the JAX package's SetCriterion
        self.per_replica_norm = int(per_replica_norm)
        self.confidence_type = confidence_type
        self.train_range_max = train_range_max
        self.dataset_config = dataset_config
        self.loss_weight_dict = dict(loss_weight_dict)
        # per-class CE weights: the background (last) class gets loss_no_object_weight
        w = np.ones(dataset_config.num_semcls + 1, np.float32)
        w[-1] = self.loss_weight_dict.pop("loss_no_object_weight", 0.2)
        # and over the seen classes (loss_contrast_object_text): the last gets
        # loss_no_object_contrast_weight
        w2 = np.ones(train_range_max + 1, np.float32)
        w2[-1] = self.loss_weight_dict.pop("loss_no_object_contrast_weight", 0.2)
        self._weights = {"semcls": torch.from_numpy(w), "seen": torch.from_numpy(w2)}
        # the _only_last_layer twin is the same function, masked to the last layer
        self.loss_functions = {
            name: getattr(self, name.replace("_only_last_layer", "")) for name in LOSSES
        }
        self.last_assignments = None

    def _class_weights(self, device, which="semcls"):
        if self._weights[which].device != device:
            self._weights[which] = self._weights[which].to(device)
        return self._weights[which]

    def _weight(self, name):
        return self.loss_weight_dict.get(name + "_weight", 0)

    def _active(self, name):
        if name == "loss_angle":
            return self._weight("loss_angle_cls") > 1e-32 or self._weight("loss_angle_reg") > 1e-32
        return self._weight(name) > 1e-32

    # ------- individual losses: (L, B, nq, ...) outputs -> (L,) per layer -------

    def _matched_labels(self, outputs, targets, assignments):
        bg = outputs["sem_cls_logits"].shape[-1] - 1
        gt_label = _gather_per_prop(targets["gt_box_sem_cls_label"].long(),
                                    assignments["per_prop_gt_inds"])
        return torch.where(assignments["proposal_matched_mask"] > 0, gt_label,
                           torch.full_like(gt_label, bg))

    def loss_cardinality(self, outputs, targets, assignments):
        pred_logits = outputs["sem_cls_logits"]
        pred_objects = torch.sum(pred_logits.argmax(-1) != pred_logits.shape[-1] - 1, dim=-1)
        err = torch.abs(pred_objects.float() - targets["nactual_gt"].float())
        return torch.mean(err, dim=-1) / get_world_size()

    def loss_sem_cls_softmax(self, outputs, targets, assignments):
        gt_label = self._matched_labels(outputs, targets, assignments)
        w = self._class_weights(gt_label.device)
        nll = _cross_entropy(outputs["sem_cls_logits"], gt_label, w)
        return _layer_sum(nll) / torch.clamp(global_sum(_layer_sum(w[gt_label])), min=1e-32)

    def loss_sem_cls_softmax_skip_none_gt_sample(self, outputs, targets, assignments):
        gt_label = self._matched_labels(outputs, targets, assignments)
        w = self._class_weights(gt_label.device)
        nll = _cross_entropy(outputs["sem_cls_logits"], gt_label, w)  # (L, B, nq)
        has_obj = (targets["nactual_gt"] > 0).to(nll.dtype)
        per_sample = torch.sum(nll, dim=-1) * has_obj  # (L, B)
        world, r, b = get_world_size(), self.per_replica_norm, has_obj.shape[0]
        if r > 1 and (b * world) % r == 0:
            # the JAX package's groups of the global batch: this rank's rows
            # hold r / world of them, and the global loss is their mean
            if r % world:
                raise ValueError(f"per_replica_norm {r} groups straddle the {world} ranks' rows")
            groups = r // world
            sums = per_sample.reshape(per_sample.shape[0], groups, -1).sum(-1)
            cnts = has_obj.reshape(groups, -1).sum(-1)
            return torch.sum(sums / (cnts * nll.shape[-1] + 1e-32), dim=-1) / r
        cnt = global_sum(torch.sum(has_obj))
        return torch.sum(per_sample, dim=-1) / (cnt * nll.shape[-1] + 1e-32)

    def loss_sem_cls(self, outputs, targets, assignments):
        pred_logits = outputs["sem_cls_logits"]
        gt_label = self._matched_labels(outputs, targets, assignments)
        onehot = F.one_hot(gt_label, pred_logits.shape[-1]).to(pred_logits.dtype)
        return sigmoid_focal_loss(pred_logits, onehot).flatten(1).mean(1) / get_world_size()

    def loss_angle(self, outputs, targets, assignments):
        num_bin = self.dataset_config.num_angle_bin
        inds = assignments["per_prop_gt_inds"]
        gt_angle_label = _gather_per_prop(targets["gt_angle_class_label"].long(), inds)
        gt_residual_norm = _gather_per_prop(
            targets["gt_angle_residual_label"] / (math.pi / num_bin), inds
        )
        mask = assignments["proposal_matched_mask"]
        cls_loss = _layer_sum(_cross_entropy(outputs["angle_logits"], gt_angle_label) * mask)
        res = torch.gather(outputs["angle_residual_normalized"], -1, gt_angle_label[..., None])[..., 0]
        reg_loss = _layer_sum(huber_loss(res - gt_residual_norm, 1.0) * mask)
        nb = targets["num_boxes"]
        return {"loss_angle_cls": cls_loss / nb, "loss_angle_reg": reg_loss / nb}

    def _matched_sum(self, per_pair, targets, assignments):
        """(L, B, nq, ngt) -> per layer, the sum over matched pairs / num_boxes."""
        sel = torch.gather(per_pair, -1, assignments["per_prop_gt_inds"][..., None])[..., 0]
        return _layer_sum(sel * assignments["proposal_matched_mask"]) / targets["num_boxes"]

    def loss_center(self, outputs, targets, assignments):
        return self._matched_sum(outputs["center_dist"], targets, assignments)

    def loss_giou(self, outputs, targets, assignments):
        return self._matched_sum(1.0 - outputs["gious"], targets, assignments)

    def loss_size(self, outputs, targets, assignments):
        gt_sizes = _gather_per_prop(targets["gt_box_sizes_normalized"],
                                    assignments["per_prop_gt_inds"])
        l1 = torch.sum(torch.abs(outputs["size_normalized"] - gt_sizes), dim=-1)
        return _layer_sum(l1 * assignments["proposal_matched_mask"]) / targets["num_boxes"]

    def loss_predicted_region_embed_l1(self, outputs, targets, assignments):
        """Stage-1 distillation: masked L1 between the predicted 512-d
        embedding and the CLIP embedding of the box's crop, over
        (valid crops x 512)."""
        gt_emb = targets["gt_text_correlation_embedding"]  # (B, nq, 512)
        mask = targets["gt_text_correlation_embedding_mask"]  # (B, nq, 1)
        pred = outputs["text_correlation_embedding"]  # (L, B, nq, 512)
        ave_weight = global_sum(torch.sum(mask)) * pred.shape[-1]
        return _layer_sum(torch.abs(pred * mask - gt_emb * mask)) / torch.clamp(ave_weight, min=1e-32)

    def loss_predicted_region_embed_cos(self, outputs, targets, assignments):
        """Cosine variant of the distillation loss, over the valid crops."""
        gt_emb = targets["gt_text_correlation_embedding"]
        mask = targets["gt_text_correlation_embedding_mask"][..., 0]
        pred = outputs["text_correlation_embedding"]
        num = torch.sum(gt_emb * pred, dim=-1)
        den = torch.clamp(torch.linalg.vector_norm(gt_emb, dim=-1)
                          * torch.linalg.vector_norm(pred, dim=-1), min=1e-16)
        return _layer_sum((1.0 - num / den) * mask) / torch.clamp(global_sum(torch.sum(mask)),
                                                                  min=1e-32)

    def loss_region_embed(self, outputs, targets, assignments):
        """Matched-pair embedding L1 over (B x 512), as the JAX package
        gathers the target embedding at the matched ground-truth index."""
        gt_emb = _gather_per_prop(targets["gt_text_correlation_embedding"],
                                  assignments["per_prop_gt_inds"])
        pred = outputs["text_correlation_embedding"]
        w = assignments["proposal_matched_mask"][..., None]
        ave = pred.shape[1] * get_world_size() * pred.shape[3]  # the global batch x 512
        return _layer_sum(torch.abs(pred * w / ave - gt_emb * w / ave))

    def loss_contrast_object_text(self, outputs, targets, assignments):
        """Object-text contrastive CE over the seen classes: matched proposals
        take their seen class, the others the bank's last class; the weighted
        mean with the seen weights (background loss_no_object_contrast_weight)."""
        text = targets["text_features_clip"].to(torch.float32)
        logits = torch.matmul(_unit(outputs["text_correlation_embedding"]), text.t())
        logits = logits * targets["logit_scale"]
        bg = logits.shape[-1] - 1
        gt_label = _gather_per_prop(targets["gt_box_seen_sem_cls_label"].long(),
                                    assignments["per_prop_gt_inds"])
        gt_label = torch.where(assignments["proposal_matched_mask"] > 0, gt_label,
                               torch.full_like(gt_label, bg))
        gt_label = torch.clamp(gt_label, 0, bg)
        w = self._class_weights(gt_label.device, "seen")
        wsel = w[torch.clamp(gt_label, 0, w.shape[0] - 1)]
        nll = _cross_entropy(logits, gt_label) * wsel
        return _layer_sum(nll) / torch.clamp(global_sum(_layer_sum(wsel)), min=1e-32)

    def loss_feat_seen_softmax_weakly_loss_with_novel_cate_confi(self, outputs, targets,
                                                                   assignments):
        """Stage 2's discovery-driven classification: CE of the proposals'
        embedding-to-text-bank logits against their seen class where matched
        and CLIP's weak label elsewhere, weighted by the seen confidence or
        the weak one (1 wherever above 1e-16 for --confidence_type
        non-confidence), over the proposals of weight above 1e-32."""
        text = targets["text_features_clip"].to(torch.float32)
        logits = torch.matmul(_unit(outputs["text_correlation_embedding"]), text.t())
        logits = logits * targets["logit_scale"]
        inds = assignments["per_prop_gt_inds"]
        seen_label = _gather_per_prop(targets["gt_box_seen_sem_cls_label"].long(), inds)
        seen_confi = _gather_per_prop(targets["gt_box_seen_sem_cls_confi"], inds)
        matched = assignments["proposal_matched_mask"] > 0
        gt_label = torch.where(matched, seen_label, targets["weak_box_cate_label"].long())
        confi = torch.where(matched, seen_confi, targets["weak_confidence_weight"])
        if self.confidence_type == "non-confidence":
            confi = torch.where(confi > 1e-16, torch.ones_like(confi), confi)
        nll = _cross_entropy(logits, gt_label)
        count = global_sum(_layer_sum((confi > 1e-32).to(nll.dtype)))
        return _layer_sum(nll * confi) / (count + 1e-32)

    # ---- the discovery-objectness variants of the softmax loss ----

    def _skip_none_gt_mean(self, nll, has_obj):
        """The sum over the scenes with objects / (their count x nq), per
        layer: nll (L, B, nq), has_obj (B,) or (L, B)."""
        per_sample = torch.sum(nll, dim=-1) * has_obj  # (L, B)
        cnt = global_sum(torch.sum(has_obj, dim=-1))
        return torch.sum(per_sample, dim=-1) / (cnt * nll.shape[-1] + 1e-32)

    def _novel_as_class0(self, outputs, targets, assignments, flags):
        """The matched labels (background elsewhere) and their nll, with the
        proposals `flags` marks (> 0) labelled class 0."""
        gt_label = self._matched_labels(outputs, targets, assignments)
        if flags is not None:
            gt_label = torch.where(flags > 0, torch.zeros_like(gt_label), gt_label)
        w = self._class_weights(gt_label.device)
        return gt_label, _cross_entropy(outputs["sem_cls_logits"], gt_label, w)

    def loss_sem_cls_softmax_skip_none_gt_sample_en_discovery_objectness(self, outputs, targets,
                                                                         assignments):
        """skip_none_gt_sample with the discovered novels (`discovery_novel`,
        (B, nq)) labelled class 0; a scene with discoveries counts as one
        with objects."""
        disc = targets.get("discovery_novel")
        _, nll = self._novel_as_class0(outputs, targets, assignments, disc)
        n_disc = torch.sum(disc, dim=1) if disc is not None else 0.0
        has_obj = ((targets["nactual_gt"] + n_disc) > 0).to(nll.dtype)
        return self._skip_none_gt_mean(nll, has_obj)

    def loss_sem_cls_softmax_skip_none_gt_sample_keep_discovery_objectness(self, outputs, targets,
                                                                           assignments):
        """skip_none_gt_sample with the discovered novels' loss weight 0,
        over the surviving weights of the scenes with ground truth."""
        _, nll = self._novel_as_class0(outputs, targets, assignments, None)  # (L, B, nq)
        disc = targets.get("discovery_novel")
        keep = torch.ones_like(nll[0])
        if disc is not None:
            keep = torch.where(disc > 0, torch.zeros_like(keep), keep)
        has_obj = (targets["nactual_gt"] > 0).to(nll.dtype)
        per_sample = torch.sum(nll * keep, dim=-1) * has_obj
        cnt = global_sum(torch.sum(torch.sum(keep, dim=1) * has_obj))
        return torch.sum(per_sample, dim=-1) / (cnt + 1e-32)

    def loss_sem_cls_softmax_2d_box_iou_supervised_skip_none_gt_sample(self, outputs, targets,
                                                                       assignments):
        """skip_none_gt_sample with the proposals a 2D-IoU `novel_box_judge`
        flags (the targets' (B, nq), else the outputs' (L, B, nq); zeros
        where neither has it) labelled class 0; a scene with a judged box
        counts as one with objects."""
        judge = targets.get("novel_box_judge", outputs.get("novel_box_judge"))
        if judge is None:
            judge = torch.zeros(assignments["per_prop_gt_inds"].shape[1:], dtype=torch.float32,
                                device=assignments["per_prop_gt_inds"].device)
        _, nll = self._novel_as_class0(outputs, targets, assignments, judge)
        has_obj = ((targets["nactual_gt"] + torch.sum(judge, dim=-1)) > 0).to(nll.dtype)
        return self._skip_none_gt_mean(nll, has_obj)

    def loss_sem_cls_softmax_discovery_novel_objectness(self, outputs, targets, assignments):
        """loss_sem_cls_softmax with the discovered novels labelled class 0."""
        gt_label, nll = self._novel_as_class0(outputs, targets, assignments,
                                              targets.get("discovery_novel"))
        w = self._class_weights(gt_label.device)
        return _layer_sum(nll) / torch.clamp(global_sum(_layer_sum(w[gt_label])), min=1e-32)

    # ---- seen-class losses on the embedding-to-text-bank products ----

    def _seen_logits(self, outputs, targets):
        text = targets["text_features_clip"].to(torch.float32)
        logits = torch.matmul(_unit(outputs["text_correlation_embedding"]), text.t())
        return logits * targets["logit_scale"]

    def _seen_labels(self, targets, assignments):
        return _gather_per_prop(targets["gt_box_seen_sem_cls_label"].long(),
                                assignments["per_prop_gt_inds"])

    def loss_feat_seen_softmax_iou_match_weakly_loss_with_novel_cate_confi(self, outputs, targets,
                                                                           assignments):
        """CE against CLIP's weak labels alone, weighted by their confidence,
        over the proposals of confidence above 1e-32."""
        logits = self._seen_logits(outputs, targets)
        confi = targets["weak_confidence_weight"]
        labels = targets["weak_box_cate_label"].long().expand(*logits.shape[:-1])
        nll = _cross_entropy(logits, labels)
        return _layer_sum(nll * confi) / (global_sum(torch.sum(confi > 1e-32)) + 1e-32)

    def loss_feat_seen_sigmoid_loss(self, outputs, targets, assignments):
        """Sigmoid focal loss of the unnormalized embedding-text products:
        matched proposals on every class (one-hot at their seen label), the
        others on the first train_range_max classes (towards 0), over
        n_matched * C + n_unmatched * train_range_max."""
        text = targets["text_features_clip"].to(torch.float32)
        corr = torch.matmul(outputs["text_correlation_embedding"], text.t())
        ncls = corr.shape[-1]
        matched = assignments["proposal_matched_mask"] > 0
        gt_label = torch.where(matched, self._seen_labels(targets, assignments),
                               torch.full_like(assignments["per_prop_gt_inds"], ncls))
        loss = sigmoid_focal_loss(corr, _one_hot(gt_label, ncls, corr.dtype))
        n_seen = min(self.train_range_max, ncls)
        neg = (torch.arange(ncls, device=corr.device) < n_seen).to(corr.dtype)
        w = torch.where(matched[..., None], torch.ones_like(loss), neg)
        n_matched = _layer_sum(matched.to(corr.dtype))
        all_num = global_sum(n_matched * ncls + (matched[0].numel() - n_matched) * n_seen)
        return _layer_sum(loss * w) / torch.clamp(all_num, min=1e-32)

    def loss_feat_seen_sigmoid_with_full_image_loss(self, outputs, targets, assignments):
        """Sigmoid focal loss of the embeddings against the first
        train_range_max bank rows times the whole image's CLIP embedding
        (`full_image_embedding`, (B, 512); 0 without it); mean."""
        full = targets.get("full_image_embedding")
        if full is None:
            return self._zero(outputs)
        text = targets["text_features_clip"].to(torch.float32)
        n_seen = min(self.train_range_max, text.shape[0])
        text = text[:n_seen][None] * full[:, None, :]  # (B, n_seen, 512)
        corr = torch.matmul(outputs["text_correlation_embedding"], text.transpose(1, 2))
        gt_label = torch.where(assignments["proposal_matched_mask"] > 0,
                               self._seen_labels(targets, assignments),
                               torch.full_like(assignments["per_prop_gt_inds"], n_seen))
        loss = sigmoid_focal_loss(corr, _one_hot(gt_label, n_seen, corr.dtype))
        return loss.flatten(1).mean(1) / get_world_size()

    def loss_feat_seen_softmax_loss(self, outputs, targets, assignments):
        """Matched-only seen-class CE over n_matched * nq (the JAX package's
        normalizer, not the matched count)."""
        confi = assignments["proposal_matched_mask"]
        nll = _cross_entropy(self._seen_logits(outputs, targets),
                             self._seen_labels(targets, assignments))
        count = global_sum(_layer_sum((confi > 1e-32).to(nll.dtype)))
        return _layer_sum(nll * confi) / (count * nll.shape[-1] + 1e-32)

    def loss_feat_seen_softmax_weakly_loss(self, outputs, targets, assignments):
        """Matched proposals take their seen label, the others CLIP's weak
        label; the weight by --confidence_type (ones; the weak confidence;
        the objectness; their mean), 1 on matched proposals with a seen
        label in all but "non-confidence"; a seen label of -1 falls back to
        the weak label after that; over the proposals of weight above
        1e-32."""
        logits = self._seen_logits(outputs, targets)
        weak_label = targets["weak_box_cate_label"].long().expand(*logits.shape[:-1])
        matched = assignments["proposal_matched_mask"] > 0
        gt_label = torch.where(matched, self._seen_labels(targets, assignments), weak_label)
        override = matched & (gt_label != -1)
        one = torch.ones((), dtype=logits.dtype, device=logits.device)
        if self.confidence_type == "clip-max-prob":
            confi = torch.where(override, one, targets["weak_confidence_weight"])
        elif self.confidence_type == "objectness":
            confi = torch.where(override, one, outputs["objectness_prob"].detach())
        elif self.confidence_type == "clip+objectness":
            mix = (outputs["objectness_prob"].detach() + targets["weak_confidence_weight"]) / 2.0
            confi = torch.where(override, one, mix)
        else:  # "non-confidence"
            confi = torch.ones(gt_label.shape, dtype=logits.dtype, device=logits.device)
        nll = _cross_entropy(logits, torch.where(gt_label == -1, weak_label, gt_label))
        count = global_sum(_layer_sum((confi > 1e-32).to(nll.dtype)))
        return _layer_sum(nll * confi) / (count + 1e-32)

    def loss_feat_seen_softmax_loss_with_novel_cate_confi(self, outputs, targets, assignments):
        """Matched-only seen-class CE weighted by each box's confidence, over
        the proposals of confidence above 1e-32 (+ 1e-16)."""
        seen_confi = _gather_per_prop(targets["gt_box_seen_sem_cls_confi"],
                                      assignments["per_prop_gt_inds"])
        confi = torch.where(assignments["proposal_matched_mask"] > 0, seen_confi,
                            torch.zeros_like(seen_confi))
        nll = _cross_entropy(self._seen_logits(outputs, targets),
                             self._seen_labels(targets, assignments))
        count = global_sum(_layer_sum((confi > 1e-32).to(nll.dtype)))
        return _layer_sum(nll * confi) / (count + 1e-16)

    # ---- losses of model variants the JAX package does not wire: 0 where
    # their outputs are absent ----

    def _zero(self, outputs):
        logits = outputs["sem_cls_logits"]
        return torch.zeros(logits.shape[0], dtype=torch.float32, device=logits.device)

    def loss_image_seen_class(self, outputs, targets, assignments):
        """Image-level multi-label focal loss of `seen_class_scores_per_image`
        (L, B, C) against gt_image_class_label (B, C); mean."""
        pred = outputs.get("seen_class_scores_per_image")
        if pred is None:
            return self._zero(outputs)
        gt = targets["gt_image_class_label"].to(pred.dtype)
        return sigmoid_focal_loss(pred, gt).flatten(1).mean(1) / get_world_size()

    def _pair_ce(self, outputs, scale):
        """(CE_image + CE_text) / 2 of the scaled image-text similarities of
        a batch's pooled features (L, B, C), each pair on the diagonal; 0
        where the features are absent.  It pairs the global batch's rows,
        so over several ranks it raises."""
        text = outputs.get("pooled_updated_text_features")
        image = outputs.get("image_features_clip")
        if text is None or image is None:
            return self._zero(outputs)
        if get_world_size() > 1:
            raise ValueError("the contrastive losses pair a batch's rows with each other: "
                             "they need the global batch on one rank")
        sim = scale() * torch.matmul(image, text.transpose(-1, -2))  # (L, B, B)
        labels = torch.arange(sim.shape[-1], device=sim.device).expand(sim.shape[:-1])
        loss_i = _cross_entropy(sim, labels).mean(-1)
        loss_t = _cross_entropy(sim.transpose(-1, -2), labels).mean(-1)
        return (loss_i + loss_t) / 2.0

    def loss_contrastive(self, outputs, targets, assignments):
        """Image-text symmetric contrastive CE (logit scale 100 where the
        targets hold none)."""
        return self._pair_ce(outputs, lambda: targets.get("logit_scale", 100.0))

    def loss_batchwise_contrastive(self, outputs, targets, assignments):
        """CLIP-style symmetric InfoNCE of the pooled image and text features."""
        return self._pair_ce(outputs, lambda: targets["logit_scale"])

    def loss_sem_focal_cls(self, outputs, targets, assignments):
        """Sigmoid focal loss of a seen-class head (`seen_sem_cls_logits`):
        matched proposals take their seen label, the others the last class;
        mean."""
        pred = outputs.get("seen_sem_cls_logits")
        if pred is None:
            return self._zero(outputs)
        bg = pred.shape[-1] - 1
        gt_label = torch.where(assignments["proposal_matched_mask"] > 0,
                               self._seen_labels(targets, assignments),
                               torch.full_like(assignments["per_prop_gt_inds"], bg))
        onehot = _one_hot(torch.clamp(gt_label, 0, bg), pred.shape[-1], pred.dtype)
        return sigmoid_focal_loss(pred, onehot).flatten(1).mean(1) / get_world_size()

    def _prompt_logits(self, outputs, normalize: bool):
        """(L, B, K) products of the first prompt embedding (L, B, Q, C) with
        the prompt text features (L, B, K, C); None without them."""
        emb = outputs.get("prompt_text_correlation_embedding")
        if emb is None:
            return None
        emb = _unit(emb) if normalize else emb
        return torch.matmul(emb, outputs["prompt_text_features_clip"].transpose(-1, -2))[:, :, 0]

    def _prompt_temperature(self, outputs):
        """prompt_temperature_param, a scalar a layer, as (L, 1)."""
        t = outputs["prompt_temperature_param"]
        return t.reshape(t.shape[0], 1)

    def loss_prompt_softmax(self, outputs, targets, assignments):
        """Prompt-learning CE of the temperature-scaled logits against
        `seen_classes` (B,); mean."""
        logits = self._prompt_logits(outputs, normalize=True)
        if logits is None:
            return self._zero(outputs)
        logits = logits * self._prompt_temperature(outputs)[..., None]
        labels = targets["seen_classes"].long().expand(*logits.shape[:-1])
        return _cross_entropy(logits, labels).mean(-1) / get_world_size()

    def loss_prompt_sigmoid(self, outputs, targets, assignments):
        """Prompt-learning focal variant, its one-hot over the 10 classes the
        JAX package hard-codes; the temperature enters times 0."""
        logits = self._prompt_logits(outputs, normalize=False)
        if logits is None:
            return self._zero(outputs)
        onehot = _one_hot(targets["seen_classes"].long(), 10, logits.dtype)
        loss = sigmoid_focal_loss(logits, onehot).flatten(1).mean(1) / get_world_size()
        return loss + 0 * self._prompt_temperature(outputs)[:, 0]

    # ---------------- assembly ----------------

    def __call__(self, outputs_stacked: dict, targets: dict):
        """outputs_stacked: the forward's dict with a leading layer axis L.
        Returns (total_loss, loss_dict); `last_assignments` keeps the
        matcher's (L, B, nq) result."""
        targets = dict(targets)
        nactual_gt = torch.sum(targets["gt_box_present"], dim=1).long()
        targets["nactual_gt"] = nactual_gt
        targets["num_boxes"] = torch.clamp(global_sum(torch.sum(nactual_gt).float()), min=1.0)

        num_layers = outputs_stacked["sem_cls_logits"].shape[0]
        outputs = {
            k: v for k, v in outputs_stacked.items()
            if k not in ("query_xyz", "enc_xyz", "enc_inds") and v.dim() > 0
            and v.shape[0] == num_layers
        }
        corners = outputs["box_corners"]  # (L, B, nq, 8, 3)
        b, nq = corners.shape[1:3]
        ngt = targets["gt_box_corners"].shape[1]
        with torch.set_grad_enabled(torch.is_grad_enabled() and self._active("loss_giou")):
            gious = generalized_box3d_iou(
                corners.reshape(num_layers * b, nq, 8, 3),
                targets["gt_box_corners"].repeat(num_layers, 1, 1, 1),
                nactual_gt.repeat(num_layers),
                rotated_boxes=bool(self.dataset_config.num_angle_bin > 1),
            ).reshape(num_layers, b, nq, ngt)
        outputs["gious"] = gious
        outputs["center_dist"] = torch.sum(
            torch.abs(outputs["center_normalized"][..., :, None, :]
                      - targets["gt_box_centers_normalized"][None, :, None, :, :]),
            dim=-1,
        )
        assignments = self.matcher(outputs, targets)
        self.last_assignments = assignments

        per_layer = {}
        for name, fn in self.loss_functions.items():
            if self._active(name):
                val = fn(outputs, targets, assignments)
                per_layer.update(val if isinstance(val, dict) else {name: val})
        per_layer["loss_cardinality"] = self.loss_cardinality(outputs, targets, assignments)
        total = torch.zeros(num_layers, device=corners.device)
        last_only = torch.zeros(num_layers, device=corners.device)
        last_only[-1] = 1.0
        for k, v in per_layer.items():
            if self._weight(k) > 1e-32:
                per_layer[k] = v * self._weight(k)
                total = total + (per_layer[k] * last_only if k in _LAST_LAYER_ONLY else per_layer[k])
        # the last layer's keys bare, the aux layers' with their index
        losses = {k: v[-1] for k, v in per_layer.items()}
        for layer in range(num_layers - 1):
            losses.update({f"{k}_{layer}": v[layer] for k, v in per_layer.items()
                           if k not in _LAST_LAYER_ONLY})
        return total.sum(), losses


def build_criterion(args, dataset_config, num_replicas: int = 1):
    """The JAX package's build_criterion (weights from the same flags);
    `num_replicas` (R, the ranks) sets per_replica_norm under
    --if_per_replica_loss_norm (the default) unless
    --if_global_batch_loss_norm."""
    matcher = Matcher(
        cost_class=args.matcher_cls_cost,
        cost_giou=args.matcher_giou_cost,
        cost_center=args.matcher_center_cost,
        cost_objectness=args.matcher_objectness_cost,
    )
    loss_weight_dict = {
        "loss_no_object_weight": args.loss_no_object_weight,
        "loss_no_object_contrast_weight": getattr(args, "loss_no_object_contrast_weight", 0.05),
        "loss_angle_cls_weight": args.loss_angle_cls_weight,
        "loss_angle_reg_weight": args.loss_angle_reg_weight,
        "loss_contrast_object_text_weight": getattr(args, "loss_contrast_object_text", 0.0),
    }
    for name in LOSSES:
        loss_weight_dict.setdefault(name + "_weight", getattr(args, name + "_weight", 0.0))
    per_replica = (getattr(args, "if_per_replica_loss_norm", True)
                   and not getattr(args, "if_global_batch_loss_norm", False))
    return SetCriterion(matcher, dataset_config, loss_weight_dict,
                        train_range_max=getattr(args, "train_range_max", 10),
                        confidence_type=getattr(args, "confidence_type", "non-confidence"),
                        per_replica_norm=num_replicas if per_replica else 0)
