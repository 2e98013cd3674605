"""Set-prediction criterion: matcher and the detection losses (PyTorch).

Counterpart of coda_neurips2023_tpu/criterion.py: the `Matcher` (:101-127),
the `SetCriterion` assembly (:129-193, :685-784) and `build_criterion`
(:786-863), with the losses detection training and stage 1 use:

  loss_sem_cls (focal), loss_sem_cls_softmax,
  loss_sem_cls_softmax_skip_none_gt_sample, loss_angle (cls + reg),
  loss_center, loss_size, loss_giou, and the log-only loss_cardinality;
  the distillation losses on the CLIP crop embeddings of the predicted boxes
  (targets from models/distillation.py): loss_predicted_region_embed_l1, its
  _only_last_layer twin, loss_predicted_region_embed_cos, loss_region_embed;
  and loss_contrast_object_text against the text bank (targets
  text_features_clip and logit_scale).

Every other registered loss belongs to stage 2 or to unwired model variants
and is not ported yet: a weight above 1e-32 for any of them raises
NotImplementedError at construction, naming it, so none is silently dropped.

The forward's outputs carry a leading decoder-layer axis L, and the
criterion works on all L layers at once, as the JAX package vmaps over
them: the gIoU and the centre distances are formed for every layer, the
matcher builds the cost of all layers on the device and solves it with one
host round trip (`ops.hungarian`), and each loss comes out as an (L,)
vector; the aux layers' keys get the `_k` suffix (k = 0 .. L-2), the last
layer's none.  A loss the JAX package applies to the last layer only
(_LAST_LAYER_ONLY) is masked to it over the layer axis and has no aux keys.
Losses are
normalized as the JAX package does with one replica: matched sums by the
global ground-truth count, the skip-none-gt softmax by (scenes with objects
x proposals).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from coda_neurips2023_tpu_torch.ops.giou import generalized_box3d_iou
from coda_neurips2023_tpu_torch.ops.hungarian import matcher_assignments

PORTED_LOSSES = (
    "loss_sem_cls",
    "loss_sem_cls_softmax",
    "loss_sem_cls_softmax_skip_none_gt_sample",
    "loss_angle",
    "loss_center",
    "loss_size",
    "loss_giou",
    "loss_region_embed",
    "loss_predicted_region_embed_l1",
    "loss_predicted_region_embed_l1_only_last_layer",
    "loss_predicted_region_embed_cos",
    "loss_contrast_object_text",
)
# the rest of the JAX package's registry (its criterion.py:161-191), in order
UNPORTED_LOSSES = (
    "loss_sem_cls_softmax_skip_none_gt_sample_en_discovery_objectness",
    "loss_sem_cls_softmax_skip_none_gt_sample_keep_discovery_objectness",
    "loss_sem_cls_softmax_discovery_novel_objectness",
    "loss_sem_cls_softmax_2d_box_iou_supervised_skip_none_gt_sample",
    "loss_feat_seen_softmax_weakly_loss_with_novel_cate_confi",
    "loss_feat_seen_softmax_iou_match_weakly_loss_with_novel_cate_confi",
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
    """w[y] * nll, reduction 'none'."""
    nll = -torch.gather(F.log_softmax(logits, dim=-1), -1, labels[..., None])[..., 0]
    if class_weights is not None:
        nll = nll * class_weights[labels]
    return nll


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
        self.last_host_ms = 0.0

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
        assignments, self.last_host_ms = matcher_assignments(cost, targets["nactual_gt"])
        return assignments


class SetCriterion:
    def __init__(self, matcher: Matcher, dataset_config, loss_weight_dict: dict,
                 train_range_max: int = 10):
        self.matcher = matcher
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
        unported = [n for n in UNPORTED_LOSSES if self._weight(n) > 1e-32]
        if unported:
            raise NotImplementedError(
                "losses not ported to the PyTorch criterion yet: " + ", ".join(unported)
            )
        self.loss_functions = {
            "loss_sem_cls": self.loss_sem_cls,
            "loss_sem_cls_softmax": self.loss_sem_cls_softmax,
            "loss_sem_cls_softmax_skip_none_gt_sample": self.loss_sem_cls_softmax_skip_none_gt_sample,
            "loss_angle": self.loss_angle,
            "loss_center": self.loss_center,
            "loss_size": self.loss_size,
            "loss_giou": self.loss_giou,
            "loss_region_embed": self.loss_region_embed,
            "loss_predicted_region_embed_l1": self.loss_predicted_region_embed_l1,
            "loss_predicted_region_embed_l1_only_last_layer": self.loss_predicted_region_embed_l1,
            "loss_predicted_region_embed_cos": self.loss_predicted_region_embed_cos,
            "loss_contrast_object_text": self.loss_contrast_object_text,
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
        return torch.mean(torch.abs(pred_objects.float() - targets["nactual_gt"].float()), dim=-1)

    def loss_sem_cls_softmax(self, outputs, targets, assignments):
        gt_label = self._matched_labels(outputs, targets, assignments)
        w = self._class_weights(gt_label.device)
        nll = _cross_entropy(outputs["sem_cls_logits"], gt_label, w)
        return _layer_sum(nll) / torch.clamp(_layer_sum(w[gt_label]), min=1e-32)

    def loss_sem_cls_softmax_skip_none_gt_sample(self, outputs, targets, assignments):
        gt_label = self._matched_labels(outputs, targets, assignments)
        w = self._class_weights(gt_label.device)
        nll = _cross_entropy(outputs["sem_cls_logits"], gt_label, w)  # (L, B, nq)
        has_obj = (targets["nactual_gt"] > 0).to(nll.dtype)
        per_sample = torch.sum(nll, dim=-1) * has_obj
        return torch.sum(per_sample, dim=-1) / (torch.sum(has_obj) * nll.shape[-1] + 1e-32)

    def loss_sem_cls(self, outputs, targets, assignments):
        pred_logits = outputs["sem_cls_logits"]
        gt_label = self._matched_labels(outputs, targets, assignments)
        onehot = F.one_hot(gt_label, pred_logits.shape[-1]).to(pred_logits.dtype)
        return sigmoid_focal_loss(pred_logits, onehot).flatten(1).mean(1)

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
        ave_weight = torch.sum(mask) * pred.shape[-1]
        return _layer_sum(torch.abs(pred * mask - gt_emb * mask)) / torch.clamp(ave_weight, min=1e-32)

    def loss_predicted_region_embed_cos(self, outputs, targets, assignments):
        """Cosine variant of the distillation loss, over the valid crops."""
        gt_emb = targets["gt_text_correlation_embedding"]
        mask = targets["gt_text_correlation_embedding_mask"][..., 0]
        pred = outputs["text_correlation_embedding"]
        num = torch.sum(gt_emb * pred, dim=-1)
        den = torch.clamp(torch.linalg.vector_norm(gt_emb, dim=-1)
                          * torch.linalg.vector_norm(pred, dim=-1), min=1e-16)
        return _layer_sum((1.0 - num / den) * mask) / torch.clamp(torch.sum(mask), min=1e-32)

    def loss_region_embed(self, outputs, targets, assignments):
        """Matched-pair embedding L1 over (B x 512), as the JAX package
        gathers the target embedding at the matched ground-truth index."""
        gt_emb = _gather_per_prop(targets["gt_text_correlation_embedding"],
                                  assignments["per_prop_gt_inds"])
        pred = outputs["text_correlation_embedding"]
        w = assignments["proposal_matched_mask"][..., None]
        ave = pred.shape[1] * pred.shape[3]
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
        return _layer_sum(nll) / torch.clamp(_layer_sum(wsel), min=1e-32)

    # ---------------- assembly ----------------

    def __call__(self, outputs_stacked: dict, targets: dict):
        """outputs_stacked: the forward's dict with a leading layer axis L.
        Returns (total_loss, loss_dict); `last_assignments` keeps the
        matcher's (L, B, nq) result."""
        targets = dict(targets)
        nactual_gt = torch.sum(targets["gt_box_present"], dim=1).long()
        targets["nactual_gt"] = nactual_gt
        targets["num_boxes"] = torch.clamp(torch.sum(nactual_gt).float(), min=1.0)

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


def build_criterion(args, dataset_config):
    """The JAX package's build_criterion (weights from the same flags), with
    one replica."""
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
    for name in PORTED_LOSSES + UNPORTED_LOSSES:
        loss_weight_dict.setdefault(name + "_weight", getattr(args, name + "_weight", 0.0))
    return SetCriterion(matcher, dataset_config, loss_weight_dict,
                        train_range_max=getattr(args, "train_range_max", 10))
