"""Eval step (PyTorch).

Counterpart of coda_neurips2023_tpu/engine.py :: make_eval_step (:176-225):
the detector's eval forward, the chosen decoder layer's outputs, and class
scores either from the distillation head against a text bank or, with
`clip_crop_fn`, from CLIP crops of the predicted boxes.  Training and the
AP loop come later.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from coda_neurips2023_tpu_torch.models.model_3detr import get_class_scores

EVAL_KEYS = (
    "box_corners", "sem_cls_prob", "objectness_prob", "center_unnormalized",
    "size_unnormalized", "angle_continuous",
)


def last_layer(outputs: dict, layer_id: int = -1) -> dict:
    """One decoder layer's outputs of the forward's per-layer stacks."""
    return {
        k: v[layer_id] for k, v in outputs.items() if k not in ("query_xyz", "enc_xyz", "enc_inds")
    }


def make_eval_step(
    model,
    eval_text_features: Optional[torch.Tensor] = None,
    eval_logit_scale: float = 100.0,
    clip_crop_fn: Optional[Callable] = None,
    eval_layer_id: int = -1,
):
    """Returns eval_step(batch) -> the six outputs the AP calculator reads.

    `batch` holds point_clouds (B, N, 3+) and point_cloud_dims_min/max (B, 3)
    on the model's device.  With `eval_text_features` (ncls, 512), row
    normalized, `sem_cls_prob` is the softmax over the text bank
    (get_class_scores); with `clip_crop_fn(outputs_last, batch)` instead, it
    is what that returns (CLIP zero-shot scores of the boxes' image crops,
    `models.distillation.clip_crop_scores`); with neither, the sem head's
    foreground softmax.  `eval_layer_id` picks the decoder layer (-1: the
    last).
    """
    model.eval()

    @torch.inference_mode()
    def eval_step(batch: dict) -> dict:
        last = last_layer(model(batch), eval_layer_id)
        if clip_crop_fn is not None:
            last["sem_cls_prob"] = clip_crop_fn(last, batch)
        elif eval_text_features is not None:
            last["sem_cls_prob"] = get_class_scores(
                last["text_correlation_embedding"], eval_text_features, eval_logit_scale
            )
        return {k: last[k] for k in EVAL_KEYS}

    return eval_step
