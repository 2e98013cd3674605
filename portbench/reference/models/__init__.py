"""Model zoo: the two model names the shipped configs wire up.

  * "3detrmulticlasshead"             -> closed-vocabulary baseline head
  * "3detr_predictedbox_distillation" -> the CoDA model (distillation head)
"""

from portbench.reference.models.model_3detr import (
    build_3detr_multiclasshead,
    build_3detr_predictedbox_distillation_head,
)

MODEL_FUNCS = {
    "3detrmulticlasshead": build_3detr_multiclasshead,
    "3detr_predictedbox_distillation": build_3detr_predictedbox_distillation_head,
}


def build_model(args, dataset_config, device="cuda"):
    """(model, box processor) for `args.model_name`, in training mode (a new
    module's default), with dropout from args.mlp_dropout, args.enc_dropout
    and args.dec_dropout; call `.eval()` for the eval forward.  Built on the
    card unless `device` says otherwise (device="cpu"); without a card the
    default raises."""
    return MODEL_FUNCS[args.model_name](args, dataset_config, device=device)
