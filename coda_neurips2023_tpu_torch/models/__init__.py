"""Model zoo: the two model names the shipped configs wire up.

  * "3detrmulticlasshead"             -> closed-vocabulary baseline head
  * "3detr_predictedbox_distillation" -> the CoDA model (distillation head)
"""

from coda_neurips2023_tpu_torch.models.model_3detr import (
    build_3detr_multiclasshead,
    build_3detr_predictedbox_distillation_head,
)

MODEL_FUNCS = {
    "3detrmulticlasshead": build_3detr_multiclasshead,
    "3detr_predictedbox_distillation": build_3detr_predictedbox_distillation_head,
}


def build_model(args, dataset_config, device=None):
    return MODEL_FUNCS[args.model_name](args, dataset_config, device=device)
