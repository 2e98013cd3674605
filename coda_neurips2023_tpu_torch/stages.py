"""Stage wiring, CLIP part: the frozen CLIP, its text banks, the CLIP eval step.

Counterpart of coda_neurips2023_tpu/stages.py :: StageContext, the part
that builds CLIP and its text banks (:61-142), and `make_clip_eval_step`
(:266-349): the baseline detector's --if_with_clip eval, which crops every
predicted box out of the scene's image and zero-shot classifies the crops
with CLIP.  The training glue (distillation targets, discovery) is not ported
yet.

The CLIP is, in order of precedence: an OpenAI checkpoint at
`args.clip_model_path`, loaded by parameter name with strict=True (logit
scale min(exp(logit_scale), 100)); the `clip_model` passed in, with its
weights as they are; or a ViT-B/16 with random weights from `generator`
(logit scale 100), as the JAX package runs without a checkpoint.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from coda_neurips2023_tpu_torch.datasets.config import load_cmp_names, load_superset_names
from coda_neurips2023_tpu_torch.engine import EVAL_KEYS, last_layer
from coda_neurips2023_tpu_torch.models.clip import CLIP, init_clip_parameters
from coda_neurips2023_tpu_torch.models.distillation import clip_crop_scores
from coda_neurips2023_tpu_torch.models.text_bank import build_text_banks

# entries of an OpenAI CLIP archive that are hyper-parameters, not weights
_OPENAI_META_KEYS = ("input_resolution", "context_length", "vocab_size")


def load_openai_state_dict(path: str) -> dict:
    """An OpenAI CLIP .pt (TorchScript archive or plain state dict) -> fp32
    tensors by name, on the CPU."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    return {k: v.float() for k, v in sd.items() if k not in _OPENAI_META_KEYS}


class StageContext:
    def __init__(self, args, dataset_config, clip_model: Optional[CLIP] = None,
                 crop_size: int = 224, device=None, generator: Optional[torch.Generator] = None):
        if getattr(args, "clip_dtype", "float32") in ("bf16", "bfloat16") or getattr(
            args, "compute_dtype", "float32"
        ) in ("bf16", "bfloat16"):
            raise NotImplementedError("the bf16 CLIP tower is not ported yet")
        self.args = args
        self.crop_size = crop_size
        path = getattr(args, "clip_model_path", None)
        self.logit_scale = 100.0
        if path and os.path.exists(path):
            sd = load_openai_state_dict(path)
            clip_model = clip_model if clip_model is not None else CLIP(device=device)
            clip_model.load_state_dict(sd, strict=True)
            self.logit_scale = min(math.exp(float(sd["logit_scale"])), 100.0)
        elif clip_model is None:
            print(f"WARNING: CLIP checkpoint not found at {path!r} -- using random CLIP "
                  "weights (pipeline-validation mode only)")
            if generator is None:
                generator = torch.Generator(device=device or "cpu").manual_seed(0)
            clip_model = init_clip_parameters(CLIP(device=device), generator)
        self.clip_model = clip_model.eval()
        self.device = self.clip_model.logit_scale.device

        is_scannet = "scannet" in getattr(args, "dataset_name", "")
        asset_dir = getattr(args, "asset_dir", None)
        superset_names = load_superset_names(asset_dir) if args.if_clip_superset else None
        if args.if_clip_superset and superset_names is None:
            raise FileNotFoundError("--if_clip_superset needs the LVIS name list lvis_1204.npy")
        banks = build_text_banks(
            dataset_config,
            train_range_max=args.train_range_max,
            test_range_max=args.test_range_max,
            superset_names=superset_names,
            cmp_names=load_cmp_names(asset_dir, scannet=is_scannet),
            seen_idx=getattr(dataset_config, "seen_vocab_idx", None) or None,
            if_clip_more_prompts=args.if_clip_more_prompts,
            clip_model=self.clip_model,
            bpe_path=getattr(args, "clip_bpe_path", None),
        )
        self.superset_prompts = banks.pop("superset_prompts", None)
        self.text_banks = {k: torch.from_numpy(v).to(self.device) for k, v in banks.items()}

    def clip_image_fn(self, images: torch.Tensor) -> torch.Tensor:
        """The frozen image tower: (N, S, S, 3) normalised crops -> (N, 512)."""
        with torch.inference_mode():
            return self.clip_model.encode_image(images)

    def make_clip_eval_step(self, model, bank: str = "test"):
        """Returns eval_step(batch) -> the six eval outputs, with sem_cls_prob
        from CLIP crops of the last decoder layer's boxes.

        --if_use_gt_box classifies the ground-truth boxes instead (padded or
        cut to nq), --if_expand_box squares the rects before cropping, and
        --if_only_novel_prompt narrows the test bank to its novel rows 10:37.
        """
        args = self.args
        if_use_gt_box = getattr(args, "if_use_gt_box", False)
        if_expand_box = getattr(args, "if_expand_box", False)
        text = self.text_banks[bank]
        if getattr(args, "if_only_novel_prompt", False) and bank == "test":
            if text.shape[0] < 37:
                raise ValueError(
                    "--if_only_novel_prompt needs a test text bank with >= 37 rows (the "
                    f"novel slice is vocab rows 10:37); got {text.shape[0]}"
                )
            text = text[10:37]
        model.eval()

        @torch.inference_mode()
        def eval_step(batch: dict) -> dict:
            last = last_layer(model(batch), -1)
            if if_use_gt_box:
                nq = last["objectness_prob"].shape[1]

                def pad_to_nq(x):
                    pad = max(nq - x.shape[1], 0)
                    widths = [0, 0] * (x.dim() - 2) + [0, pad]
                    return torch.nn.functional.pad(x, widths)[:, :nq]

                for key, gt_key in (
                    ("box_corners", "gt_box_corners"), ("box_corners_xyz", "gt_box_corners_xyz"),
                    ("center_unnormalized", "gt_box_centers"),
                    ("size_unnormalized", "gt_box_sizes"), ("angle_continuous", "gt_box_angles"),
                    ("objectness_prob", "gt_box_present"),
                ):
                    last[key] = pad_to_nq(batch[gt_key])
            last["sem_cls_prob"] = clip_crop_scores(
                last, batch, self.clip_image_fn, text, self.logit_scale, self.crop_size,
                expand_box=if_expand_box,
            )
            return {k: last[k] for k in EVAL_KEYS}

        return eval_step
