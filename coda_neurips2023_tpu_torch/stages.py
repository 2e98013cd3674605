"""Stage wiring: the frozen CLIP, its text banks, the CLIP eval step, stage
1's training glue and stage 2's discovery glue.

Counterpart of coda_neurips2023_tpu/stages.py :: StageContext: the part
that builds CLIP and its text banks (:61-142); `make_clip_eval_step`
(:266-349), the baseline detector's --if_with_clip eval, which crops every
predicted box out of the scene's image and zero-shot classifies the crops
with CLIP; and the training glue (:146-264, :357-414): the text bank the
criterion reads, whether a run needs distillation targets, the targets
function the train step calls on its own forward's last layer, and the
fused stage-1 train step; and stage 2's discovery glue (:442-503): which
epochs save pseudo labels, the discovery function over a step's last decoder
layer (models/discovery.py) and the host writer behind it.

The fused step is the reference's structure: one training forward; then,
under no_grad, the distillation targets from that forward's detached last
layer (so they see its dropout masks and BatchNorm update); then the
criterion, the backward and the optimizer.  The JAX package's two-phase
step (:416-438) runs the forward twice to keep each XLA graph small and is
not ported.

The crop selection is drawn from the step's generator
(`models.distillation.select_distillation_boxes`); a batch that carries
"distillation_sel" (B, n_sel) int64 uses that selection instead, so a run can
be held against another with the same crops.

The CLIP is, in order of precedence: an OpenAI checkpoint at
`args.clip_model_path`, loaded by parameter name with strict=True (logit
scale min(exp(logit_scale), 100)); the `clip_model` passed in, with its
weights as they are; or a ViT-B/16 with random weights from `generator`
(logit scale 100), as the JAX package runs without a checkpoint.
"""

from __future__ import annotations

import copy
import math
import os
from typing import Optional

import numpy as np
import torch

from coda_neurips2023_tpu_torch.datasets.config import load_cmp_names, load_superset_names
from coda_neurips2023_tpu_torch.engine import EVAL_KEYS, last_layer, make_train_step
from coda_neurips2023_tpu_torch.models import discovery as discovery_mod
from coda_neurips2023_tpu_torch.models.clip import CLIP, init_clip_parameters
from coda_neurips2023_tpu_torch.models.distillation import (
    build_clip_distillation_targets,
    clip_crop_scores,
    select_distillation_boxes,
)
from coda_neurips2023_tpu_torch.models.text_bank import build_text_banks
from coda_neurips2023_tpu_torch.utils.device import resolve_device

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
    """The frozen CLIP and its text banks on `device` (the card unless the
    caller passes device="cpu"; a `clip_model` passed in is moved there)."""

    def __init__(self, args, dataset_config, clip_model: Optional[CLIP] = None,
                 crop_size: int = 224, device="cuda",
                 generator: Optional[torch.Generator] = None):
        if getattr(args, "clip_dtype", "float32") in ("bf16", "bfloat16") or getattr(
            args, "compute_dtype", "float32"
        ) in ("bf16", "bfloat16"):
            raise NotImplementedError("the bf16 CLIP tower is not ported yet")
        device = resolve_device(device)
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
                generator = torch.Generator(device=device).manual_seed(0)
            clip_model = init_clip_parameters(CLIP(device=device), generator)
        # frozen: no parameter of CLIP takes a gradient or reaches an optimizer
        self.clip_model = clip_model.to(device).eval().requires_grad_(False)
        self.device = device

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
        # what the last run_discovery_and_write saw: discovery.GATES, the
        # novel rows found and the rows written
        self.last_discovery = None

    def to(self, device) -> "StageContext":
        """A copy of this context on `device`: its own copy of CLIP and the
        text banks there, the same flags."""
        other = copy.copy(self)
        other.device = resolve_device(device)
        other.clip_model = copy.deepcopy(self.clip_model).to(other.device)
        other.text_banks = {k: v.to(other.device) for k, v in self.text_banks.items()}
        return other

    def clip_image_fn(self, images: torch.Tensor) -> torch.Tensor:
        """The frozen image tower: (N, S, S, 3) normalised crops -> (N, 512).
        Under no_grad, not inference_mode: the training step keeps tensors
        made from its output for the backward."""
        with torch.no_grad():
            return self.clip_model.encode_image(images)

    # ------------------------------------------------------------ train glue

    @property
    def train_text_features(self) -> torch.Tensor:
        """The bank the criterion classifies against: the superset with
        --if_clip_superset, else the seen rows (reference model_3detr.py:1786-1791)."""
        if self.args.if_clip_superset:
            return self.text_banks["superset"]
        return self.text_banks["train"][: self.args.train_range_max]

    def needs_distillation(self) -> bool:
        a = self.args
        return (
            getattr(a, "loss_predicted_region_embed_l1_weight", 0.0) > 1e-32
            or getattr(a, "loss_feat_seen_softmax_weakly_loss_with_novel_cate_confi_weight",
                       0.0) > 1e-32
            or getattr(a, "loss_contrast_object_text", 0.0) > 1e-32
        )

    def criterion_consts(self) -> dict:
        """The targets every step shares: the text bank and the logit scale."""
        return {
            "text_features_clip": self.train_text_features,
            "logit_scale": torch.tensor(self.logit_scale, dtype=torch.float32, device=self.device),
        }

    def select_boxes(self, last: dict, batch: dict, generator=None) -> torch.Tensor:
        """The (B, n_sel) crops of this step: batch["distillation_sel"] when
        given, else drawn from `generator`; --if_select_box_by_objectness
        ranks by objectness once curr_epoch >= 540 (reference
        model_3detr.py:990)."""
        if "distillation_sel" in batch:
            return batch["distillation_sel"]
        objectness = last["objectness_prob"]
        b, nq = objectness.shape
        by_obj = getattr(self.args, "if_select_box_by_objectness", False)
        enabled = False
        if by_obj:
            enabled = torch.as_tensor(batch.get("curr_epoch", 0), device=objectness.device) >= 540
        return select_distillation_boxes(
            generator, b, nq, self.args.distillation_box_num, objectness if by_obj else None,
            enabled, device=objectness.device,
        )

    def _distillation_call(self, last: dict, batch: dict, sel, text_bank) -> dict:
        """The one call site of build_clip_distillation_targets, with the flag plumbing
        and the keep-box gate on the monotone all_epoch (reference
        main.py:355-358)."""
        args = self.args
        if_keep_box = getattr(args, "if_keep_box", False)
        keep_enabled = False
        if if_keep_box:
            epoch = batch.get("all_epoch", batch.get("curr_epoch", 0))
            keep_enabled = (torch.as_tensor(epoch, device=sel.device)
                            >= getattr(args, "begin_keep_epoch", 540))
        return build_clip_distillation_targets(
            last, batch, self.clip_image_fn, sel, text_features=text_bank,
            logit_scale=self.logit_scale, if_clip_weak_labels=args.if_clip_weak_labels,
            crop_size=self.crop_size, if_keep_box=if_keep_box,
            keep_objectness=getattr(args, "keep_objectness", 0.5),
            train_range_max=args.train_range_max, keep_enabled=keep_enabled,
        )

    def extra_targets_fn(self):
        """(outputs, batch, generator) -> criterion targets from the step's
        own training forward, or None when no loss needs them.  The train
        step calls it under no_grad."""
        if not self.needs_distillation():
            return None
        consts = self.criterion_consts()

        def fn(outputs, batch, generator):
            if "input_image" not in batch:
                return {}
            last = last_layer(outputs)
            sel = self.select_boxes(last, batch, generator)
            targets = self._distillation_call(last, batch, sel, consts["text_features_clip"])
            targets.update(consts)
            return targets

        return fn

    def make_fused_train_step(self, model, criterion, optimizer, return_last_outputs=False,
                              lr_schedule=None):
        """The stage-1 train step (engine.make_train_step with this context's
        targets function): train_step(batch, generator) -> metrics."""
        return make_train_step(model, criterion, optimizer, lr_schedule=lr_schedule,
                               extra_targets_fn=self.extra_targets_fn(),
                               return_last_outputs=return_last_outputs)

    def make_targets_step(self, model):
        """targets_step(batch, generator) -> the distillation targets of a
        training-mode forward, alone.  As in the JAX package, the forward's
        BatchNorm update is discarded (the statistics are put back), and the
        generator is put back to its state before the call, so a train step
        that follows draws the same dropout masks and the same crops."""
        text = self.train_text_features

        @torch.no_grad()
        def targets_step(batch: dict, generator: Optional[torch.Generator] = None) -> dict:
            model.train()
            buffers = [b.clone() for b in model.buffers()]
            state = generator.get_state() if generator is not None else None
            last = last_layer(model(batch, generator=generator))
            targets = self._distillation_call(last, batch, self.select_boxes(last, batch, generator),
                                              text)
            for b, saved in zip(model.buffers(), buffers):
                b.copy_(saved)
            if state is not None:
                generator.set_state(state)
            return targets

        return targets_step

    # ------------------------------------------------------------ discovery glue

    def is_save_epoch(self, curr_epoch: int) -> bool:
        """Whether discovery runs in this (reset) epoch."""
        a = self.args
        return bool(
            a.online_nms_update_save_novel_label_clip_driven_with_cate_confidence
            and a.online_nms_update_save_epoch > 0
            and curr_epoch % a.online_nms_update_save_epoch == 0
        )

    def discovery_fn(self):
        """discovery(last_outputs, batch) -> discover_novel_boxes' dict on the
        batch's device, against the superset bank with --if_clip_superset,
        the test bank otherwise."""
        args = self.args
        bank = self.text_banks["superset"] if args.if_clip_superset else self.text_banks["test"]

        def fn(last_outputs, batch):
            return discovery_mod.discover_novel_boxes(
                last_outputs, batch, self.clip_image_fn, bank, self.logit_scale,
                train_range_max=args.train_range_max, save_objectness=args.save_objectness,
                clip_driven_keep_thres=args.clip_driven_keep_thres, crop_size=self.crop_size,
            )

        return fn

    def run_discovery_and_write(self, discovery, last_outputs, batch) -> int:
        """Discovery on one training batch and the per-scan writer
        (reference model_3detr.py:1506-1541); returns the novel rows found.
        `batch` holds the step's tensors and, on the host, pseudo_box_path
        (a list) and gt_ori_box_num.  The rows, the mask and the gate counts
        come back to the host in one copy."""
        if "input_image" not in batch or "pseudo_box_path" not in batch:
            return 0
        out = discovery(last_outputs, {k: v for k, v in batch.items()
                                       if isinstance(v, torch.Tensor)})
        info, mask, gates = out["save_box_info"], out["novel_mask"], out["gates"]
        packed = torch.cat([info.reshape(-1), mask.reshape(-1).to(info.dtype),
                            gates.to(info.dtype)]).cpu().numpy()
        b, nq, width = info.shape
        info = packed[: b * nq * width].reshape(b, nq, width)
        mask = packed[b * nq * width: b * nq * (width + 1)].reshape(b, nq) > 0.5
        written = discovery_mod.write_pseudo_labels(
            info, mask, batch["pseudo_box_path"], np.asarray(batch["gt_ori_box_num"]),
            accumulate=self.args.if_accumulate_former_pseudo_labels,
        )
        self.last_discovery = {
            "gates": dict(zip(discovery_mod.GATES, packed[b * nq * (width + 1):].tolist())),
            "rows": int(mask.sum()), "written": written,
        }
        return int(mask.sum())

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
        @torch.inference_mode()
        def eval_step(batch: dict) -> dict:
            model.eval()  # each call: a training loop puts the model back in training mode
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
