"""CLI entry point of the port: the eval of a detector (--test_only).

Counterpart of coda_neurips2023_tpu/main.py, with the same flag set
(`make_args_parser`, :25-320) and `reject_inert_flags` (:809), so the
reference's scripts parse unchanged:

    python -m coda_neurips2023_tpu_torch.main --test_only \
        --model_name 3detr_predictedbox_distillation --dataset_name sunrgbd_image \
        [--dataset_root_dir ... | --dataset_name synthetic] --test_ckpt model.pth \
        --batchsize_per_gpu_test 32 ...

`main` builds the dataset splits, the model and, for the CoDA model or
--if_with_clip, the frozen CLIP with its text banks (`build_everything`,
:322-388: no optimizer, no mesh), then `test_model` (:663-704) runs the
`real_test` split through `engine.evaluate` and prints the AP table of
`APCalculator.metrics_to_str`, appending it to --log_file.  It runs on the
card: `main(argv, device="cpu")` runs on the CPU instead (the device is a
keyword of `main`, not a flag), and without a card the default raises.

The model's weights come from --test_ckpt (a reference-format .pth,
utils/io.py), else from a torch.Generator seeded with --seed
(models.helpers.reset_parameters): a seeded draw of the port's own, not the
JAX package's jax.random.PRNGKey draw, so the two packages' random models
differ.

Not ported yet, and raising NotImplementedError with the ROADMAP item that
brings it: training (do_train: no --test_only), the secondary modes
(--show_only, --save_novel_only, ...), --minitest_only (as in the JAX
package, which has no such split either), the ScanNet datasets.
"""

from __future__ import annotations

import argparse
import sys


def make_args_parser():
    parser = argparse.ArgumentParser("CoDA (PyTorch/CUDA): open-vocabulary 3D detection", add_help=False)

    ##### Optimizer #####
    parser.add_argument("--base_lr", default=5e-4, type=float)
    parser.add_argument("--warm_lr", default=1e-6, type=float)
    parser.add_argument("--warm_lr_epochs", default=9, type=int)
    parser.add_argument("--final_lr", default=1e-6, type=float)
    parser.add_argument("--lr_scheduler", default="cosine", type=str)
    parser.add_argument("--weight_decay", default=0.1, type=float)
    parser.add_argument("--filter_biases_wd", default=False, action="store_true")
    parser.add_argument("--clip_gradient", default=0.1, type=float)

    ##### Model #####
    parser.add_argument("--model_name", default="3detr_predictedbox_distillation", type=str)
    parser.add_argument("--num_semcls", default=2, type=int)
    parser.add_argument("--test_num_semcls", default=46, type=int)
    parser.add_argument("--enc_type", default="vanilla", choices=["masked", "vanilla"])
    parser.add_argument("--enc_nlayers", default=3, type=int)
    parser.add_argument("--enc_dim", default=256, type=int)
    parser.add_argument("--enc_ffn_dim", default=128, type=int)
    parser.add_argument("--enc_dropout", default=0.1, type=float)
    parser.add_argument("--enc_nhead", default=4, type=int)
    parser.add_argument("--enc_activation", default="relu", type=str)
    parser.add_argument("--dec_nlayers", default=8, type=int)
    parser.add_argument("--dec_dim", default=256, type=int)
    parser.add_argument("--dec_ffn_dim", default=256, type=int)
    parser.add_argument("--dec_dropout", default=0.1, type=float)
    parser.add_argument("--dec_nhead", default=4, type=int)
    parser.add_argument("--mlp_dropout", default=0.3, type=float)
    parser.add_argument("--nsemcls", default=-1, type=int)
    parser.add_argument("--preenc_npoints", default=2048, type=int)
    parser.add_argument("--pos_embed", default="fourier", choices=["fourier", "sine"])
    parser.add_argument("--nqueries", default=256, type=int)
    parser.add_argument("--use_color", default=False, action="store_true")
    parser.add_argument(
        "--compute_dtype", default="float32", choices=["float32", "bf16", "bfloat16"],
        help="matmul/attention compute dtype (params stay f32); the port runs float32 "
             "and raises on bf16 (ROADMAP Queue 1 item 6); not a reference flag",
    )
    parser.add_argument(
        "--clip_dtype", default="float32", choices=["float32", "bf16", "bfloat16"],
        help="frozen CLIP tower compute dtype; the port runs float32 and raises on "
             "bf16 (ROADMAP Queue 1 item 6); not a reference flag",
    )
    parser.add_argument(
        "--remat", default=False, action="store_true",
        help="per-transformer-layer activation checkpointing in training "
             "(the JAX package's; training is not ported yet); not a reference flag",
    )
    parser.add_argument(
        "--if_two_phase_stage_step", default=False, action="store_true",
        help="the JAX package's two-phase stage step (not ported: ROADMAP, "
             "Not to port); not a reference flag",
    )
    parser.add_argument(
        "--if_per_replica_loss_norm", default=True, action="store_true",
        help="normalize loss_sem_cls_softmax_skip_none_gt_sample per replica, as "
             "the reference's DDP does (the default); not a reference flag",
    )
    parser.add_argument(
        "--if_global_batch_loss_norm", default=False, action="store_true",
        help="use the global-count normalizer for "
             "loss_sem_cls_softmax_skip_none_gt_sample instead; not a reference flag",
    )

    # accepted-for-compat knobs of unwired reference variants
    parser.add_argument("--cross_enc_dim", default=256, type=int)
    parser.add_argument("--cross_num_layers", default=3, type=int)
    parser.add_argument("--cross_heads", default=4, type=int)
    parser.add_argument("--cross_enc_nlayers", default=3, type=int)
    parser.add_argument("--cross_enc_ffn_dim", default=128, type=int)
    parser.add_argument("--cross_enc_dropout", default=0.1, type=float)
    parser.add_argument("--cross_enc_nhead", default=4, type=int)
    parser.add_argument("--every_number", default=4, type=int)
    parser.add_argument("--pooling_methods", default="average", type=str)
    parser.add_argument("--cross_enc_activation", default="relu", type=str)
    parser.add_argument("--enc_pos_embed", default=None, type=str)
    parser.add_argument("--trans_layer_numbers", default=3, type=int)
    parser.add_argument("--trans_head_numbers", default=4, type=int)
    parser.add_argument("--if_add_norm", default=False, action="store_true")
    parser.add_argument("--if_concat_transformer", default=False, action="store_true")
    parser.add_argument("--if_detach_the_guidence_attention", default=False, action="store_true")
    parser.add_argument("--if_with_larger_embedding", default=False, action="store_true")
    parser.add_argument("--if_adopt_region_embed", default=False, action="store_true")
    parser.add_argument("--if_adopt_2d_box_iou_supervision", default=False, action="store_true")
    parser.add_argument("--box2d_iou_thres", default=1.0, type=float)
    parser.add_argument("--box2d_gt_score_thres", default=0.0, type=float)
    parser.add_argument("--iou_match_thres", default=0.25, type=float)
    parser.add_argument("--if_distill_also_match", default=False, action="store_true")
    parser.add_argument("--conclusion_thres", default=1000, type=int)
    parser.add_argument("--clip_with_objectness", default=-1.0, type=float)
    parser.add_argument("--if_clip_trainable", default=False, action="store_true")
    parser.add_argument("--if_clip_text_only_seen", default=False, action="store_true")
    parser.add_argument("--if_only_novel_prompt", default=False, action="store_true")
    parser.add_argument("--former_prompt_len", default=3, type=int)
    parser.add_argument("--later_prompt_len", default=3, type=int)
    parser.add_argument("--prompt_embedding_dir", default=None, type=str)

    ##### CLIP / open-vocab #####
    parser.add_argument("--if_with_clip", default=False, action="store_true")
    parser.add_argument("--if_with_clip_embed", default=False, action="store_true")
    parser.add_argument("--if_use_gt_box", default=False, action="store_true")
    parser.add_argument("--if_expand_box", default=False, action="store_true")
    parser.add_argument("--if_with_fake_classes", default=False, action="store_true")
    parser.add_argument("--if_clip_more_prompts", default=False, action="store_true")
    parser.add_argument("--if_clip_superset", default=False, action="store_true")
    parser.add_argument("--if_clip_weak_labels", default=False, action="store_true")
    parser.add_argument("--clip_model_path", default="./CLIP/pretrain_models/ViT-B-16.pt", type=str)
    parser.add_argument("--clip_bpe_path", default=None, type=str)
    parser.add_argument("--distillation_box_num", default=32, type=int)
    parser.add_argument("--eval_layer_id", default=-1, type=int)

    ##### Stage-2 discovery #####
    parser.add_argument("--if_keep_box", default=False, action="store_true")
    parser.add_argument("--begin_keep_epoch", default=540, type=int)
    parser.add_argument("--if_select_box_by_objectness", default=False, action="store_true")
    parser.add_argument("--keep_objectness", default=0.5, type=float)
    parser.add_argument("--save_objectness", default=0.3, type=float)
    parser.add_argument("--clip_driven_keep_thres", default=0.3, type=float)
    parser.add_argument("--online_nms_update_novel_label", default=False, action="store_true")
    parser.add_argument("--online_nms_update_accumulate_novel_label", default=False, action="store_true")
    parser.add_argument("--online_nms_update_save_novel_label_clip_driven_with_cate_confidence",
                        default=False, action="store_true")
    # other online-NMS pseudo-label strategies (reference main.py:90-110);
    # accepted for surface parity -- the shipped scripts use only the
    # clip_driven_with_cate_confidence strategy above
    parser.add_argument("--online_nms_update_novel_label_for_objectness", default=False, action="store_true")
    parser.add_argument("--online_nms_update_novel_label_for_objectness_with_max_number",
                        default=False, action="store_true")
    parser.add_argument("--online_nms_update_novel_label_for_clip_driven_objectness",
                        default=False, action="store_true")
    parser.add_argument("--online_nms_update_save_novel_label", default=False, action="store_true")
    parser.add_argument("--online_nms_update_save_novel_label_with_prob", default=False, action="store_true")
    parser.add_argument("--online_nms_update_save_novel_label_clip_driven", default=False, action="store_true")
    parser.add_argument("--online_nms_update_save_novel_label_clip_driven_with_cate_confidence_2d_box",
                        default=False, action="store_true")
    parser.add_argument("--online_nms_update_save_novel_label_clip_driven_with_cate_confidence_iou_match_weakly",
                        default=False, action="store_true")
    parser.add_argument("--online_nms_update_max_num_epoch", default=10, type=int)
    parser.add_argument("--if_online_keep_max_box_number", default=False, action="store_true")
    parser.add_argument("--nms_iou_keep", default=0.25, type=float)
    parser.add_argument("--repeat_time", default=2, type=int)
    parser.add_argument("--online_nms_update_save_epoch", default=50, type=int)
    parser.add_argument("--online_nms_update_accumulate_epoch", default=10, type=int)
    parser.add_argument("--if_accumulate_former_pseudo_labels", default=False, action="store_true")
    parser.add_argument("--if_reset_epoch_periodically", default=False, action="store_true")
    parser.add_argument("--reset_epoch_periodically", default=50, type=int)
    parser.add_argument("--pseudo_setting", default="setting0", type=str)
    parser.add_argument("--confidence_type", default="non-confidence", type=str)
    parser.add_argument("--confidence_type_in_datalayer", default="weight_one", type=str)
    parser.add_argument("--if_only_seen_in_loss", default=False, action="store_true")
    parser.add_argument("--if_skip_no_seen_scene_objectness", default=False, action="store_true")
    parser.add_argument("--only_image_class", default=False, action="store_true")
    parser.add_argument("--only_prompt_loss", default=False, action="store_true")

    ##### Matcher #####
    parser.add_argument("--matcher_giou_cost", default=2, type=float)
    parser.add_argument("--matcher_cls_cost", default=1, type=float)
    parser.add_argument("--matcher_center_cost", default=0, type=float)
    parser.add_argument("--matcher_objectness_cost", default=0, type=float)

    ##### Loss weights (reference main.py:160-260) #####
    for name, default in [
        ("loss_giou_weight", 0.0),
        ("loss_sem_cls_weight", 1.0),
        ("loss_sem_cls_softmax_weight", 0.0),
        ("loss_sem_cls_softmax_skip_none_gt_sample_weight", 0.0),
        ("loss_sem_cls_softmax_2d_box_iou_supervised_skip_none_gt_sample_weight", 0.0),
        ("loss_sem_cls_softmax_skip_none_gt_sample_en_discovery_objectness_weight", 0.0),
        ("loss_sem_cls_softmax_skip_none_gt_sample_keep_discovery_objectness_weight", 0.0),
        ("loss_sem_cls_softmax_discovery_novel_objectness_weight", 0.0),
        ("loss_no_object_weight", 0.2),
        ("loss_no_object_contrast_weight", 0.05),
        ("loss_angle_cls_weight", 0.1),
        ("loss_angle_reg_weight", 0.5),
        ("loss_center_weight", 5.0),
        ("loss_size_weight", 1.0),
        ("loss_contrastive_weight", 0.0),
        ("loss_sem_focal_cls_weight", 0.0),
        ("loss_region_embed_weight", 0.0),
        ("loss_predicted_region_embed_l1_weight", 0.0),
        ("loss_predicted_region_embed_l1_only_last_layer_weight", 0.0),
        ("loss_predicted_region_embed_cos_weight", 0.0),
        ("loss_contrast_object_text", 0.0),
        ("loss_batchwise_contrastive_weight", 0.0),
        ("loss_image_seen_class_weight", 0.0),
        ("loss_feat_seen_softmax_loss_weight", 0.0),
        ("loss_feat_seen_softmax_weakly_loss_weight", 0.0),
        ("loss_feat_seen_softmax_weakly_loss_with_novel_cate_confi_weight", 0.0),
        ("loss_feat_seen_softmax_iou_match_weakly_loss_with_novel_cate_confi_weight", 0.0),
        ("loss_feat_seen_softmax_loss_with_novel_cate_confi_weight", 0.0),
        ("loss_feat_seen_sigmoid_with_full_image_loss_weight", 0.0),
        ("loss_feat_seen_sigmoid_loss_weight", 0.0),
        ("loss_3d_2d_region_embed_weight", 0.0),
        ("loss_contrast_3dto2d_text_weight", 0.0),
        ("loss_prompt_softmax_weight", 0.0),
        ("loss_prompt_sigmoid_weight", 0.0),
    ]:
        parser.add_argument(f"--{name}", default=default, type=float)

    ##### Dataset #####
    parser.add_argument("--dataset_name", default="sunrgbd_anonymous_aligned_image", type=str)
    parser.add_argument("--dataset_root_dir", type=str, default=None)
    parser.add_argument("--meta_data_dir", type=str, default=None)
    parser.add_argument("--asset_dir", type=str, default="datasets")
    parser.add_argument("--object_aug_dir", type=str, default=None,
                        help="virtual-object .npy dir for the _object_aug dataset variant")
    parser.add_argument("--calib_dir", type=str, default=None)
    parser.add_argument("--image_dir", type=str, default=None)
    parser.add_argument("--dataset_num_workers", default=4, type=int)
    parser.add_argument("--dataset_num_workers_test", default=4, type=int)
    parser.add_argument("--batchsize_per_gpu", default=8, type=int)
    parser.add_argument("--batchsize_per_gpu_test", default=48, type=int)
    parser.add_argument("--train_range_min", default=0, type=int)
    parser.add_argument("--train_range_max", default=10, type=int)
    parser.add_argument("--test_range_min", default=0, type=int)
    parser.add_argument("--test_range_max", default=46, type=int)
    # raw ScanNet-200 class-id lists (scannet scripts; scannet50_image.py:38-62)
    parser.add_argument("--train_range_list", default=-1, nargs="+", type=int)
    parser.add_argument("--test_range_list", default=-1, nargs="+", type=int)
    parser.add_argument("--reset_scannet_num", default=50, type=int)
    parser.add_argument("--if_use_v1", default=False, action="store_true")
    parser.add_argument("--if_input_image", default=False, action="store_true")
    parser.add_argument("--if_image_augment", default=False, type=bool)
    parser.add_argument("--image_size_width", default=730, type=int)
    parser.add_argument("--image_size_height", default=531, type=int)
    parser.add_argument("--image_size", default=[730, 531], nargs=2, type=int)
    parser.add_argument("--num_points", default=20000, type=int)
    # ours: scene count for the data-free synthetic fallback dataset
    parser.add_argument("--synthetic_num_scenes", default=256, type=int)
    # fraction of synthetic scenes with zero GT boxes (exercises the
    # skip_none_gt loss normalizer; SUN RGB-D's real rate is ~0.4%)
    parser.add_argument("--synthetic_empty_scene_rate", default=0.0, type=float)

    ##### Training #####
    parser.add_argument("--start_epoch", default=-1, type=int)
    parser.add_argument("--set_epoch", default=-1, type=int)
    parser.add_argument("--max_epoch", default=1080, type=int)
    parser.add_argument("--eval_every_epoch", default=10, type=int)
    parser.add_argument("--real_eval_every_epoch", default=90, type=int)
    parser.add_argument("--real_cmp_eval_every_epoch", default=1000000000, type=int)
    parser.add_argument("--seed", default=0, type=int)

    ##### Testing #####
    parser.add_argument("--test_only", default=False, action="store_true")
    parser.add_argument("--test_no_nms", default=False, action="store_true")
    parser.add_argument("--use_old_type_nms", default=False, action="store_true")
    parser.add_argument("--test_ckpt", default=None, type=str)
    parser.add_argument("--show_only", default=False, action="store_true")
    parser.add_argument("--save_novel_only", default=False, action="store_true")
    parser.add_argument("--save_novel_with_class_only", default=False, action="store_true")
    parser.add_argument("--save_seen_feat_only", default=False, action="store_true")
    parser.add_argument("--cal_class_only", default=False, action="store_true")
    parser.add_argument("--crop_only", default=False, action="store_true")
    parser.add_argument("--if_after_nms", default=False, action="store_true",
                        help="crop/show modes use post-NMS parsed boxes")
    parser.add_argument("--minitest_only", default=False, action="store_true")
    parser.add_argument("--show_box_points", default=False, action="store_true")
    parser.add_argument("--show_dir", default=None, type=str)
    parser.add_argument("--crop_dir", default=None, type=str)
    parser.add_argument("--save_novel_dir", default=None, type=str)
    parser.add_argument("--save_seen_dir", default=None, type=str)
    parser.add_argument("--on_cloud", default=True, action="store_false")

    ##### I/O #####
    parser.add_argument("--checkpoint_dir", default=None, type=str)
    parser.add_argument("--checkpoint_file", default=None, type=str)
    parser.add_argument("--log_every", default=10, type=int)
    parser.add_argument("--log_metrics_every", default=20, type=int)
    parser.add_argument("--save_separate_checkpoint_every_epoch", default=100, type=int)
    parser.add_argument("--log_file", default="log.lst", type=str)
    parser.add_argument("--profile_dir", default=None, type=str,
                        help="capture a profiler trace of a few train iterations (training is not ported yet)")

    ##### Distributed (one process until DDP, ROADMAP Queue 1 item 8) #####
    parser.add_argument("--ngpus", default=1, type=int)
    parser.add_argument("--dist_url", default="tcp://localhost:12345", type=str)

    return parser



_INERT_COMPAT_FLAGS = (
    "cross_enc_dim", "cross_num_layers", "cross_heads", "cross_enc_nlayers",
    "cross_enc_ffn_dim", "cross_enc_dropout", "cross_enc_nhead",
    "every_number", "pooling_methods", "cross_enc_activation",
    "enc_pos_embed", "trans_layer_numbers", "trans_head_numbers",
    "if_add_norm", "if_concat_transformer",
    "if_detach_the_guidence_attention", "if_with_larger_embedding",
    "if_adopt_region_embed", "if_adopt_2d_box_iou_supervision",
    "box2d_iou_thres", "box2d_gt_score_thres", "iou_match_thres",
    "if_distill_also_match", "conclusion_thres", "clip_with_objectness",
    "if_clip_trainable", "if_clip_text_only_seen",
    "if_with_clip_embed", "if_with_fake_classes",
    "online_nms_update_novel_label", "online_nms_update_accumulate_novel_label",
    "online_nms_update_novel_label_for_objectness",
    "online_nms_update_novel_label_for_objectness_with_max_number",
    "online_nms_update_novel_label_for_clip_driven_objectness",
    "online_nms_update_save_novel_label",
    "online_nms_update_save_novel_label_with_prob",
    "online_nms_update_save_novel_label_clip_driven",
    "online_nms_update_save_novel_label_clip_driven_with_cate_confidence_2d_box",
    "online_nms_update_save_novel_label_clip_driven_with_cate_confidence_iou_match_weakly",
    "online_nms_update_max_num_epoch", "if_online_keep_max_box_number",
    "repeat_time", "online_nms_update_accumulate_epoch",
    # declared but never read even by the reference (its learned-prompt text
    # path lives in CLIP/clip/model.py:1084 and is driven by unwired models;
    # ours: models/clip.py encode_text_with_prompt_embedding)
    "former_prompt_len", "later_prompt_len", "prompt_embedding_dir",
    # accepted by the reference parser but explicitly EXCLUDED from its
    # loss-weight application loop (reference criterion.py:1136,1152) --
    # setting them changes nothing there either
    "loss_3d_2d_region_embed_weight", "loss_contrast_3dto2d_text_weight",
)




def reject_inert_flags(parser, args):
    """Raise NotImplementedError for non-default values of compat-only flags."""
    changed = [
        name
        for name in _INERT_COMPAT_FLAGS
        if getattr(args, name) != parser.get_default(name)
    ]
    if changed:
        raise NotImplementedError(
            "flag(s) %s belong to unwired reference model variants / "
            "pseudo-label strategies (reference main.py:90-110); this "
            "framework implements the behavior of the six shipped configs. "
            "Remove the flag(s) or file the variant as a feature."
            % ", ".join("--" + c for c in changed)
        )


# the JAX package's run_mode entries (main.py:707-806)
_MODE_FLAGS = (
    "show_only", "show_box_points", "save_novel_only", "save_novel_with_class_only",
    "save_seen_feat_only", "crop_only", "cal_class_only",
)


def build_everything(args, device="cuda"):
    """The dataset splits, the model on `device` and, for the CoDA model or
    --if_with_clip, the StageContext (CLIP and its text banks), as the JAX
    package's build_everything makes them for eval."""
    from coda_neurips2023_tpu_torch.datasets import build_dataset
    from coda_neurips2023_tpu_torch.models import build_model
    from coda_neurips2023_tpu_torch.stages import StageContext

    datasets, dataset_config, real_test_config, real_cmp_config = build_dataset(args)
    if args.model_name == "3detrmulticlasshead" and not args.if_with_clip:
        # the baseline head scores 1 object + 1 background class; the
        # multi-class real_test protocol needs CLIP's zero-shot classes
        raise SystemExit(
            "3detrmulticlasshead requires --if_with_clip (CLIP zero-shot "
            "classification) for the multi-class eval protocol; add "
            "--if_with_clip --if_input_image"
        )
    model, _ = build_model(args, dataset_config, device=device)
    stage_ctx = None
    if args.model_name == "3detr_predictedbox_distillation" or args.if_with_clip:
        stage_ctx = StageContext(args, real_test_config, device=device)
        n_test_classes = int(stage_ctx.text_banks["test"].shape[0])
        if (
            not getattr(args, "if_only_novel_prompt", False)
            and n_test_classes != real_test_config.num_semcls
        ):
            # the zero-shot class count must match the eval protocol's
            # --test_num_semcls: fail here, not inside parse_predictions
            raise ValueError(
                f"test text bank has {n_test_classes} classes but the eval "
                f"config expects {real_test_config.num_semcls} "
                f"(--test_num_semcls); check --test_range_max / "
                f"--test_range_list / --asset_dir vocabulary"
            )
    return {
        "stage_ctx": stage_ctx,
        "datasets": datasets,
        "dataset_config": dataset_config,
        "real_test_config": real_test_config,
        "real_cmp_config": real_cmp_config,
        "model": model,
        "device": device,
    }


def test_model(args, ctx):
    """The JAX package's test_model: the real_test split through the eval
    step into the AP calculator; prints and returns the metrics
    ({iou: {name: value}})."""
    import torch

    from coda_neurips2023_tpu_torch import engine
    from coda_neurips2023_tpu_torch.datasets.loader import make_loader
    from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
    from coda_neurips2023_tpu_torch.utils.io import restore_params_only

    model, device = ctx["model"], ctx["device"]
    loader = make_loader(
        ctx["datasets"]["real_test"], args.batchsize_per_gpu_test,
        shuffle=False, drop_last=False, pad_last=True,
    )
    with torch.no_grad():
        reset_parameters(model, torch.Generator(device=device).manual_seed(args.seed))
    if args.test_ckpt:
        restore_params_only(args.test_ckpt, model)
    stage_ctx = ctx.get("stage_ctx")
    if stage_ctx and args.if_with_clip:
        eval_step = stage_ctx.make_clip_eval_step(model)
    else:
        eval_step = engine.make_eval_step(
            model,
            eval_text_features=stage_ctx.text_banks["test"] if stage_ctx else None,
            eval_logit_scale=stage_ctx.logit_scale if stage_ctx else 100.0,
            eval_layer_id=args.eval_layer_id,
        )
    ap = engine.evaluate(
        eval_step, loader, ctx["real_test_config"], device=device,
        dataset_name=args.dataset_name,
    )
    metrics = ap.compute_metrics()
    msg = ap.metrics_to_str(metrics)
    print(msg)
    if args.log_file:
        with open(args.log_file, "a") as f:
            f.write(msg + "\n")
    return metrics


def main(argv=None, device="cuda"):
    """Parse `argv` (sys.argv[1:] when None) and run the eval on `device`;
    returns test_model's metrics."""
    from coda_neurips2023_tpu_torch.utils.device import resolve_device

    parser = make_args_parser()
    args = parser.parse_args(argv)
    reject_inert_flags(parser, args)
    if args.minitest_only:
        # the reference accepts this flag, but its build_dataset never makes
        # the minitest split
        raise NotImplementedError(
            "--minitest_only: the reference's minitest split is not wired "
            "(its build_dataset never creates it); use --test_only"
        )
    modes = [name for name in _MODE_FLAGS if getattr(args, name)]
    if modes:
        raise NotImplementedError(
            f"--{modes[0]}: the secondary modes (modes.py) are not ported yet "
            "(ROADMAP Queue 1 item 7)"
        )
    if not args.test_only:
        raise NotImplementedError(
            "training (do_train: the epoch loop, checkpoint saving and the stage-2 "
            "cycle) is not ported yet (ROADMAP Queue 1 items 3, 5 and 7); pass "
            "--test_only to evaluate"
        )
    if (
        args.model_name == "3detrmulticlasshead"
        and not args.if_with_clip
        and args.test_num_semcls > 2
    ):
        print(
            "WARNING: 3detrmulticlasshead without --if_with_clip cannot be "
            "evaluated against a %d-class real_test config (1-way sem probs); "
            "pass --if_with_clip or --test_num_semcls 1" % args.test_num_semcls
        )
    device = resolve_device(device)
    ctx = build_everything(args, device=device)
    return test_model(args, ctx)


if __name__ == "__main__":
    main(sys.argv[1:])
