"""CLI entry point of the port: training (do_train) and the eval of a
detector (--test_only).

Counterpart of coda_neurips2023_tpu/main.py, with the same flag set
(`make_args_parser`, :25-320) and `reject_inert_flags` (:809), so the
reference's scripts parse unchanged:

    python -m coda_neurips2023_tpu_torch.main --dataset_name sunrgbd_anonymous_aligned_image \
        --model_name 3detr_predictedbox_distillation ... --checkpoint_dir outputs/stage1
    python -m coda_neurips2023_tpu_torch.main --test_only --test_ckpt model.pth ...

`main` builds the dataset splits, the model and, for the CoDA model or
--if_with_clip, the frozen CLIP with its text banks, and for training the
criterion, AdamW and its schedule (`build_everything`, :322-388).  It runs
on the card: `main(argv, device="cpu")` runs on the CPU instead (the device
is a keyword of `main`, not a flag), and without a card the default raises.

--ngpus R runs data-parallel over R = min(--ngpus, cards) ranks, one
process a card (parallel/ddp.py), as the JAX package shards its global
batch over min(--ngpus, devices) chips (:347): the same global batch of
batchsize_per_gpu x R rows (each rank its contiguous rows, datasets/loader.py
:: RankLoader), iterations an epoch and schedule of that batch, BatchNorm
statistics and loss normalizers over it, the per-replica normalizer of
loss_sem_cls_softmax_skip_none_gt_sample with R replicas, and the gradients
summed over the ranks.  The ranks meet over NCCL at --dist_url; host objects
go over a gloo group beside it; a failure to start NCCL raises.  Rank 0
alone writes checkpoints, logs and eval files and meters the evals; every
rank restores the same files.  R = 1 is one process, as before.  On the CPU
`main(argv, device="cpu")` is one process unless the caller passes
`cpu_devices=N` (a keyword, not a flag, like the JAX tests' 8 virtual CPU
devices): then R = min(--ngpus, N) processes over gloo.

Without --test_only, `do_train` (:390-646) trains as the JAX package does,
in the same order and with the same file names: the resume from
<checkpoint_dir>/checkpoint.pth, then --checkpoint_file, then --set_epoch;
the epoch loop over `engine.train_one_epoch` with the learning rate of each
iteration from the warm-up + cosine schedule, replayed from the start of
every --reset_epoch_periodically cycle; stage 2's discovery on its save
epochs (--online_nms_update_save_novel_label_clip_driven_with_cate_confidence);
`checkpoint` every epoch and `checkpoint_{epoch:04d}` at
--save_separate_checkpoint_every_epoch; the OV test eval (with
`checkpoint_best` on its AP25), the `real_test` eval (eval_{epoch:04d}.lst)
and the comparison-vocabulary eval (cmp_eval_{epoch:04d}.lst and .xlsx) at
their cadences; `last_checkpoint`; and the final eval (final_eval.txt, .pkl
and .xlsx).  Checkpoints are `.pth` files (utils/io.py).  With --test_only,
`test_model` (:663-704) runs the `real_test` split through `engine.evaluate`
and prints the AP table of `APCalculator.metrics_to_str`, appending it to
--log_file.

The model's weights start from a torch.Generator seeded with --seed
(models.helpers.reset_parameters: each parameter from its flax
counterpart's initializer), then come from a checkpoint where one is given:
the same distributions as the JAX package's init, but a seeded draw of the
port's own, not the jax.random.PRNGKey draw, so the two packages' random
models differ.

A mode flag (--show_only, --show_box_points, --save_novel_only,
--save_novel_with_class_only, --save_seen_feat_only, --crop_only,
--cal_class_only) runs `run_mode` (:707-771) on the `test` split instead:
the modes of modes.py, from --test_ckpt.  Its loader pads the tail and the
modes honour "pad_mask", where the JAX package's drops the tail scenes.

--enc_type masked, --use_color, --pos_embed sine and --remat (activation
checkpointing of each encoder and decoder layer in training, the dropout
masks replayed) run as in the JAX package.

Raising: --minitest_only (as in the JAX package, which has no such split
either), and in training --if_two_phase_stage_step (not to port).
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
from typing import NamedTuple


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
        help="the detector's compute dtype (params stay f32): bf16 runs the pre-encoder's "
             "convs, the encoder (kernel D-bf16), the decoder and the heads in bf16, with "
             "BatchNorm, LayerNorm and the residual stream in f32, and the CLIP tower in bf16 "
             "as --clip_dtype bf16; with --test_only only (the bf16 detector's training is "
             "ROADMAP Queue 1 item 10); not a reference flag",
    )
    parser.add_argument(
        "--clip_dtype", default="float32", choices=["float32", "bf16", "bfloat16"],
        help="the frozen CLIP tower's dtype: bf16 casts its parameters to bf16 and runs "
             "both towers in bf16 (the image tower's attention through kernel E-bf16), in "
             "training and eval; the reference runs CLIP fp16 on CUDA; not a reference flag",
    )
    parser.add_argument(
        "--remat", default=False, action="store_true",
        help="per-transformer-layer activation checkpointing in training "
             "(torch.utils.checkpoint, the dropout masks replayed); not a reference flag",
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
                        help="capture a torch.profiler trace of a few train iterations")

    ##### Distributed: R = min(--ngpus, cards) ranks (parallel/ddp.py) #####
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


# the flags that select run_mode
_MODE_FLAGS = (
    "show_only", "show_box_points", "save_novel_only", "save_novel_with_class_only",
    "save_seen_feat_only", "crop_only", "cal_class_only",
)


def build_everything(args, device="cuda", train: bool = False, world: int = 1):
    """The dataset splits, the model on `device` and, for the CoDA model or
    --if_with_clip, the StageContext (CLIP and its text banks), as the JAX
    package's build_everything makes them; with `train` also the criterion
    (R = `world` replicas), AdamW, its schedule and the iterations an epoch
    of the global batch batchsize_per_gpu x R."""
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
    ctx = {}
    if train:
        from coda_neurips2023_tpu_torch.criterion import build_criterion
        from coda_neurips2023_tpu_torch.optimizer import build_optimizer

        # iterations an epoch as len(train_loader) of the global batch, with drop_last
        iters_per_epoch = max(max(len(datasets["train"]), 1) // (args.batchsize_per_gpu * world), 1)
        optimizer, schedule = build_optimizer(args, model, iters_per_epoch)
        ctx.update(criterion=build_criterion(args, dataset_config, num_replicas=world),
                   optimizer=optimizer, schedule=schedule, iters_per_epoch=iters_per_epoch)
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
    ctx.update({
        "stage_ctx": stage_ctx,
        "datasets": datasets,
        "dataset_config": dataset_config,
        "real_test_config": real_test_config,
        "real_cmp_config": real_cmp_config,
        "model": model,
        "device": device,
        "world": world,
    })
    return ctx


def _eval_step(args, ctx, bank: str = "test"):
    """The eval step of the JAX package's do_train and test_model: CLIP crops
    with --if_with_clip, else the text head against `bank` (or the sem head
    without CLIP)."""
    from coda_neurips2023_tpu_torch import engine

    stage_ctx = ctx.get("stage_ctx")
    if stage_ctx and args.if_with_clip:
        return stage_ctx.make_clip_eval_step(ctx["model"], bank=bank)
    return engine.make_eval_step(
        ctx["model"],
        eval_text_features=stage_ctx.text_banks[bank] if stage_ctx else None,
        eval_logit_scale=stage_ctx.logit_scale if stage_ctx else 100.0,
        eval_layer_id=args.eval_layer_id,
    )


def _eval_loader(args, ctx, split: str, **kw):
    """This rank's rows of `split` in global batches of
    --batchsize_per_gpu_test x R, the last padded."""
    from coda_neurips2023_tpu_torch.datasets.loader import make_loader, shard

    return shard(make_loader(ctx["datasets"][split], args.batchsize_per_gpu_test * ctx["world"],
                             shuffle=False, drop_last=False, pad_last=True, **kw))


def _evaluate(args, ctx, eval_step, split: str, config):
    """`split` through `eval_step` into an APCalculator (None on ranks > 0)."""
    from coda_neurips2023_tpu_torch import engine

    loader = _eval_loader(args, ctx, split, num_workers=max(args.dataset_num_workers_test, 1))
    return engine.evaluate(eval_step, loader, config, device=ctx["device"],
                           dataset_name=args.dataset_name)


def do_train(args, ctx):
    """The JAX package's do_train: the epoch loop, the checkpoint and eval
    cadences, stage 2's periodic epoch reset and discovery, and the final
    eval.  Returns the model."""
    import torch

    from coda_neurips2023_tpu_torch import engine
    from coda_neurips2023_tpu_torch.datasets.loader import make_loader, shard
    from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
    from coda_neurips2023_tpu_torch.optimizer import make_lr_schedule
    from coda_neurips2023_tpu_torch.parallel import ddp
    from coda_neurips2023_tpu_torch.parallel import dist as pdist
    from coda_neurips2023_tpu_torch.utils import io
    from coda_neurips2023_tpu_torch.utils.logger import Logger

    if args.if_two_phase_stage_step:
        raise NotImplementedError("--if_two_phase_stage_step keeps XLA graphs small and is "
                                  "not ported (ROADMAP, Not to port)")
    model, criterion, optimizer = ctx["model"], ctx["criterion"], ctx["optimizer"]
    device, datasets = ctx["device"], ctx["datasets"]
    logger = Logger(args.checkpoint_dir)
    train_loader = shard(make_loader(
        datasets["train"], args.batchsize_per_gpu * ctx["world"], shuffle=True, seed=args.seed,
        drop_last=True, num_workers=max(args.dataset_num_workers, 1),
        use_processes=args.dataset_num_workers > 1,
    ))
    with torch.no_grad():
        reset_parameters(model, torch.Generator(device=device).manual_seed(args.seed))
    start_epoch = -1
    pdist.barrier()  # every rank restores the same files
    if args.checkpoint_dir:
        start_epoch, _ = io.resume_if_possible(args.checkpoint_dir, model, optimizer)
    if args.checkpoint_file:
        io.restore_params_only(args.checkpoint_file, model)
    ddp.broadcast_state(model)
    if args.set_epoch >= 0:
        start_epoch = args.set_epoch - 1
    start_epoch += 1
    # The JAX package draws a sample batch from the loader to initialise its
    # model (main.py:419), which moves the loader's epoch counter to 1: its
    # epoch 0 shuffles with seed + 1.  The port's modules are built eagerly
    # and need no sample, so it moves the counter itself, to take the same
    # batches in the same order.  A resumed run continues the counter where
    # the uninterrupted run would be (the JAX package restarts it at 1, so
    # its resumed run does not repeat its uninterrupted one).
    train_loader.epoch = start_epoch + 1

    stage_ctx = ctx.get("stage_ctx")
    run_discovery = (
        stage_ctx is not None
        and args.online_nms_update_save_novel_label_clip_driven_with_cate_confidence
    )
    if stage_ctx is not None and stage_ctx.needs_distillation():
        train_step = stage_ctx.make_fused_train_step(
            model, criterion, optimizer, return_last_outputs=run_discovery,
            lr_schedule=ctx["schedule"],
        )
    else:
        train_step = engine.make_train_step(
            model, criterion, optimizer, lr_schedule=ctx["schedule"],
            return_last_outputs=run_discovery,
        )
    discovery = stage_ctx.discovery_fn() if run_discovery else None
    eval_step = _eval_step(args, ctx)
    # the comparison-vocabulary eval (reference main.py:530-566)
    cmp_eval_step = None
    if stage_ctx and len(datasets.get("real_cmp_test", [])):
        cmp_eval_step = _eval_step(args, ctx, bank="cmp")
    best_ap25 = -1.0

    # the per-iteration LR of the (reset) epoch: the warm-up + cosine
    # schedule replays every reset_epoch_periodically epochs
    ipe = ctx["iters_per_epoch"]
    host_schedule = make_lr_schedule(args, ipe, host=True)

    for epoch in range(start_epoch, args.max_epoch):
        effective_epoch = epoch
        if args.if_reset_epoch_periodically and args.reset_epoch_periodically > 0:
            effective_epoch = epoch % args.reset_epoch_periodically

        metrics = engine.train_one_epoch(
            train_step, train_loader, curr_epoch=effective_epoch, log_every=args.log_every,
            lr_fn=lambda it, _e=effective_epoch: host_schedule(_e * ipe + it),
            device=device, optimizer=optimizer, seed=args.seed, all_epoch=epoch,
            logger=logger,
            profile_dir=args.profile_dir if epoch == start_epoch and pdist.is_primary() else None,
            discovery_fn=(
                (lambda last, batch: stage_ctx.run_discovery_and_write(discovery, last, batch))
                if run_discovery and stage_ctx.is_save_epoch(effective_epoch)
                else None
            ),
        )
        if metrics:
            logger.log_scalars({k: float(v) for k, v in metrics.items()}, epoch, prefix="Train/")

        if args.checkpoint_dir:
            io.save_checkpoint(args.checkpoint_dir, model, optimizer, epoch)
            if (
                args.save_separate_checkpoint_every_epoch > 0
                and epoch % args.save_separate_checkpoint_every_epoch == 0
            ):
                io.save_checkpoint(args.checkpoint_dir, model, optimizer, epoch,
                                   filename=f"checkpoint_{epoch:04d}")
        # every rank's pseudo-label files and rank 0's checkpoint are written
        # before the next epoch's loader reads them
        pdist.barrier()

        last_epoch = epoch == args.max_epoch - 1

        # the OV test split, and checkpoint_best on its AP25
        ap = None  # stays None on ranks > 0: rank 0 meters, prints and writes
        if ((epoch % args.eval_every_epoch == 0 and epoch > 0) or last_epoch) and len(
            datasets["test"]
        ):
            ap = _evaluate(args, ctx, eval_step, "test", ctx["dataset_config"])
        if ap is not None:
            m = ap.compute_metrics()
            print("==" * 10)
            print(f"Evaluate Epoch [{epoch}/{args.max_epoch}]")
            print(ap.metrics_to_str(m, per_class=True))
            print("==" * 10)
            ap25 = m[0.25].get("mAP", 0.0)
            logger.log_scalars(ap.metrics_to_dict(m), epoch, prefix="Test/")
            if ap25 > best_ap25 and args.checkpoint_dir:
                best_ap25 = ap25
                io.save_checkpoint(args.checkpoint_dir, model, optimizer, epoch, {"ap25": ap25},
                                   "checkpoint_best")

        # the closed-vocabulary real_test split
        ap = None
        if ((epoch % args.real_eval_every_epoch == 0 and epoch > 0) or last_epoch) and len(
            datasets["real_test"]
        ):
            ap = _evaluate(args, ctx, eval_step, "real_test", ctx["real_test_config"])
        if ap is not None:
            msg = ap.metrics_to_str(ap.compute_metrics(), per_class=False)
            print(msg)
            if args.checkpoint_dir:
                with open(os.path.join(args.checkpoint_dir, "eval_%04d.lst" % epoch), "w") as f:
                    f.write(msg)

        # the comparison vocabulary, only when its cadence is at most max_epoch
        # (the JAX package's deviation from the reference, main.py:562-566)
        ap = None
        if (
            cmp_eval_step is not None
            and ((epoch % args.real_cmp_eval_every_epoch == 0 and epoch > 0) or last_epoch)
            and args.real_cmp_eval_every_epoch <= args.max_epoch
        ):
            ap = _evaluate(args, ctx, cmp_eval_step, "real_cmp_test", ctx["real_cmp_config"])
        if ap is not None:
            m = ap.compute_metrics()
            msg = ap.metrics_to_str(m)
            print(msg)
            if args.checkpoint_dir:
                for thresh, suffix in ((0.25, "025"), (0.5, "05")):
                    _export_metrics_excel(
                        {thresh: m[thresh]},
                        os.path.join(args.checkpoint_dir, f"cmp_eval_{epoch:04d}_{suffix}.xlsx"),
                    )
                with open(os.path.join(args.checkpoint_dir, "cmp_eval_%04d.lst" % epoch),
                          "w") as f:
                    f.write(msg)

    if args.checkpoint_dir:
        io.save_checkpoint(args.checkpoint_dir, model, optimizer, args.max_epoch - 1,
                           filename="last_checkpoint")

    # the final eval (reference main.py:578-623)
    ap = None
    if len(datasets["real_test"]):
        ap = _evaluate(args, ctx, eval_step, "real_test", ctx["real_test_config"])
    if ap is not None:
        metrics = ap.compute_metrics()
        msg = ap.metrics_to_str(metrics)
        print("==" * 10, "Final Eval Numbers", "==" * 10)
        print(msg)
        if args.checkpoint_dir:
            with open(os.path.join(args.checkpoint_dir, "final_eval.txt"), "w") as f:
                f.write(msg + "\n")
            with open(os.path.join(args.checkpoint_dir, "final_eval.pkl"), "wb") as f:
                pickle.dump(metrics, f)
            _export_metrics_excel(metrics, os.path.join(args.checkpoint_dir, "final_eval.xlsx"))
    logger.close()
    return model


def _export_metrics_excel(metrics: dict, path: str):
    """A metric sheet of (iou_thresh, metric, value) rows (the reference's
    pandas export, main.py:546-566).  pandas and openpyxl are optional: where
    either is missing, it says so and writes nothing."""
    try:
        import pandas as pd

        rows = []
        for thresh, ret in metrics.items():
            for k, v in ret.items():
                rows.append({"iou_thresh": thresh, "metric": k, "value": float(v)})
        pd.DataFrame(rows).to_excel(path, index=False)
    except Exception as e:  # pandas or openpyxl may be absent
        print(f"excel export skipped: {e}")


def test_model(args, ctx):
    """The JAX package's test_model: the real_test split through the eval
    step into the AP calculator; prints and returns the metrics
    ({iou: {name: value}}; None on ranks > 0, where rank 0 meters)."""
    import torch

    from coda_neurips2023_tpu_torch import engine
    from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
    from coda_neurips2023_tpu_torch.utils.io import restore_params_only

    model, device = ctx["model"], ctx["device"]
    loader = _eval_loader(args, ctx, "real_test")
    # The JAX package draws a sample batch to initialise its model, which
    # moves the loader's epoch counter to 1 and so the task seeds of every
    # batch (the subsample of a real scan); the port takes the same batches.
    loader.epoch = 1
    with torch.no_grad():
        reset_parameters(model, torch.Generator(device=device).manual_seed(args.seed))
    if args.test_ckpt:
        restore_params_only(args.test_ckpt, model)
    eval_step = _eval_step(args, ctx)
    ap = engine.evaluate(
        eval_step, loader, ctx["real_test_config"], device=device,
        dataset_name=args.dataset_name,
    )
    if ap is None:
        return None
    metrics = ap.compute_metrics()
    msg = ap.metrics_to_str(metrics)
    print(msg)
    if args.log_file:
        with open(args.log_file, "a") as f:
            f.write(msg + "\n")
    return metrics


def run_mode(args, ctx):
    """The JAX package's run_mode: the selected secondary mode over the
    `test` split, from the seeded init and --test_ckpt.  Returns what the
    mode returns (a count, or the confusion matrix), summed over the ranks:
    each rank runs the mode on its rows and writes its own scenes' files."""
    from coda_neurips2023_tpu_torch.parallel import dist as pdist

    return pdist.sum_over_ranks(_run_mode(args, ctx))


def _run_mode(args, ctx):
    import torch

    from coda_neurips2023_tpu_torch import engine, modes
    from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
    from coda_neurips2023_tpu_torch.utils.io import restore_params_only

    model, device = ctx["model"], ctx["device"]
    # every scene: the JAX package's loader drops the tail (reference quirk)
    loader = _eval_loader(args, ctx, "test")
    loader.epoch = 1  # the JAX package's sample batch moves it there, as in test_model
    with torch.no_grad():
        reset_parameters(model, torch.Generator(device=device).manual_seed(args.seed))
    if args.test_ckpt:
        restore_params_only(args.test_ckpt, model)
    out_dir = args.checkpoint_dir or "outputs/modes"
    stage_ctx = ctx.get("stage_ctx")

    if args.show_only:
        return modes.show_boxes(model, loader, args.show_dir or os.path.join(out_dir, "show"),
                                after_nms=args.if_after_nms, device=device)
    if args.show_box_points:
        return modes.save_box_points(
            model, loader, args.show_dir or os.path.join(out_dir, "box_points"), device=device)
    if args.save_novel_only or args.save_novel_with_class_only:
        return modes.save_novel_boxes(model, loader, stage_ctx,
                                      with_class=args.save_novel_with_class_only, device=device)
    if args.save_seen_feat_only:
        return modes.save_seen_feats(
            model, loader, stage_ctx, args.save_seen_dir or os.path.join(out_dir, "seen_feats"),
            device=device)
    if args.crop_only:
        return modes.crop_boxes(model, loader, stage_ctx,
                                args.crop_dir or os.path.join(out_dir, "crops"), device=device)
    if args.cal_class_only:
        eval_step = engine.make_eval_step(
            model,
            eval_text_features=stage_ctx.text_banks["test"] if stage_ctx else None,
            eval_logit_scale=stage_ctx.logit_scale if stage_ctx else 100.0,
            eval_layer_id=args.eval_layer_id,
        )
        confusion = modes.calculate_class_confusion(eval_step, loader, args.test_num_semcls,
                                                    device=device)
        print("class confusion (rows GT, cols pred):")
        print(confusion)
        return confusion
    raise ValueError("no mode selected")


def main(argv=None, device="cuda", cpu_devices=None):
    """Parse `argv` (sys.argv[1:] when None) and run on `device`: a mode
    flag's run_mode, the eval with --test_only (returns test_model's
    metrics), else training (returns the trained model).

    Over R = min(--ngpus, cards) > 1 ranks (on the CPU, min(--ngpus,
    `cpu_devices`)) it builds the kernels and the host library once, starts
    one process a rank (parallel/ddp.py) and returns rank 0's result (for
    training, a model on `device` holding rank 0's trained weights, as at
    R = 1).  Called inside a rank (a process group is up), it runs as that
    rank on its device."""
    import torch

    from coda_neurips2023_tpu_torch.parallel import ddp
    from coda_neurips2023_tpu_torch.utils.device import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    parser = make_args_parser()
    args = parser.parse_args(argv)
    reject_inert_flags(parser, args)
    mode = any(getattr(args, name) for name in _MODE_FLAGS)
    if args.compute_dtype in ("bf16", "bfloat16") and (mode or not args.test_only):
        raise NotImplementedError(
            "--compute_dtype bf16 runs with --test_only only: the bf16 detector's training "
            "(flax's stock bf16 attention with weight dropout, a bf16 backward, kernel "
            "D-bf16's backward) is not ported (ROADMAP Queue 1 item 10)")
    if args.minitest_only:
        # the reference accepts this flag, but its build_dataset never makes
        # the minitest split
        raise NotImplementedError(
            "--minitest_only: the reference's minitest split is not wired "
            "(its build_dataset never creates it); use --test_only"
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
    if torch.distributed.is_initialized():  # a rank of a launched run
        device, world = ddp.local_device(), torch.distributed.get_world_size()
    else:
        world = ddp.world_size(args.ngpus, device, cpu_devices)
        what = "cards" if device.type == "cuda" else "CPU devices"
        available = torch.cuda.device_count() if device.type == "cuda" else cpu_devices or 1
        print(f"data parallel: {world} rank(s) (--ngpus {args.ngpus}, {available} {what})")
        if world > 1:
            return _launch(args, argv, device, world)
    ctx = build_everything(args, device=device, train=not (args.test_only or mode), world=world)
    if mode:
        return run_mode(args, ctx)
    if args.test_only:
        return test_model(args, ctx)
    return do_train(args, ctx)


def _launch(args, argv, device, world: int):
    """main(argv) in `world` ranks, one a device, after one build of the
    kernels (on the card) and of the host library, so that no rank waits on
    another's build; rank 0's trained weights come back into a model built
    here on `device`."""
    from coda_neurips2023_tpu_torch import native
    from coda_neurips2023_tpu_torch.datasets import build_dataset
    from coda_neurips2023_tpu_torch.models import build_model
    from coda_neurips2023_tpu_torch.parallel import ddp

    if device.type == "cuda":
        from coda_neurips2023_tpu_torch import _kernels

        _kernels.build()
        devices = [f"cuda:{r}" for r in range(world)]
    else:
        devices = ["cpu"] * world
    native.available()
    result = ddp.launch(_rank_main, world, argv, device.type, devices=devices,
                        backend=ddp.backend_for(device), dist_url=args.dist_url)
    if not isinstance(result, _Trained):
        return result
    model, _ = build_model(args, build_dataset(args)[1], device=device)
    model.load_state_dict(result.state)
    return model.train(result.training)


class _Trained(NamedTuple):
    """A rank's trained model as it crosses to the launching process."""

    state: dict  # the state dict, on the CPU
    training: bool


def _rank_main(argv, device_type):
    import torch

    result = main(argv, device=device_type)
    if isinstance(result, torch.nn.Module):
        return _Trained({k: v.detach().cpu() for k, v in result.state_dict().items()},
                        result.training)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
