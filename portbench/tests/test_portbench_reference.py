"""The frozen reference against the port's plain path (the port's ops on
CPU tensors) at a tiny size, from the same seeded weights and inputs."""

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.reference import build as R
from portbench.scenes import SceneDataset

FLAGS = ["--dataset_name", "sunrgbd_anonymous_aligned_image", "--if_input_image",
         "--enc_dim", "32", "--dec_dim", "64", "--nqueries", "16", "--preenc_npoints", "64",
         "--enc_nlayers", "1", "--dec_nlayers", "2", "--num_semcls", "2",
         "--train_range_max", "10", "--test_range_max", "46", "--test_num_semcls", "46",
         "--distillation_box_num", "2", "--loss_predicted_region_embed_l1_weight", "1",
         "--loss_sem_cls_softmax_skip_none_gt_sample_weight", "1", "--seed", "5"]


def _batch(n=2):
    data = SceneDataset(8, 1024, 4, (40, 56), 64, 12, seed=5)
    scenes = [data[i] for i in range(n)]
    return {k: torch.from_numpy(np.stack([s[k] for s in scenes])) for k in scenes[0]}


def _args(model_name):
    from coda_neurips2023_tpu_torch.main import make_args_parser

    return make_args_parser().parse_args(FLAGS + ["--model_name", model_name])


@pytest.mark.parametrize("model_name", ["3detr_predictedbox_distillation", "3detrmulticlasshead"])
def test_eval_forward_equal(model_name):
    from coda_neurips2023_tpu_torch.datasets import build_dataset
    from coda_neurips2023_tpu_torch.models import build_model

    args = _args(model_name)
    _, cfg, _, _ = build_dataset(args)
    prog, _ = build_model(args, cfg, device="cpu")
    ref = R.build(args, "cpu", with_clip=False)
    weights.load_seeded(prog, 5, weights.DETECTOR)
    weights.load_seeded(ref.model, 5, weights.DETECTOR)
    batch = _batch()
    with torch.no_grad():
        a = prog.eval()(batch)
        b = ref.model.eval()(batch)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_stage1_step_equal():
    """One stage-1 training step (dropout, crops, the tower at a small
    width's text bank, criterion, AdamW) of the port's step and the
    reference's: the same loss and parameters, bit for bit on the CPU."""
    from coda_neurips2023_tpu_torch import engine
    from coda_neurips2023_tpu_torch.criterion import build_criterion
    from coda_neurips2023_tpu_torch.datasets import build_dataset
    from coda_neurips2023_tpu_torch.models import build_model
    from coda_neurips2023_tpu_torch.models.clip import CLIP
    from coda_neurips2023_tpu_torch.optimizer import build_optimizer
    from coda_neurips2023_tpu_torch.stages import StageContext

    torch.manual_seed(0)
    args = _args("3detr_predictedbox_distillation")
    _, cfg, eval_cfg, _ = build_dataset(args)
    model, _ = build_model(args, cfg, device="cpu")
    weights.load_seeded(model, 5, weights.DETECTOR)
    clip = CLIP(device="cpu")
    weights.load_seeded(clip, 5, weights.CLIP)
    ctx = StageContext(args, eval_cfg, clip_model=clip, device="cpu")
    opt, sched = build_optimizer(args, model, 10)
    step = ctx.make_fused_train_step(model, build_criterion(args, cfg), opt, lr_schedule=sched)
    batch = dict(_batch(), curr_epoch=0, all_epoch=0, lr=1e-3)
    loss_p = step(batch, engine.step_generator(5, 0, "cpu"))["loss"]

    ref = R.build(args, "cpu", with_clip=True)
    weights.load_seeded(ref.model, 5, weights.DETECTOR)
    weights.load_seeded(ref.clip, 5, weights.CLIP)
    banks = R.text_banks(args, ref.eval_config, ref.clip)
    assert torch.equal(banks["train"], ctx.text_banks["train"])
    loss_r = R.train_step(ref, args, banks, dict(_batch(), curr_epoch=0, all_epoch=0), 1e-3,
                          R.step_generator(5, 0, "cpu"))
    assert torch.equal(loss_p, loss_r)
    for (n, p), (m, q) in zip(model.named_parameters(), ref.model.named_parameters()):
        assert n == m and torch.equal(p, q), n
