"""Checkpoints of the PyTorch port's training entry point, on the CPU.

  * `save_checkpoint` then `resume_if_possible` restores the model (weights
    and BatchNorm statistics), AdamW's count, mu and nu, the epoch and the
    best metrics, exactly; the file loads with weights_only=True and no
    temporary file is left behind;
  * a run of `main` (scripts/coda_sunrgbd_stage1.sh's flags at the tiny
    widths of tests/test_torch_port_model.py, dropout as shipped, the tiny
    CLIP of tests/test_torch_port_clip.py, 2 epochs of 4 steps) killed right
    after epoch 0's checkpoint and started again resumes at epoch 1 and ends
    with the uninterrupted run's weights, statistics and optimizer state,
    bit for bit: dropout and the crop selection draw from a generator seeded
    by --seed and the step count, and the loader goes on with the epoch's
    shuffle;
  * the port's last_checkpoint.pth loads into the JAX package's
    restore_params_only (its reference-.pth converter), and the JAX eval
    step on those weights gives the port's eval outputs within FLOAT_TOL
    (both forwards in fp32, summed in different orders);
  * --checkpoint_file without a suffix, as the stage-2 script passes stage
    1's last_checkpoint, resolves to the .pth beside it; a path with
    neither raises, naming both.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coda_neurips2023_tpu import main as jmain
from coda_neurips2023_tpu.datasets import build_dataset as jbuild_dataset
from coda_neurips2023_tpu.datasets import loader as jloader
from coda_neurips2023_tpu.engine import create_train_state
from coda_neurips2023_tpu.engine import make_eval_step as jax_make_eval_step
from coda_neurips2023_tpu.models import build_model as jbuild_model
from coda_neurips2023_tpu.optimizer import build_optimizer as jbuild_optimizer
from coda_neurips2023_tpu.utils.io import restore_params_only as jax_restore

from coda_neurips2023_tpu_torch import engine, stages
from coda_neurips2023_tpu_torch import main as tmain
from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
from coda_neurips2023_tpu_torch.engine import make_eval_step
from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
from coda_neurips2023_tpu_torch.optimizer import build_optimizer
from coda_neurips2023_tpu_torch.utils import io

from test_torch_port_clip import TINY_CLIP, _jax_clip, _port_clip
from test_torch_port_model import TINY, _assert_no_boundary_flip

FLOAT_TOL = 1e-4

# scripts/coda_sunrgbd_stage1.sh with the synthetic split, tiny widths, one
# card, 2 epochs and 8 crops a scene
STAGE1_FLAGS = [
    "--dataset_name", "sunrgbd_anonymous_aligned_image",
    "--model_name", "3detr_predictedbox_distillation", "--if_input_image",
    "--if_image_augment", "True", "--num_semcls", "2",
    "--train_range_min", "0", "--train_range_max", "10", "--test_range_min", "0",
    "--test_range_max", "46", "--ngpus", "1", "--base_lr", "1.97e-4", "--warm_lr_epochs", "18",
    "--eval_every_epoch", "10000000000", "--batchsize_per_gpu", "4",
    "--matcher_giou_cost", "3", "--matcher_cls_cost", "1", "--matcher_center_cost", "5",
    "--matcher_objectness_cost", "5", "--loss_giou_weight", "0", "--loss_no_object_weight", "0.05",
    "--loss_sem_cls_weight", "0", "--loss_sem_cls_softmax_weight", "0",
    "--loss_no_object_contrast_weight", "0.05", "--loss_predicted_region_embed_l1_weight", "1",
    "--loss_sem_cls_softmax_skip_none_gt_sample_weight", "1",
    "--save_separate_checkpoint_every_epoch", "90", "--if_clip_more_prompts",
    "--real_eval_every_epoch", "90", "--if_use_v1", "--test_num_semcls", "46",
    "--distillation_box_num", "8",
    "--synthetic_num_scenes", "16", "--num_points", "1024", "--batchsize_per_gpu_test", "4",
    "--dataset_num_workers", "0", "--dataset_num_workers_test", "0", "--max_epoch", "2",
    "--log_every", "2", *[x for k, v in TINY.items() for x in (f"--{k}", str(v))],
]


def _tiny_model_and_optimizer(seed=0):
    args = tmain.make_args_parser().parse_args(STAGE1_FLAGS)
    model = CoDA3DETR(SunrgbdAnonymousConfig(), **TINY, device="cpu")
    with torch.no_grad():
        reset_parameters(model, torch.Generator().manual_seed(seed))
    optimizer, _ = build_optimizer(args, model, 4)
    return model, optimizer


def test_save_then_resume_restores_everything(tmp_path):
    model, opt = _tiny_model_and_optimizer()
    for p in model.parameters():  # one update, so that count, mu and nu are not their init
        p.grad = torch.full_like(p, 0.01)
    opt.step(1e-3)
    with torch.no_grad():
        next(model.buffers()).add_(0.5)
    path = io.save_checkpoint(str(tmp_path), model, opt, 7, {"ap25": 0.25})
    assert path == str(tmp_path / "checkpoint.pth") and os.listdir(tmp_path) == ["checkpoint.pth"]
    obj = torch.load(path, map_location="cpu", weights_only=True)
    assert set(obj) == {"model", "optimizer", "epoch", "best_val_metrics"}
    assert obj["optimizer"]["count"] == 1

    other, other_opt = _tiny_model_and_optimizer(seed=1)
    assert io.resume_if_possible(str(tmp_path / "none"), other, other_opt) == (-1, {})
    assert io.resume_if_possible(str(tmp_path), other, other_opt) == (7, {"ap25": 0.25})
    for (k, v), (k2, v2) in zip(model.state_dict().items(), other.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
    assert other_opt.count == opt.count == 1
    for key in ("mu", "nu"):
        for a, b in zip(getattr(opt, key), getattr(other_opt, key)):
            assert torch.equal(a, b) and a.abs().sum() > 0


def _install_tiny_clip(monkeypatch):
    _, params = _jax_clip(TINY_CLIP)
    cls = stages.StageContext

    def ctx(args, cfg, device="cuda"):
        return cls(args, cfg, clip_model=_port_clip(TINY_CLIP, params), crop_size=16,
                   device=device)

    monkeypatch.setattr(stages, "StageContext", ctx)


class _Killed(Exception):
    pass


@pytest.fixture(scope="module")
def stage1_runs(tmp_path_factory):
    """Stage 1 uninterrupted into a/, and killed after epoch 0's checkpoint
    then restarted into b/."""
    tmp = tmp_path_factory.mktemp("resume")
    mp = pytest.MonkeyPatch()
    mp.setenv("CODA_AP_WORKERS", "0")
    _install_tiny_clip(mp)
    try:
        tmain.main(STAGE1_FLAGS + ["--checkpoint_dir", str(tmp / "a")], device="cpu")
        save = io.save_checkpoint

        def save_then_die(*a, **kw):
            save(*a, **kw)
            raise _Killed

        mp.setattr(io, "save_checkpoint", save_then_die)
        with pytest.raises(_Killed):
            tmain.main(STAGE1_FLAGS + ["--checkpoint_dir", str(tmp / "b")], device="cpu")
        mp.setattr(io, "save_checkpoint", save)
        killed = os.listdir(tmp / "b")
        assert "checkpoint.pth" in killed and "last_checkpoint.pth" not in killed
        epochs = []
        train_one_epoch = engine.train_one_epoch

        def record(*a, **kw):
            epochs.append(kw["all_epoch"])
            return train_one_epoch(*a, **kw)

        mp.setattr(engine, "train_one_epoch", record)
        tmain.main(STAGE1_FLAGS + ["--checkpoint_dir", str(tmp / "b")], device="cpu")
    finally:
        mp.undo()
    return dict(tmp=tmp, resumed_epochs=epochs)


def test_resumed_run_equals_uninterrupted_bit_for_bit(stage1_runs):
    tmp = stage1_runs["tmp"]
    assert stage1_runs["resumed_epochs"] == [1]
    a = torch.load(tmp / "a" / "last_checkpoint.pth", weights_only=True)
    b = torch.load(tmp / "b" / "last_checkpoint.pth", weights_only=True)
    assert a["epoch"] == b["epoch"] == 1
    assert a["optimizer"]["count"] == b["optimizer"]["count"] == 8
    assert list(a["model"]) == list(b["model"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for key in ("mu", "nu"):
        for k in a["optimizer"][key]:
            assert torch.equal(a["optimizer"][key][k], b["optimizer"][key][k]), (key, k)
    first = torch.load(tmp / "a" / "checkpoint_0000.pth", weights_only=True)
    assert any(not torch.equal(first["model"][k], a["model"][k]) for k in a["model"])


def test_jax_package_reads_the_ports_checkpoint(stage1_runs):
    path = str(stage1_runs["tmp"] / "a" / "last_checkpoint.pth")
    args = jmain.make_args_parser().parse_args(STAGE1_FLAGS)
    datasets, cfg, _, _ = jbuild_dataset(args)
    batch = jloader.collate([datasets["test"][i] for i in range(2)])
    batch = {k: batch[k] for k in ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")}
    _assert_no_boundary_flip(batch, TINY["preenc_npoints"])
    jmodel, _ = jbuild_model(args, cfg)
    tx, _ = jbuild_optimizer(args, None, 4)
    state = create_train_state(jmodel, tx, jax.random.PRNGKey(0), batch)
    state = jax_restore(path, state, model_args=args)
    want = jax.tree.map(np.asarray, jax_make_eval_step(jmodel)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}))

    model = CoDA3DETR(SunrgbdAnonymousConfig(), **TINY, device="cpu")
    io.restore_params_only(path, model)
    got = make_eval_step(model)({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=FLOAT_TOL, err_msg=k)


def test_checkpoint_file_without_suffix(stage1_runs, tmp_path):
    stem = str(stage1_runs["tmp"] / "a" / "last_checkpoint")
    model, _ = _tiny_model_and_optimizer(seed=2)
    io.restore_params_only(stem, model)
    want = torch.load(stem + ".pth", weights_only=True)["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    missing = str(tmp_path / "nothing_here")
    with pytest.raises(ValueError) as err:
        io.restore_params_only(missing, model)
    assert missing in str(err.value) and missing + ".pth" in str(err.value)
