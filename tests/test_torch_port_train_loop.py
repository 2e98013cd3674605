"""The PyTorch port's training entry point against the JAX package's on the CPU.

`main` without --test_only (do_train) of both packages, with the flags of
scripts/coda_baseline_sunrgbd.sh (3detrmulticlasshead, --if_with_clip, the
matcher costs and losses of the baseline, AdamW) at the tiny widths of
tests/test_torch_port_model.py, dropout 0, 16 synthetic scenes of 1,024
points with 64 x 96 images (4 steps an epoch at batch 4), 2 epochs, the
tiny CLIP of tests/test_torch_port_clip.py for the CLIP-crop evals, and one
`.pth` exported from the JAX package's init passed to both as
--checkpoint_file.  Held:

  * the same batches in the same order (the scan indices of every step);
  * each step's learning rate equal;
  * step k's loss within STEP_LOSS_TOL + k * STEP_DRIFT_TOL: the first is
    the baseline step's tolerance of tests/test_torch_port_train.py (both
    forwards sum in fp32 in different orders), the second what each step
    adds as the two runs' weights drift apart: every step carries that
    rounding into AdamW's update (whose first steps are near lr * sign(g)
    wherever a gradient is rounding noise) and into BatchNorm's running
    statistics.  Measured: at most 4e-5 over the first 7 steps and 1.5e-4
    at the 8th, on losses of about 11.  A step whose loss differs by more
    most likely had a matcher assignment flip, and the failure says so;
  * the final weights and BatchNorm statistics within WEIGHT_TOL of their
    norm (8 steps of that drift; measured 1.6e-5);
  * the same artifacts: the JAX package's checkpoint directories (and their
    .meta.json sidecars) are the port's .pth files, the eval lists and the
    final eval files have the same names.
"""

import os

import numpy as np
import pytest
import torch

import jax

from coda_neurips2023_tpu import engine as jengine
from coda_neurips2023_tpu import main as jmain
from coda_neurips2023_tpu import stages as jstages
from coda_neurips2023_tpu.datasets import build_dataset as jbuild_dataset
from coda_neurips2023_tpu.datasets import loader as jloader
from coda_neurips2023_tpu.models import build_model as jbuild_model
from coda_neurips2023_tpu.models import clip as jclip
from coda_neurips2023_tpu.utils.torch_convert import export_reference_state_dict

from coda_neurips2023_tpu_torch import engine, stages
from coda_neurips2023_tpu_torch import main as tmain

from test_torch_port_clip import TINY_CLIP, _port_clip
from test_torch_port_model import TINY

STEP_LOSS_TOL = 1e-4
STEP_DRIFT_TOL = 2.5e-5
WEIGHT_TOL = 5e-5
SCENES = 16
BATCH = 4
EPOCHS = 2

# scripts/coda_baseline_sunrgbd.sh with the synthetic split, tiny widths,
# dropout 0, one card and 2 epochs
BASELINE_FLAGS = [
    "--dataset_name", "sunrgbd_anonymous_aligned_image", "--model_name", "3detrmulticlasshead",
    "--if_input_image", "--train_range_min", "0", "--train_range_max", "10",
    "--test_range_min", "0", "--test_range_max", "46", "--ngpus", "1",
    "--base_lr", "1.97e-4", "--warm_lr_epochs", "18",
    "--eval_every_epoch", "100000000000000000", "--batchsize_per_gpu", str(BATCH),
    "--matcher_giou_cost", "3", "--matcher_cls_cost", "1", "--matcher_center_cost", "5",
    "--matcher_objectness_cost", "5", "--loss_giou_weight", "0", "--loss_no_object_weight", "0.05",
    "--loss_sem_cls_weight", "0", "--loss_sem_cls_softmax_weight", "0",
    "--loss_sem_cls_softmax_skip_none_gt_sample_weight", "1",
    "--save_separate_checkpoint_every_epoch", "90", "--if_with_clip",
    "--real_eval_every_epoch", "90", "--real_cmp_eval_every_epoch", "90", "--if_use_v1",
    "--test_num_semcls", "46",
    "--synthetic_num_scenes", str(SCENES), "--num_points", "1024", "--batchsize_per_gpu_test", "4",
    "--dataset_num_workers", "0", "--dataset_num_workers_test", "0", "--max_epoch", str(EPOCHS),
    "--enc_dropout", "0", "--dec_dropout", "0", "--mlp_dropout", "0", "--log_every", "2",
    *[x for k, v in TINY.items() for x in (f"--{k}", str(v))],
]


def _export_jax_init(path):
    """The JAX package's init of the baseline detector, as a reference .pth."""
    args = jmain.make_args_parser().parse_args(BASELINE_FLAGS)
    datasets, cfg, _, _ = jbuild_dataset(args)
    model, _ = jbuild_model(args, cfg)
    sample = jloader.collate([datasets["train"][i] for i in range(2)])
    sample = {k: v for k, v in sample.items() if not isinstance(v, list)}
    variables = jax.jit(lambda r, b: model.init(r, b, train=False))(jax.random.PRNGKey(3), sample)
    sd = export_reference_state_dict(variables["params"], variables["batch_stats"],
                                     variables.get("constants", {}))
    torch.save({"model": {k: torch.from_numpy(np.asarray(v).copy()) for k, v in sd.items()}},
               path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' do_train from one .pth; each step's scan indices, LR
    and loss, the final weights and the checkpoint dirs."""
    tmp = tmp_path_factory.mktemp("train_loop")
    ckpt = tmp / "init.pth"
    _export_jax_init(ckpt)
    mp = pytest.MonkeyPatch()
    mp.setenv("CODA_AP_WORKERS", "0")
    contexts, steps = {}, {"jax": [], "port": []}

    def jax_ctx(args, cfg):
        contexts["jax"] = jstages_cls(args, cfg, clip_model=jclip.CLIP(**TINY_CLIP), crop_size=16)
        return contexts["jax"]

    def port_ctx(args, cfg, device="cuda"):
        params = jax.tree.map(np.asarray, contexts["jax"].clip_variables["params"])
        return stages_cls(args, cfg, clip_model=_port_clip(TINY_CLIP, params), crop_size=16,
                          device=device)

    jstages_cls, stages_cls = jstages.StageContext, stages.StageContext
    mp.setattr(jstages, "StageContext", jax_ctx)
    mp.setattr(stages, "StageContext", port_ctx)
    jmake, tmake = jengine.make_train_step, engine.make_train_step

    def jax_make(*a, **kw):
        step = jmake(*a, **kw)

        def recorded(state, batch, rng):
            state, metrics = step(state, batch, rng)
            steps["jax"].append((np.asarray(batch["scan_idx"]).tolist(),
                                 np.float32(metrics["lr"]), float(metrics["loss"])))
            return state, metrics

        return recorded

    def port_make(*a, **kw):
        step = tmake(*a, **kw)

        def recorded(batch, generator=None):
            metrics = step(batch, generator)
            steps["port"].append((batch["scan_idx"].tolist(), np.float32(metrics["lr"]),
                                  float(metrics["loss"])))
            return metrics

        return recorded

    mp.setattr(jengine, "make_train_step", jax_make)
    mp.setattr(engine, "make_train_step", port_make)
    dirs = {side: tmp / side for side in ("jax", "port")}
    try:
        state = jmain.main(BASELINE_FLAGS + ["--checkpoint_file", str(ckpt),
                                             "--checkpoint_dir", str(dirs["jax"])])
        model = tmain.main(BASELINE_FLAGS + ["--checkpoint_file", str(ckpt),
                                             "--checkpoint_dir", str(dirs["port"])], device="cpu")
    finally:
        mp.undo()
    want = export_reference_state_dict(jax.tree.map(np.asarray, state.params),
                                       jax.tree.map(np.asarray, state.batch_stats),
                                       jax.tree.map(np.asarray, state.constants))
    return dict(steps=steps, want=want, got=model.state_dict(), dirs=dirs)


def test_same_batches_and_learning_rates(runs):
    jax_steps, port_steps = runs["steps"]["jax"], runs["steps"]["port"]
    assert len(jax_steps) == len(port_steps) == EPOCHS * SCENES // BATCH
    for i, (j, t) in enumerate(zip(jax_steps, port_steps)):
        assert t[0] == j[0], f"step {i}: scans {t[0]} against the JAX package's {j[0]}"
        assert t[1] == j[1], f"step {i}: lr {t[1]!r} against {j[1]!r}"
    # the loader's epoch 0 shuffles with seed + 1, as after the JAX package's sample batch
    assert sorted(sum((s[0] for s in port_steps[:SCENES // BATCH]), [])) == list(range(SCENES))


@pytest.mark.parametrize("step", range(EPOCHS * SCENES // BATCH))
def test_each_step_loss_matches_jax(runs, step):
    (_, _, jloss), (_, _, tloss) = runs["steps"]["jax"][step], runs["steps"]["port"][step]
    assert abs(tloss - jloss) <= STEP_LOSS_TOL + step * STEP_DRIFT_TOL, (
        f"step {step}: loss {tloss!r} against {jloss!r}: beyond the step's fp32 rounding, "
        "most likely a matcher assignment flipped between the packages")


def test_final_weights_match_jax(runs):
    got, want = runs["got"], runs["want"]
    names = [k for k in want if not k.endswith("num_batches_tracked")]
    assert set(names) <= set(got)
    diff = np.sqrt(sum(np.sum((got[k].numpy().astype(np.float64) - want[k]) ** 2) for k in names))
    norm = np.sqrt(sum(np.sum(np.asarray(want[k], np.float64) ** 2) for k in names))
    assert diff / norm <= WEIGHT_TOL, diff / norm


def test_same_artifacts(runs):
    jax_names = {n for n in os.listdir(runs["dirs"]["jax"])
                 if not n.endswith(".meta.json") and not n.startswith("events.out")}
    port_names = {n[: -len(".pth")] if n.endswith(".pth") else n
                  for n in os.listdir(runs["dirs"]["port"]) if not n.startswith("events.out")}
    assert port_names == jax_names
    assert {"checkpoint", "checkpoint_0000", "checkpoint_best", "last_checkpoint",
            f"eval_{EPOCHS - 1:04d}.lst", "final_eval.txt", "final_eval.pkl"} <= port_names
    for name in ("final_eval.txt", f"eval_{EPOCHS - 1:04d}.lst"):
        text = (runs["dirs"]["port"] / name).read_text()
        assert text.startswith("mAP0.25"), name
