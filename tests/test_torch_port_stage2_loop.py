"""Stage 2 through the PyTorch port's training entry point, on the CPU.

  * The epochs a batch carries: the port's and the JAX package's
    train_one_epoch give their step the same curr_epoch (the reset epoch)
    and all_epoch (the monotone one), and through `main` with
    --if_reset_epoch_periodically --reset_epoch_periodically 1 over 2 epochs
    the keep-box gate (--if_keep_box --begin_keep_epoch 1) opens on
    all_epoch, at the second epoch, though the reset epoch stays 0.
  * `main` with scripts/coda_sunrgbd_stage2.sh's flags (tiny widths, 16
    synthetic scenes, 4 steps an epoch, --reset_epoch_periodically 2 and
    --online_nms_update_save_epoch 2 over 4 epochs, so discovery runs at
    epochs 0 and 2) from a stage-1 checkpoint given without its suffix: the
    tiny CLIP's text tower sees only 64 tokens and gives every class nearly
    the same embedding, so here the superset bank is a seeded random one
    and the image tower returns the bank's row 20 (a class that is not
    seen) for every crop, which passes CLIP's gate: every box that passes
    the others is written.  Checked: round 1 writes the pseudo-label files,
    epoch 1 trains on their rows merged into the ground truth
    (gt_box_present beyond gt_ori_box_num), round 2 appends to them within
    the cap of 64 boxes, the epoch after merges both, the loss is finite,
    and the artifacts are the JAX do_train's names.
  * The LR replay: every step's learning rate is the JAX package's host
    schedule at (reset epoch * iterations an epoch + iteration), equal, and
    the two reset cycles repeat each other.
"""

import json
import os

import numpy as np
import pytest
import torch

from coda_neurips2023_tpu import engine as jengine
from coda_neurips2023_tpu.optimizer import make_lr_schedule as jax_make_lr_schedule

from coda_neurips2023_tpu_torch import engine, stages
from coda_neurips2023_tpu_torch import main as tmain

from test_torch_port_clip import TINY_CLIP, _jax_clip, _port_clip
from test_torch_port_train_resume import STAGE1_FLAGS

SCENES, BATCH, EPOCHS = 16, 4, 4
IPE = SCENES // BATCH
NOVEL_ROW = 20

# scripts/coda_sunrgbd_stage2.sh over the stage-1 test's data and widths
STAGE2_FLAGS = STAGE1_FLAGS + [
    "--dataset_name", "sunrgbd_anonymous_aligned_image_with_novel_cate_confi",
    "--loss_feat_seen_softmax_weakly_loss_with_novel_cate_confi_weight", "1",
    "--keep_objectness", "1000", "--save_objectness", "0.3",
    "--online_nms_update_save_epoch", "2", "--pseudo_setting", "setting0",
    "--if_reset_epoch_periodically", "--reset_epoch_periodically", "2", "--set_epoch", "0",
    "--real_eval_every_epoch", "2", "--clip_driven_keep_thres", "0.3", "--if_clip_superset",
    "--online_nms_update_save_novel_label_clip_driven_with_cate_confidence",
    "--confidence_type_in_datalayer", "weight_one", "--if_clip_weak_labels",
    "--confidence_type", "non-confidence", "--if_accumulate_former_pseudo_labels",
    "--save_separate_checkpoint_every_epoch", "1", "--max_epoch", str(EPOCHS),
]


def test_batches_carry_both_epochs_as_in_jax():
    seen = {"jax": [], "port": []}

    def jax_step(state, batch, rng):
        seen["jax"].append((int(batch["curr_epoch"]), int(batch["all_epoch"]),
                            float(batch["lr"])))
        return state, {"loss": np.float32(1.0)}

    def port_step(batch, generator):
        seen["port"].append((batch["curr_epoch"], batch["all_epoch"], batch["lr"]))
        return {"loss": torch.tensor(1.0)}

    host = [{"point_clouds": np.zeros((2, 4, 3), np.float32)}] * 3
    for curr, all_epoch in ((0, 0), (1, 3), (0, 4)):
        jengine.train_one_epoch(jax_step, None, host, None, curr_epoch=curr, all_epoch=all_epoch,
                                lr_fn=lambda it: 1e-4 * (it + 1))
        engine.train_one_epoch(port_step, host, curr_epoch=curr, all_epoch=all_epoch,
                               lr_fn=lambda it: 1e-4 * (it + 1), device="cpu",
                               log=lambda s: None)
    assert [(c, a) for c, a, _ in seen["port"]] == [(c, a) for c, a, _ in seen["jax"]]
    assert [(c, a) for c, a, _ in seen["port"]] == [(0, 0)] * 3 + [(1, 3)] * 3 + [(0, 4)] * 3
    # the JAX loop hands its step the learning rate as float32
    assert [np.float32(lr) for _, _, lr in seen["port"]] == [lr for _, _, lr in seen["jax"]]


def _install_tiny_clip(monkeypatch, pinned=False):
    """The tiny CLIP in both the train step and discovery; with `pinned`, a
    seeded random superset bank and an image tower that returns its row
    NOVEL_ROW for every crop."""
    _, params = _jax_clip(TINY_CLIP)
    cls = stages.StageContext

    def ctx(args, cfg, device="cuda"):
        c = cls(args, cfg, clip_model=_port_clip(TINY_CLIP, params), crop_size=16, device=device)
        if pinned:
            rng = np.random.default_rng(0)
            bank = rng.standard_normal(tuple(c.text_banks["superset"].shape)).astype(np.float32)
            bank /= np.linalg.norm(bank, axis=1, keepdims=True)
            c.text_banks["superset"] = torch.from_numpy(bank)
            c.clip_image_fn = lambda images: c.text_banks["superset"][NOVEL_ROW].expand(
                images.shape[0], -1)
        return c

    monkeypatch.setattr(stages, "StageContext", ctx)


def test_keep_box_gate_opens_on_the_monotone_epoch(tmp_path, monkeypatch):
    monkeypatch.setenv("CODA_AP_WORKERS", "0")
    _install_tiny_clip(monkeypatch)
    calls = []
    build = stages.build_clip_distillation_targets

    def record(*a, **kw):
        calls.append(bool(kw["keep_enabled"]))
        return build(*a, **kw)

    monkeypatch.setattr(stages, "build_clip_distillation_targets", record)
    epochs = []
    train_one_epoch = engine.train_one_epoch

    def record_epochs(*a, **kw):
        epochs.append((kw["curr_epoch"], kw["all_epoch"]))
        return train_one_epoch(*a, **kw)

    monkeypatch.setattr(engine, "train_one_epoch", record_epochs)
    tmain.main(STAGE1_FLAGS + [
        "--if_keep_box", "--begin_keep_epoch", "1", "--if_reset_epoch_periodically",
        "--reset_epoch_periodically", "1", "--checkpoint_dir", str(tmp_path)], device="cpu")
    assert epochs == [(0, 0), (0, 1)]
    assert calls == [False] * IPE + [True] * IPE


@pytest.fixture(scope="module")
def stage2_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stage2")
    mp = pytest.MonkeyPatch()
    mp.setenv("CODA_AP_WORKERS", "0")
    _install_tiny_clip(mp, pinned=True)
    steps, rounds = [], []
    try:
        tmain.main(STAGE1_FLAGS + ["--max_epoch", "1", "--checkpoint_dir", str(tmp / "stage1")],
                   device="cpu")
        train_one_epoch = engine.train_one_epoch
        pseudo = tmp / "stage2" / "synthetic_pseudo_labels_setting0"

        def record(train_step, batches, **kw):
            def step(batch, generator):
                out = step_fn(batch, generator)
                metrics = out[0] if isinstance(out, tuple) else out
                steps.append(dict(
                    epoch=kw["all_epoch"], curr=kw["curr_epoch"], lr=batch["lr"],
                    loss=float(metrics["loss"]), scans=batch["scan_idx"].tolist(),
                    present=batch["gt_box_present"].sum(1).tolist(),
                    ori=np.asarray(batch["gt_ori_box_num"]).tolist()))
                return out

            step_fn = train_step
            metrics = train_one_epoch(step, batches, **kw)
            rounds.append({n: np.load(pseudo / n).shape[0] for n in sorted(os.listdir(pseudo))})
            return metrics

        mp.setattr(engine, "train_one_epoch", record)
        tmain.main(STAGE2_FLAGS + ["--checkpoint_dir", str(tmp / "stage2"), "--checkpoint_file",
                                   str(tmp / "stage1" / "last_checkpoint")], device="cpu")
    finally:
        mp.undo()
    return dict(tmp=tmp, steps=steps, rounds=rounds)


def test_discovery_writes_merges_and_accumulates(stage2_run):
    steps, rounds = stage2_run["steps"], stage2_run["rounds"]
    assert len(steps) == EPOCHS * IPE and len(rounds) == EPOCHS
    assert all(np.isfinite(s["loss"]) for s in steps)
    first, second = rounds[0], rounds[2]
    assert first and sum(first.values()) > 0, "round 1 wrote no pseudo labels"
    assert rounds[1] == first  # epoch 1 is not a save epoch
    assert set(first) <= set(second) and sum(second.values()) > sum(first.values())
    assert all(second[n] >= first[n] for n in first)
    # each scene's rows stay within the cap: ori + pseudo <= 64
    by_scan = {}
    for s in steps:
        for scan, present, ori in zip(s["scans"], s["present"], s["ori"]):
            by_scan.setdefault(s["epoch"], {})[scan] = (present, ori)
    for name, n in second.items():
        scan = int(name.split("_")[1])
        assert by_scan[3][scan][1] + n <= 64
    # epoch 0 trains on the ground truth alone; epochs 1 and 3 on the merged rows
    assert all(p == o for p, o in by_scan[0].values())
    for epoch, written in ((1, first), (3, second)):
        for name, n in written.items():
            scan = int(name.split("_")[1])
            present, ori = by_scan[epoch][scan]
            assert present == min(ori + n, 64), (epoch, name, present, ori, n)
    assert any(p > o for p, o in by_scan[1].values())


def test_lr_replays_the_jax_schedule(stage2_run):
    steps = stage2_run["steps"]
    args = tmain.make_args_parser().parse_args(STAGE2_FLAGS)
    host = jax_make_lr_schedule(args, IPE, host=True)
    want = [host((e % 2) * IPE + it) for e in range(EPOCHS) for it in range(IPE)]
    assert [s["lr"] for s in steps] == want
    assert [s["curr"] for s in steps] == [e % 2 for e in range(EPOCHS) for _ in range(IPE)]
    cycle = 2 * IPE
    assert want[:cycle] == want[cycle:] and want[cycle] == want[0] < want[cycle - 1]


def test_stage2_artifacts(stage2_run):
    names = sorted(os.listdir(stage2_run["tmp"] / "stage2"))
    names = [n for n in names if not n.startswith("events.out")]
    want = ["checkpoint.pth", "checkpoint_0000.pth", "checkpoint_0001.pth", "checkpoint_0002.pth",
            "checkpoint_0003.pth", "checkpoint_best.pth", "eval_0002.lst", "eval_0003.lst",
            "final_eval.pkl", "final_eval.txt", "last_checkpoint.pth", "metrics.jsonl",
            "synthetic_pseudo_labels_setting0"]
    assert names == want
    ckpt = torch.load(stage2_run["tmp"] / "stage2" / "last_checkpoint.pth", weights_only=True)
    assert ckpt["epoch"] == EPOCHS - 1 and ckpt["optimizer"]["count"] == EPOCHS * IPE
    # Train_details/ scalars every --log_every (2) iterations at the optimizer's
    # step count after the step, Train/ once an epoch
    with open(stage2_run["tmp"] / "stage2" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    details = [r["step"] for r in records if "Train_details/loss" in r]
    assert details == [e * IPE + it + 1 for e in range(EPOCHS) for it in (0, 2)]
    assert [r["step"] for r in records if "Train/loss" in r] == list(range(EPOCHS))


def test_profile_dir_traces_iterations_2_to_5(tmp_path):
    calls = []

    def step(batch, generator):
        calls.append(batch["lr"])
        return {"loss": torch.tensor(1.0)}

    host = [{"point_clouds": np.zeros((1, 2, 3), np.float32)}] * 7
    engine.train_one_epoch(step, host, lr_fn=float, device="cpu", log=lambda s: None,
                           profile_dir=str(tmp_path / "trace"))
    assert calls == [float(i) for i in range(7)]
    assert os.path.getsize(tmp_path / "trace" / "train_trace.json") > 0
