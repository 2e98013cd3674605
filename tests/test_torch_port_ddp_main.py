"""The port's training entry point over 2 ranks against the JAX package's at
--ngpus 2, on the CPU.

`main` of both packages with the flags of scripts/coda_baseline_sunrgbd.sh
as tests/test_torch_port_train_loop.py runs them (tiny widths, dropout 0,
8 synthetic scenes, 2 epochs, the tiny CLIP, one `.pth` exported from the
JAX package's init as --checkpoint_file), at --ngpus 2 and
--batchsize_per_gpu 2: the JAX package on a mesh of 2 of conftest's 8
virtual CPU devices, a global batch of 4 (2 steps an epoch); the port in 2
gloo processes, each rank running `main` on its rows
(tests/torch_ddp_ranks.py :: run_main).  Held, as the R = 1 test holds them:

  * the same batches: each step's scans of rank 0 then rank 1 are the JAX
    package's global batch, in order;
  * each step's learning rate equal, on both ranks;
  * step k's loss (the all-reduced sum of the ranks' shares, equal on both
    ranks) within STEP_LOSS_TOL + k * STEP_DRIFT_TOL of the JAX package's;
  * the final weights and BatchNorm statistics within WEIGHT_TOL of their
    norm, and bit-equal on the two ranks;
  * the artifacts written once, by rank 0: the JAX package's names, and one
    metrics.jsonl record a logged step.
"""

import json
import os

import numpy as np
import pytest

import jax

from coda_neurips2023_tpu import engine as jengine
from coda_neurips2023_tpu import main as jmain
from coda_neurips2023_tpu import stages as jstages
from coda_neurips2023_tpu.models import clip as jclip
from coda_neurips2023_tpu.utils.torch_convert import export_reference_state_dict

from coda_neurips2023_tpu_torch.parallel import ddp

import torch_ddp_ranks
from test_torch_port_clip import TINY_CLIP
from test_torch_port_train_loop import (
    BASELINE_FLAGS,
    STEP_DRIFT_TOL,
    STEP_LOSS_TOL,
    WEIGHT_TOL,
    _export_jax_init,
)
from torch_one_thread import one_intra_op_thread  # noqa: F401

WORLD = 2
PER_RANK = 2
SCENES = 8
EPOCHS = 2
LOG_EVERY = 2
IPE = SCENES // (PER_RANK * WORLD)


def with_flags(flags, **values):
    """`flags` with the value after each --name of `values` replaced."""
    flags = list(flags)
    for name, value in values.items():
        flags[flags.index(f"--{name}") + 1] = str(value)
    return flags


FLAGS = with_flags(BASELINE_FLAGS, ngpus=WORLD, batchsize_per_gpu=PER_RANK, log_every=LOG_EVERY,
                   synthetic_num_scenes=SCENES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_main")
    ckpt = tmp / "init.pth"
    _export_jax_init(ckpt)
    dirs = {side: tmp / side for side in ("jax", "port")}
    contexts, steps = {}, []
    mp = pytest.MonkeyPatch()
    mp.setenv("CODA_AP_WORKERS", "0")
    jstages_cls, jmake = jstages.StageContext, jengine.make_train_step

    def jax_ctx(args, cfg):
        contexts["jax"] = jstages_cls(args, cfg, clip_model=jclip.CLIP(**TINY_CLIP), crop_size=16)
        return contexts["jax"]

    def jax_make(*a, **kw):
        step = jmake(*a, **kw)

        def recorded(state, batch, rng):
            state, metrics = step(state, batch, rng)
            steps.append((np.asarray(batch["scan_idx"]).tolist(), np.float32(metrics["lr"]),
                          float(metrics["loss"])))
            return state, metrics

        return recorded

    mp.setattr(jstages, "StageContext", jax_ctx)
    mp.setattr(jengine, "make_train_step", jax_make)
    out = tmp / "ranks"
    out.mkdir()
    try:
        state = jmain.main(FLAGS + ["--checkpoint_file", str(ckpt),
                                    "--checkpoint_dir", str(dirs["jax"])])
        clip_params = jax.tree.map(np.asarray, contexts["jax"].clip_variables["params"])
        url = ddp.free_url()
        port_argv = FLAGS + ["--checkpoint_file", str(ckpt), "--checkpoint_dir",
                             str(dirs["port"]), "--dist_url", url]
        ddp.launch(torch_ddp_ranks.run_main, WORLD, str(out), port_argv, TINY_CLIP, clip_params,
                   devices=["cpu"] * WORLD, backend="gloo", dist_url=url)
    finally:
        mp.undo()
    want = export_reference_state_dict(jax.tree.map(np.asarray, state.params),
                                       jax.tree.map(np.asarray, state.batch_stats),
                                       jax.tree.map(np.asarray, state.constants))
    return dict(jax_steps=steps, ranks=torch_ddp_ranks.load_ranks(str(out), WORLD), want=want,
                dirs=dirs)


def test_each_step_takes_the_jax_global_batch_and_learning_rate(runs):
    jax_steps, ranks = runs["jax_steps"], runs["ranks"]
    assert len(jax_steps) == EPOCHS * IPE
    assert all(len(r["steps"]) == len(jax_steps) for r in ranks)
    for k, (scans, lr, _) in enumerate(jax_steps):
        assert ranks[0]["steps"][k]["scans"] + ranks[1]["steps"][k]["scans"] == scans, k
        assert all(r["steps"][k]["lr"] == lr for r in ranks), k


@pytest.mark.parametrize("step", range(EPOCHS * IPE))
def test_each_step_loss_matches_jax(runs, step):
    jloss = runs["jax_steps"][step][2]
    losses = [r["steps"][step]["loss"] for r in runs["ranks"]]
    assert losses[0] == losses[1]  # the all-reduced loss, alike on both ranks
    assert abs(losses[0] - jloss) <= STEP_LOSS_TOL + step * STEP_DRIFT_TOL, (
        f"step {step}: loss {losses[0]!r} against {jloss!r}: beyond the step's fp32 rounding, "
        "most likely a matcher assignment flipped between the packages")


def test_final_weights_match_jax_and_each_other(runs):
    want = runs["want"]
    got = [r["result"] for r in runs["ranks"]]
    names = [k for k in want if not k.endswith("num_batches_tracked")]
    assert set(names) <= set(got[0])
    diff = np.sqrt(sum(np.sum((got[0][k].astype(np.float64) - want[k]) ** 2) for k in names))
    norm = np.sqrt(sum(np.sum(np.asarray(want[k], np.float64) ** 2) for k in names))
    assert diff / norm <= WEIGHT_TOL, diff / norm
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)


def test_rank_zero_writes_the_artifacts_once(runs):
    jax_names = {n for n in os.listdir(runs["dirs"]["jax"])
                 if not n.endswith(".meta.json") and not n.startswith("events.out")}
    files = [n for n in os.listdir(runs["dirs"]["port"]) if not n.startswith("events.out")]
    port_names = {n[: -len(".pth")] if n.endswith(".pth") else n for n in files}
    assert port_names == jax_names
    assert not [n for n in files if n.endswith(".tmp")]
    with open(runs["dirs"]["port"] / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    details = [r["step"] for r in records if "Train_details/loss" in r]
    assert details == [e * IPE + it + 1 for e in range(EPOCHS) for it in range(0, IPE, LOG_EVERY)]
    assert [r["step"] for r in records if "Train/loss" in r] == list(range(EPOCHS))
    assert (runs["dirs"]["port"] / "final_eval.txt").read_text().startswith("mAP0.25")
