"""Stage 2 through the port's training entry point over 2 ranks against one
process, on the CPU.

`main` with scripts/coda_sunrgbd_stage2.sh's flags as
tests/test_torch_port_stage2_loop.py runs them (tiny widths, 16 synthetic
scenes, --reset_epoch_periodically 2 and --online_nms_update_save_epoch 2,
so discovery runs at epoch 0 and epoch 1 trains on its rows), over 2
epochs with dropout 0, the pinned tower of that test (a seeded random
superset bank whose row 20 the image tower returns for every crop) and a
pinned crop selection (each scene's first --distillation_box_num
proposals): once at --ngpus 2 and --batchsize_per_gpu 2 in 2 gloo processes,
where each rank writes the pseudo-label files of its own scenes, and once
in one process at --batchsize_per_gpu 4, the same global batch.  Held: the
same pseudo-label files, row for row (boxes within BOX_TOL), and the final
weights within the training loop test's WEIGHT_TOL of their norm.

And `main` itself returns a model at R = 2 as at R = 1: rank 0's trained
weights cross to the launching process and come back in a model built there.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax

from coda_neurips2023_tpu_torch import stages
from coda_neurips2023_tpu_torch import main as tmain
from coda_neurips2023_tpu_torch.parallel import ddp

import torch_ddp_ranks
from test_torch_port_clip import TINY_CLIP, _jax_clip
from test_torch_port_ddp_main import FLAGS as BASELINE_FLAGS
from test_torch_port_ddp_main import with_flags
from test_torch_port_stage2_loop import NOVEL_ROW, STAGE2_FLAGS
from test_torch_port_train_loop import WEIGHT_TOL

WORLD = 2
PER_RANK = 2
EPOCHS = 2
# the two runs' boxes differ by the float rounding of the BatchNorm
# statistics and gradients summed over two ranks against one batch
BOX_TOL = 1e-4
FLAGS = with_flags(STAGE2_FLAGS, max_epoch=EPOCHS, set_epoch=0) + [
    "--enc_dropout", "0", "--dec_dropout", "0", "--mlp_dropout", "0"]
PSEUDO = "synthetic_pseudo_labels_setting0"


@pytest.fixture(scope="module")
def clip_params():
    _, params = _jax_clip(TINY_CLIP)
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, clip_params):
    tmp = tmp_path_factory.mktemp("ddp_stage2")
    params = clip_params
    pinned = {"row": NOVEL_ROW}
    mp = pytest.MonkeyPatch()
    mp.setenv("CODA_AP_WORKERS", "0")
    out = tmp / "ranks"
    out.mkdir()
    try:
        url = ddp.free_url()
        argv = with_flags(FLAGS, ngpus=WORLD, batchsize_per_gpu=PER_RANK) + [
            "--checkpoint_dir", str(tmp / "two"), "--dist_url", url]
        ddp.launch(torch_ddp_ranks.run_main, WORLD, str(out), argv, TINY_CLIP, params, pinned,
                   devices=["cpu"] * WORLD, backend="gloo", dist_url=url)
        mp.setattr(stages, "StageContext", torch_ddp_ranks.tiny_clip_context(
            stages.StageContext, TINY_CLIP, params, pinned))
        tmain.main(with_flags(FLAGS, ngpus=1, batchsize_per_gpu=PER_RANK * WORLD) + [
            "--checkpoint_dir", str(tmp / "one")], device="cpu")
    finally:
        mp.undo()
    return tmp


def _pseudo(run_dir):
    d = run_dir / PSEUDO
    return {n: np.load(d / n) for n in sorted(os.listdir(d))}


def test_same_pseudo_label_files(runs):
    two, one = _pseudo(runs / "two"), _pseudo(runs / "one")
    assert one and sum(len(v) for v in one.values()) > 0, "discovery wrote no rows"
    assert list(two) == list(one)
    for name, want in one.items():
        assert two[name].shape == want.shape, name
        np.testing.assert_allclose(two[name], want, rtol=0, atol=BOX_TOL, err_msg=name)


def test_same_final_weights(runs):
    got, want = (torch.load(runs / d / "last_checkpoint.pth", weights_only=True)["model"]
                 for d in ("two", "one"))
    names = [k for k in want if not k.endswith("num_batches_tracked")]
    diff = np.sqrt(sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in names))
    norm = np.sqrt(sum(float((want[k].double() ** 2).sum()) for k in names))
    assert diff / norm <= WEIGHT_TOL, diff / norm


def test_main_returns_a_model_at_every_world_size(clip_params, tmp_path, monkeypatch):
    """The baseline's main(--ngpus 2, cpu_devices=2) returns a model holding
    rank 0's trained weights, as main at R = 1 returns its model.  The launch
    here runs the rank function in this process (one rank, pickled back as
    ddp.launch returns it): the ranks themselves are the tests above; this
    is the way back to the caller."""
    monkeypatch.setenv("CODA_AP_WORKERS", "0")
    monkeypatch.setattr(stages, "StageContext", torch_ddp_ranks.tiny_clip_context(
        stages.StageContext, TINY_CLIP, clip_params))
    launched = []

    def launch(fn, world, *args, devices, backend, dist_url):
        launched.append((world, devices, backend))
        return pickle.loads(pickle.dumps(fn(*args)))

    monkeypatch.setattr(ddp, "launch", launch)
    model = tmain.main(with_flags(BASELINE_FLAGS, max_epoch=1) + [
        "--checkpoint_dir", str(tmp_path), "--dist_url", ddp.free_url()],
        device="cpu", cpu_devices=WORLD)
    assert launched == [(WORLD, ["cpu"] * WORLD, "gloo")]
    assert isinstance(model, torch.nn.Module)
    want = torch.load(tmp_path / "last_checkpoint.pth", weights_only=True)["model"]
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.device.type == "cpu"
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
