"""The port's secondary modes against the JAX package's on the CPU.

Each mode flag goes through `main` of both packages with the same weights (a
`.pth` exported from a perturbed flax init of the tiny detector of
tests/test_torch_port_model.py), the same tiny CLIP (its flax weights
carried into the port) and the same synthetic split with images.  Every file
the JAX mode writes, the port's writes under the same name: floats within
1e-5 (the numbers in PLY/OBJ text, .npy arrays), integers equal (OBJ edges,
the confusion matrix).  The PNG crops' pixels are equal but where the
resize lands within float rounding of a half, as in
tests/test_torch_port_clip.py: at most 1 apart, on fewer than 1 in 10^4
pixels.  The checkpoint's no-object bias is lowered by 4 so that boxes pass
the modes' objectness gates (0.5, 0.05).

The expected difference: the JAX package's run_mode keeps its loader's
drop_last, so on a test split of 5 scenes at batch 2 it writes 4 scenes'
files; the port pads the tail and honours pad_mask, so it also writes the
fifth scene's, and nothing twice.
"""

import os
import re
import types

import numpy as np
import pytest
import torch

import jax

from coda_neurips2023_tpu import main as jmain
from coda_neurips2023_tpu import stages as jstages
from coda_neurips2023_tpu.datasets.loader import collate
from coda_neurips2023_tpu.datasets.synthetic import SyntheticDetectionDataset as JaxScenes
from coda_neurips2023_tpu.datasets.config import SunrgbdAnonymousConfig as JaxConfig
from coda_neurips2023_tpu.models import clip as jclip
from coda_neurips2023_tpu.utils.torch_convert import export_reference_state_dict

from coda_neurips2023_tpu_torch import main as tmain
from coda_neurips2023_tpu_torch import stages

from test_torch_port_clip import TINY_CLIP, _port_clip
from test_torch_port_model import TINY, _build
from torch_one_thread import one_intra_op_thread  # noqa: F401

FLOAT_TOL = 1e-5
SCENES = 20  # a test split of 5: two batches of 2 and a tail of 1
BATCH = 2
NUM_POINTS = 1024
MODES = {
    # mode: (extra flags, output dir under --checkpoint_dir or None)
    "show_only": ([], "show"),
    "show_only_after_nms": (["--if_after_nms"], "show"),
    "show_box_points": ([], "box_points"),
    "save_novel_with_class_only": (["--save_objectness", "0", "--clip_driven_keep_thres", "0"],
                                   None),
    "save_seen_feat_only": ([], "seen_feats"),
    "crop_only": ([], "crops"),
    "cal_class_only": ([], None),
}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    ds = JaxScenes(JaxConfig(), num_scenes=2, num_points=NUM_POINTS, seed=3)
    batch = collate([ds[i] for i in range(2)])
    pts = {k: batch[k] for k in ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")}
    _, variables, _, _ = _build(TINY, pts, seed=2)
    sd = export_reference_state_dict(variables["params"], variables["batch_stats"],
                                     variables["constants"])
    last = max((k for k in sd if k.startswith("mlp_heads.sem_cls_head.") and k.endswith(".bias")),
               key=lambda k: int(k.split(".")[-2]))
    sd[last] = np.asarray(sd[last]).copy()
    sd[last][-1] -= 4.0  # the no-object logit
    path = tmp_path_factory.mktemp("modes") / "tiny.pth"
    torch.save({"model": {k: torch.from_numpy(np.asarray(v).copy()) for k, v in sd.items()},
                "epoch": 0}, path)
    return path


def _argv(mode, out, ckpt):
    flag = "show_only" if mode == "show_only_after_nms" else mode
    # the confusion matrix sums over scenes: compare it on a split with no tail
    scenes = 4 * 2 * BATCH if mode == "cal_class_only" else SCENES
    return [
        "--test_only", f"--{flag}", *MODES[mode][0], "--dataset_name", "synthetic",
        "--synthetic_num_scenes", str(scenes), "--num_points", str(NUM_POINTS),
        "--batchsize_per_gpu_test", str(BATCH), "--if_input_image", "--test_ckpt", str(ckpt),
        "--checkpoint_dir", str(out), "--if_use_v1",
        *[x for k, v in TINY.items() for x in (f"--{k}", str(v))],
    ]


def _run_both(mode, tmp_path, ckpt, monkeypatch):
    """Both packages' main on the mode: (JAX result, port result)."""
    contexts = {}
    jstages_cls, stages_cls = jstages.StageContext, stages.StageContext

    def jax_ctx(args, cfg):
        contexts["jax"] = jstages_cls(args, cfg, clip_model=jclip.CLIP(**TINY_CLIP), crop_size=16)
        return contexts["jax"]

    def port_ctx(args, cfg, device="cuda"):
        params = jax.tree.map(np.asarray, contexts["jax"].clip_variables["params"])
        return stages_cls(args, cfg, clip_model=_port_clip(TINY_CLIP, params), crop_size=16,
                          device=device)

    monkeypatch.setattr(jstages, "StageContext", jax_ctx)
    monkeypatch.setattr(stages, "StageContext", port_ctx)
    want = jmain.main(_argv(mode, tmp_path / "jax", ckpt))
    got = tmain.main(_argv(mode, tmp_path / "port", ckpt), device="cpu")
    return want, got


_NUMBER = re.compile(r"-?\d+\.\d+")


def _assert_text_close(got, want, what):
    """Equal text but for its decimal numbers, which agree within FLOAT_TOL."""
    assert _NUMBER.sub("#", got) == _NUMBER.sub("#", want), what
    g = np.array(_NUMBER.findall(got), np.float64)
    w = np.array(_NUMBER.findall(want), np.float64)
    np.testing.assert_allclose(g, w, rtol=0, atol=FLOAT_TOL + 2e-6, err_msg=what)


def _assert_files_match(got_dir, want_dir):
    """Every file of the JAX mode, and the port's extra files only for the
    tail scene (scan index 4) the JAX loader drops."""
    import cv2

    want_files, got_files = sorted(os.listdir(want_dir)), sorted(os.listdir(got_dir))
    assert want_files, "the JAX mode wrote nothing: the comparison would be empty"
    extra = set(got_files) - set(want_files)
    assert set(want_files) <= set(got_files)
    assert all("000004" in f for f in extra), sorted(extra)
    for name in want_files:
        g, w = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if name.endswith(".npy"):
            ga, wa = np.load(g), np.load(w)
            assert ga.shape == wa.shape and ga.dtype == wa.dtype, name
            np.testing.assert_allclose(ga, wa, rtol=0, atol=FLOAT_TOL, err_msg=name)
        elif name.endswith(".png"):
            ga, wa = cv2.imread(g).astype(np.int64), cv2.imread(w).astype(np.int64)
            assert np.abs(ga - wa).max() <= 1 and (ga != wa).mean() < 1e-4, name
        else:
            _assert_text_close(open(g).read(), open(w).read(), name)
    return extra


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_writes_what_the_jax_mode_writes(mode, tmp_path, ckpt, monkeypatch):
    if mode == "crop_only":
        pytest.importorskip("cv2")
    monkeypatch.setenv("CODA_AP_WORKERS", "0")
    want, got = _run_both(mode, tmp_path, ckpt, monkeypatch)
    sub = MODES[mode][1]
    if mode == "cal_class_only":
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, np.asarray(want))
        assert got.sum() > 0
        return
    if mode == "save_novel_with_class_only":
        # the test split has no pseudo-label paths: both find rows, write none
        assert not os.path.exists(tmp_path / "jax" / "synthetic_pseudo_labels_setting0")
        assert got >= want  # the port also runs the tail scene
        return
    extra = _assert_files_match(tmp_path / "port" / sub, tmp_path / "jax" / sub)
    if mode.startswith("show_only"):
        assert (want, got) == (4, 5)
        assert "000004_pc.ply" in extra
    elif mode == "save_seen_feat_only":
        assert got > want > 0 and extra == {"000004_seen_feat.npy"}
    elif mode == "crop_only":
        assert (want, got) == (4 * 8, 5 * 8)


def test_save_novel_boxes_without_images_finds_nothing_as_jax():
    """Without --if_input_image a batch has no image and no pseudo-label
    path: discovery does not run and nothing is written (the JAX
    StageContext's guard), on a padded batch too."""
    from coda_neurips2023_tpu_torch import modes
    from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
    from coda_neurips2023_tpu_torch.datasets.loader import make_loader
    from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset
    from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
    from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR

    ds = SyntheticDetectionDataset(SunrgbdAnonymousConfig(), num_scenes=3, num_points=256)
    batches = list(make_loader(ds, 2, drop_last=False, pad_last=True, num_workers=1))
    assert "pseudo_box_path" not in batches[0] and "pad_mask" in batches[-1]
    model = reset_parameters(CoDA3DETR(SunrgbdAnonymousConfig(), **TINY),
                             torch.Generator().manual_seed(0))
    seen = []

    def run_discovery_and_write(discovery, last, batch):  # StageContext's guard
        seen.append(len(last["objectness_prob"]))
        assert "input_image" not in batch and "pseudo_box_path" not in batch
        return 0

    ctx = types.SimpleNamespace(discovery_fn=lambda: None,
                                run_discovery_and_write=run_discovery_and_write)
    assert modes.save_novel_boxes(model, batches, ctx, device="cpu") == 0
    assert seen == [2, 1]  # the padded row dropped
