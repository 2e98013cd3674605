"""The port's eval entry point against the JAX package on the CPU.

At small sizes (the tiny detector of tests/test_torch_port_model.py, 1024
points a scene, a tiny CLIP for the text bank) the same numpy inputs go
through the JAX package and the port:
  * the AP stack (`parse_predictions`, `eval_det`, `compute_metrics`) on the
    same predictions: equal, since both are the same numpy code;
  * the port's host library (NMS, rotated IoU) against its numpy versions,
    built outside the JAX package's `native/`;
  * the SUN RGB-D dataset on fixture scans and the loader with both
    backends: samples and batches bit-equal;
  * `engine.evaluate` with one fake eval step: every scan metered;
  * `main --test_only --test_ckpt x.pth` of both packages on one synthetic
    split: eval outputs within 1e-4 (the tolerance of
    tests/test_torch_port_model.py), metrics within 5e-3;
  * the flag set, the checkpoint errors and what raises.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from coda_neurips2023_tpu import engine as jengine
from coda_neurips2023_tpu import main as jmain
from coda_neurips2023_tpu import stages as jstages
from coda_neurips2023_tpu.datasets import loader as jloader
from coda_neurips2023_tpu.datasets.config import SunrgbdAnonymousConfig as JaxConfig
from coda_neurips2023_tpu.datasets.config import SunrgbdImageConfig as JaxImageConfig
from coda_neurips2023_tpu.datasets.sunrgbd import SunrgbdDetectionDataset as JaxSunrgbd
from coda_neurips2023_tpu.datasets.synthetic import SyntheticDetectionDataset as JaxScenes
from coda_neurips2023_tpu.models import clip as jclip
from coda_neurips2023_tpu.utils import ap_calculator as jap
from coda_neurips2023_tpu.utils import eval_det as jeval_det
from coda_neurips2023_tpu.utils.torch_convert import export_reference_state_dict

from coda_neurips2023_tpu_torch import engine, native, stages
from coda_neurips2023_tpu_torch import main as tmain
from coda_neurips2023_tpu_torch.datasets import build_dataset
from coda_neurips2023_tpu_torch.datasets import loader as tloader
from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig, SunrgbdImageConfig
from coda_neurips2023_tpu_torch.datasets.sunrgbd import SunrgbdDetectionDataset
from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset
from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
from coda_neurips2023_tpu_torch.utils import ap_calculator as tap
from coda_neurips2023_tpu_torch.utils import eval_det as teval_det
from coda_neurips2023_tpu_torch.utils import nms as tnms
from coda_neurips2023_tpu_torch.utils.io import restore_params_only

from test_torch_port_clip import TINY_CLIP, _port_clip
from test_torch_port_model import TINY, _assert_no_boundary_flip, _build
from torch_one_thread import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
OUTPUT_TOL = 1e-4
# the metrics of two frameworks' forwards: AP is a step function of the
# boxes (IoU > 0.25, confidence > 0.05, the NMS overlap), and the boxes
# differ by ~1e-6, so a box at a threshold may count on one side only; the
# release dry run's tolerance (tests/test_release_dryrun.py)
METRIC_TOL = 5e-3
NCLS = 46
NUM_POINTS = 1024
BATCH = 4
SCENES = 4 * 2 + 3  # two full batches and a tail of 3 padded to 4


# ------------------------------------------------------------------ helpers


def _predictions(num_scans, nq, ncls, seed):
    """Synthetic scenes with random ground-truth classes, and predictions
    near their ground truth (half of the proposals a jittered ground-truth
    box, the rest random boxes), so that AP is not trivially zero."""
    ds = JaxScenes(JaxConfig(), num_scenes=num_scans, num_points=NUM_POINTS, seed=seed)
    batch = jloader.collate([ds[i] for i in range(num_scans)])
    rng = np.random.default_rng(seed)
    present = batch["gt_box_present"]
    labels = (rng.integers(0, ncls, present.shape) * present).astype(np.int64)
    gt = batch["gt_box_corners"]
    corners = np.zeros((num_scans, nq, 8, 3), np.float32)
    for i in range(num_scans):
        real = np.flatnonzero(present[i])
        for j in range(nq):
            if j % 2 == 0:
                box = gt[i, real[j // 2 % len(real)]]
                corners[i, j] = box + rng.normal(0, 0.03, (1, 3))
            else:
                c = rng.uniform(-3, 3, 3)
                corners[i, j] = c + rng.uniform(0.2, 1.0, 3) * rng.choice([-1, 1], (8, 3))
    logits = rng.normal(size=(num_scans, nq, ncls))
    for i in range(num_scans):
        real = np.flatnonzero(present[i])
        for j in range(0, nq, 2):
            logits[i, j, labels[i, real[j // 2 % len(real)]]] += 4.0
    sem = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    outputs = {
        "box_corners": corners,
        "sem_cls_prob": sem.astype(np.float32),
        "objectness_prob": rng.uniform(0, 1, (num_scans, nq)).astype(np.float32),
    }
    targets = {
        "point_clouds": batch["point_clouds"],
        "gt_box_corners": gt,
        "gt_box_sem_cls_label": labels,
        "gt_box_present": present,
    }
    return outputs, targets


def _assert_metrics_equal(got, want):
    assert list(got) == list(want)
    for thresh in want:
        assert list(got[thresh]) == list(want[thresh]), thresh
        for key, w in want[thresh].items():
            g = got[thresh][key]
            assert (g == w) or (np.isnan(g) and np.isnan(w)), (thresh, key, g, w)


def _assert_metrics_close(got, want, tol):
    assert list(got) == list(want)
    for thresh in want:
        assert set(got[thresh]) == set(want[thresh]), thresh
        for key, w in want[thresh].items():
            assert abs(float(got[thresh][key]) - float(w)) <= tol, (thresh, key)


# ------------------------------------------------------------------ AP stack


@pytest.mark.parametrize("no_nms", [False, True], ids=["nms", "no_nms"])
def test_ap_stack_equals_jax(monkeypatch, no_nms):
    """parse_predictions, eval_det and compute_metrics of the two packages on
    the same predictions: the same lists, curves and metric dicts."""
    monkeypatch.setenv("CODA_AP_WORKERS", "0")
    outputs, targets = _predictions(5, 24, NCLS, seed=1)
    jcfg, tcfg = JaxImageConfig(), SunrgbdImageConfig()
    jconf = jap.get_ap_config_dict(dataset_config=jcfg, no_nms=no_nms)
    tconf = tap.get_ap_config_dict(dataset_config=tcfg, no_nms=no_nms)
    args = (outputs["box_corners"], outputs["sem_cls_prob"], outputs["objectness_prob"],
            targets["point_clouds"])
    want = jap.parse_predictions(*args, jconf, parallel=False)
    got = tap.parse_predictions(*args, tconf, parallel=False)
    assert len(got) == len(want) == 5
    assert sum(map(len, got)) > 0
    for g_scan, w_scan in zip(got, want):
        assert len(g_scan) == len(w_scan)
        for (gc, gb, gs), (wc, wb, ws) in zip(g_scan, w_scan):
            assert gc == wc and gs == ws
            np.testing.assert_array_equal(gb, wb)

    gt_map = jap.APCalculator.make_gt_list(
        targets["gt_box_corners"], targets["gt_box_sem_cls_label"], targets["gt_box_present"])
    pred_map = dict(enumerate(want))
    gt_all = dict(enumerate(gt_map))
    for thresh in (0.25, 0.5):
        wr, wp, wa = jeval_det.eval_det(pred_map, gt_all, ovthresh=thresh)
        gr, gp, ga = teval_det.eval_det(pred_map, gt_all, ovthresh=thresh)
        assert list(ga) == list(wa)
        for k in wa:
            np.testing.assert_array_equal(gr[k], wr[k])
            np.testing.assert_array_equal(gp[k], wp[k])
            assert ga[k] == wa[k]
    assert max(wa.values()) > 0, "AP trivially zero: the test would not see a difference"

    jcalc = jap.APCalculator(jcfg, ap_iou_thresh=[0.25, 0.5], ap_config_dict=jconf)
    tcalc = tap.APCalculator(tcfg, ap_iou_thresh=[0.25, 0.5], ap_config_dict=tconf)
    jcalc.step_meter({"outputs": outputs}, targets)
    tcalc.step_meter({"outputs": outputs}, targets)
    got_m, want_m = tcalc.compute_metrics(), jcalc.compute_metrics()
    _assert_metrics_equal(got_m, want_m)
    assert want_m[0.25]["mAP"] > 0
    assert tcalc.metrics_to_str(got_m) == jcalc.metrics_to_str(want_m)


def test_ap_pool_equals_serial_and_never_imports_torch(monkeypatch):
    """The per-scan worker pool gives the serial path's predictions bit for
    bit, its workers report their timings and library NMS back, and the
    modules a worker imports never import torch."""
    outputs, targets = _predictions(3, 16, NCLS, seed=2)
    conf = tap.get_ap_config_dict(dataset_config=SunrgbdImageConfig())
    args = (outputs["box_corners"], outputs["sem_cls_prob"], outputs["objectness_prob"],
            targets["point_clouds"], conf)
    serial = tap.parse_predictions(*args, parallel=False)
    monkeypatch.setenv("CODA_AP_WORKERS", "2")
    tap.close_pool()
    try:
        tap.reset_meter()
        pooled = tap.parse_predictions(*args)
        assert tap._AP_POOL, "the pool did not start"
    finally:
        tap.close_pool()
    assert tap.METER["scans"] == 3 and tap.METER["native_nms_scans"] == 3
    assert tap.METER["in_hull_s"] > 0 and tap.METER["parse_s"] > 0
    for s_scan, p_scan in zip(serial, pooled):
        assert [(c, s) for c, _, s in s_scan] == [(c, s) for c, _, s in p_scan]
        for (_, sb, _), (_, pb, _) in zip(s_scan, p_scan):
            np.testing.assert_array_equal(sb, pb)
    code = (
        "import sys\n"
        "import coda_neurips2023_tpu_torch.utils.ap_calculator\n"
        "import coda_neurips2023_tpu_torch.native\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_ap_worker_caps_blas_at_one_thread():
    """The pool's initializer finds the BLAS libraries numpy and scipy
    loaded and caps each at one thread (in a fresh process, as a worker)."""
    pytest.importorskip("threadpoolctl")
    code = (
        "import threadpoolctl\n"
        "from coda_neurips2023_tpu_torch.utils import ap_calculator\n"
        "blas = [p for p in threadpoolctl.threadpool_info() if p['user_api'] == 'blas']\n"
        "assert blas, 'no BLAS library loaded'\n"
        "ap_calculator._one_blas_thread()\n"
        "after = [p['num_threads'] for p in threadpoolctl.threadpool_info()\n"
        "         if p['user_api'] == 'blas']\n"
        "assert after == [1] * len(blas), after\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, OPENBLAS_NUM_THREADS="4"))
    assert proc.returncode == 0, proc.stderr


def test_native_host_library_matches_numpy():
    """The port's library, built in build/torch_kernels/: same-class NMS
    keeps what the numpy NMS keeps, the rotated IoU agrees with the numpy
    eval path; the JAX package's native/libcoda_native.so is not touched."""
    jax_lib = ROOT / "native" / "libcoda_native.so"
    before = (jax_lib.stat().st_mtime_ns, jax_lib.stat().st_size)
    assert native.available()
    assert native.LIBRARY.parent == ROOT / "build" / "torch_kernels"
    rng = np.random.default_rng(3)
    for trial in range(5):
        k = 60
        lo = rng.uniform(-2, 2, (k, 3))
        hi = lo + rng.uniform(0.1, 1.5, (k, 3))
        score = rng.permutation(k).astype(np.float64) / k  # distinct: no tie order in play
        cls = rng.integers(0, 3, k).astype(np.float64)
        boxes = np.concatenate([lo, hi, score[:, None], cls[:, None]], axis=1)
        boxes = boxes.astype(np.float32).astype(np.float64)
        want = sorted(tnms.nms_3d_faster_samecls(boxes, 0.25))
        got = native.nms_3d_samecls(boxes.astype(np.float32), 0.25).tolist()
        assert got == want, trial
    outputs, targets = _predictions(2, 12, 4, seed=4)
    for bb in outputs["box_corners"].reshape(-1, 8, 3)[:12]:
        gts = targets["gt_box_corners"][0][:5].astype(np.float32)
        want = np.array([teval_det.box3d_iou(bb.astype(np.float64), g.astype(np.float64))[0]
                         for g in gts])
        # the library takes the corners as float32 and subtracts them there
        # (edge lengths, as the JAX package's library does): ~1e-8 relative
        np.testing.assert_allclose(native.box3d_iou_eval_batch(bb, gts), want, rtol=1e-6,
                                   atol=1e-9)
    assert (jax_lib.stat().st_mtime_ns, jax_lib.stat().st_size) == before


# ------------------------------------------------------------------ data


def _sunrgbd_fixture(root, split, n_scans, seed, with_images):
    """Scans in the reference's on-disk format, as tests/test_datasets.py
    writes them: {root}_{split}/{scan}_pc.npz, _bbox.npy, calib and images."""
    rng = np.random.default_rng(seed)
    data_dir = root / f"sunrgbd_pc_{split}"
    calib_dir, image_dir = root / "calib", root / "image"
    for d in (data_dir, calib_dir, image_dir):
        d.mkdir(parents=True, exist_ok=True)
    for i in range(n_scans):
        scan = f"{seed * 100 + i:06d}"
        pc = rng.uniform(-3, 3, (1500, 6)).astype(np.float32)
        np.savez(data_dir / (scan + "_pc.npz"), pc=pc)
        k = rng.integers(1, 6)
        boxes = np.zeros((k, 8))
        boxes[:, 0:3] = rng.uniform(-2, 2, (k, 3))
        boxes[:, 3:6] = rng.uniform(0.2, 0.8, (k, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, k)
        boxes[:, 7] = rng.integers(0, 30, k)
        np.save(data_dir / (scan + "_bbox.npy"), boxes)
        rtilt = np.eye(3).reshape(-1, order="F")
        kmat = np.array([[520.0, 0, 360], [0, 520.0, 260], [0, 0, 1]]).reshape(-1, order="F")
        (calib_dir / (scan + ".txt")).write_text(
            " ".join(str(x) for x in rtilt) + "\n" + " ".join(str(x) for x in kmat) + "\n")
        if with_images:
            import cv2

            img = rng.integers(0, 255, (480, 640, 3)).astype(np.uint8)
            cv2.imwrite(str(image_dir / (scan + ".jpg")), img)
    return str(root / "sunrgbd_pc"), str(calib_dir), str(image_dir)


def _assert_batches_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], list):
            assert got[k] == want[k], k
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("split,with_images", [("val", False), ("train", True)])
def test_sunrgbd_samples_and_loader_equal_jax(tmp_path, split, with_images):
    """The port's SUN RGB-D dataset on fixture scans, through the loader under
    the same task seeds: the JAX package's batches bit for bit, with both
    backends, the padded tail and its pad_mask included."""
    if with_images:
        pytest.importorskip("cv2")
    root, calib, image = _sunrgbd_fixture(tmp_path, split, 7, seed=5, with_images=with_images)
    kw = dict(root_dir=root, calib_dir=calib, image_dir=image, num_points=1024,
              augment=split == "train", if_input_image=with_images,
              if_image_augment=with_images, anonymous=split == "train")
    jcfg = JaxConfig() if split == "train" else JaxImageConfig()
    tcfg = SunrgbdAnonymousConfig() if split == "train" else SunrgbdImageConfig()
    jds = JaxSunrgbd(jcfg, split, **kw)
    tds = SunrgbdDetectionDataset(tcfg, split, **kw)
    assert tds.scan_names == jds.scan_names and len(tds) == 7
    loader_kw = dict(shuffle=split == "train", seed=3, drop_last=False, pad_last=True)
    want = list(jloader.make_loader(jds, 3, num_workers=1, **loader_kw))
    assert want[-1]["pad_mask"].tolist() == [True, False, False]
    for backend in (dict(num_workers=1), dict(num_workers=2),
                    dict(num_workers=2, use_processes=True)):
        got = list(tloader.make_loader(tds, 3, **loader_kw, **backend))
        assert len(got) == len(want) == 3, backend
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)


def test_to_device_keeps_host_fields():
    batch = tloader.collate([SyntheticDetectionDataset(
        SunrgbdAnonymousConfig(), num_scenes=2, num_points=64, with_images=True)[i]
        for i in range(2)])
    batch["pad_mask"] = np.array([True, False])
    out = tloader.to_device(batch, "cpu")
    assert out["im_name"] == batch["im_name"] and out["pad_mask"] is batch["pad_mask"]
    for k, v in batch.items():
        if not isinstance(v, list) and k != "pad_mask":
            assert isinstance(out[k], torch.Tensor) and out[k].device.type == "cpu"
            np.testing.assert_array_equal(out[k].numpy(), v)


# ------------------------------------------------------------------ evaluate


def _fake_outputs(scan_idx, gt_corners, nq):
    """Deterministic outputs from the batch itself: jittered ground-truth
    boxes, scores from the scan index."""
    rng = np.random.default_rng(int(scan_idx.sum()))
    b = gt_corners.shape[0]
    return {
        "box_corners": (gt_corners[:, :nq] + rng.normal(0, 0.02, (b, nq, 1, 3))).astype(np.float32),
        "sem_cls_prob": np.full((b, nq, 1), 0.9, np.float32),
        "objectness_prob": rng.uniform(0.1, 1, (b, nq)).astype(np.float32),
        "center_unnormalized": np.zeros((b, nq, 3), np.float32),
        "size_unnormalized": np.full((b, nq, 3), 0.5, np.float32),
        "angle_continuous": np.zeros((b, nq), np.float32),
    }


def test_evaluate_meters_every_scan_as_jax(monkeypatch):
    """engine.evaluate against the JAX evaluate with the same fake eval step
    on 4 * 2 + 3 scenes: every scan metered once, the padded rows dropped,
    the same AP state and metrics."""
    monkeypatch.setenv("CODA_AP_WORKERS", "0")
    nq = 8
    jds = JaxScenes(JaxConfig(), num_scenes=SCENES, num_points=256)
    tds = SyntheticDetectionDataset(SunrgbdAnonymousConfig(), num_scenes=SCENES, num_points=256)
    loader_kw = dict(shuffle=False, drop_last=False, pad_last=True, num_workers=1)

    def jax_step(state, batch):
        assert "pad_mask" not in batch
        return _fake_outputs(np.asarray(batch["scan_idx"]), np.asarray(batch["gt_box_corners"]), nq)

    seen = []

    def port_step(batch):
        assert "pad_mask" not in batch and isinstance(batch["point_clouds"], torch.Tensor)
        seen.append(batch["scan_idx"].tolist())
        out = _fake_outputs(batch["scan_idx"].numpy(), batch["gt_box_corners"].numpy(), nq)
        return {k: torch.from_numpy(v) for k, v in out.items()}

    want = jengine.evaluate(jax_step, None, jloader.make_loader(jds, BATCH, **loader_kw),
                            JaxConfig())
    got = engine.evaluate(port_step, tloader.make_loader(tds, BATCH, **loader_kw),
                          SunrgbdAnonymousConfig(), device="cpu")
    assert seen == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 10]]
    assert got.scan_cnt == want.scan_cnt == SCENES
    assert engine.EVAL_STATS["batches"] == 3 and engine.EVAL_STATS["scans"] == SCENES
    assert len(engine.EVAL_STATS["meter_s"]) == 3 and engine.EVAL_STATS["device_ms"] == []
    for i in range(SCENES):
        assert [c for c, _ in got.gt_map_cls[i]] == [c for c, _ in want.gt_map_cls[i]]
        assert [(c, s) for c, _, s in got.pred_map_cls[i]] == \
            [(c, s) for c, _, s in want.pred_map_cls[i]]
    _assert_metrics_equal(got.compute_metrics(), want.compute_metrics())


# ------------------------------------------------------------------ the CLI


def _cli_argv(tmp_path, ckpt, log_name):
    return [
        "--test_only", "--dataset_name", "synthetic", "--synthetic_num_scenes", str(4 * SCENES),
        "--num_points", str(NUM_POINTS), "--batchsize_per_gpu_test", str(BATCH),
        "--test_ckpt", str(ckpt), "--log_file", str(tmp_path / log_name), "--if_use_v1",
        *[x for k, v in TINY.items() for x in (f"--{k}", str(v))],
    ]


def test_cli_test_only_matches_jax(tmp_path, monkeypatch):
    """`main --test_only --test_ckpt x.pth` of both packages: the .pth written
    by the JAX package's exporter from a tiny flax model, the same synthetic
    split (11 scenes: two batches of 4 and a padded tail), the text bank
    from the same tiny CLIP.  The eval outputs of every batch agree within
    OUTPUT_TOL; the metric dicts have the same keys and scan count and
    agree within METRIC_TOL."""
    monkeypatch.setenv("CODA_AP_WORKERS", "0")
    ds = JaxScenes(JaxConfig(), num_scenes=SCENES, num_points=NUM_POINTS, seed=2)
    batch = jloader.collate([ds[i] for i in range(SCENES)])
    _assert_no_boundary_flip(batch, TINY["preenc_npoints"])
    pts = {k: batch[k][:2] for k in ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")}
    _, variables, _, _ = _build(TINY, pts)
    sd = export_reference_state_dict(variables["params"], variables["batch_stats"],
                                     variables["constants"])
    ckpt = tmp_path / "tiny.pth"
    torch.save({"model": {k: torch.from_numpy(np.asarray(v).copy()) for k, v in sd.items()},
                "epoch": 0}, ckpt)

    contexts, outs = {}, {"jax": [], "port": []}

    def jax_ctx(args, cfg):
        contexts["jax"] = jstages_cls(args, cfg, clip_model=jclip.CLIP(**TINY_CLIP), crop_size=16)
        return contexts["jax"]

    def port_ctx(args, cfg, device="cuda"):
        params = jax.tree.map(np.asarray, contexts["jax"].clip_variables["params"])
        return stages_cls(args, cfg, clip_model=_port_clip(TINY_CLIP, params), crop_size=16,
                          device=device)

    jstages_cls, stages_cls = jstages.StageContext, stages.StageContext
    monkeypatch.setattr(jstages, "StageContext", jax_ctx)
    monkeypatch.setattr(stages, "StageContext", port_ctx)
    jmake, tmake = jengine.make_eval_step, engine.make_eval_step

    def jax_make(*a, **kw):
        step = jmake(*a, **kw)

        def recorded(state, b):
            out = step(state, b)
            outs["jax"].append(jax.tree.map(np.asarray, out))
            return out

        return recorded

    def port_make(*a, **kw):
        step = tmake(*a, **kw)

        def recorded(b):
            out = step(b)
            outs["port"].append({k: v.numpy().copy() for k, v in out.items()})
            return out

        return recorded

    monkeypatch.setattr(jengine, "make_eval_step", jax_make)
    monkeypatch.setattr(engine, "make_eval_step", port_make)
    want = jmain.main(_cli_argv(tmp_path, ckpt, "jax.lst"))
    got = tmain.main(_cli_argv(tmp_path, ckpt, "port.lst"), device="cpu")

    assert len(outs["port"]) == len(outs["jax"]) == 3
    for g, w in zip(outs["port"], outs["jax"]):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=OUTPUT_TOL, err_msg=k)
    assert engine.EVAL_STATS["scans"] == SCENES
    _assert_metrics_close(got, want, METRIC_TOL)
    assert (tmp_path / "port.lst").read_text().startswith("mAP0.25")


def test_cli_flag_set_equals_jax():
    def flags(parser):
        return {
            tuple(a.option_strings): (a.dest, a.default, a.type, a.nargs, a.choices,
                                      type(a).__name__)
            for a in parser._actions
        }

    assert flags(tmain.make_args_parser()) == flags(jmain.make_args_parser())
    assert tmain._INERT_COMPAT_FLAGS == jmain._INERT_COMPAT_FLAGS
    parser = tmain.make_args_parser()
    args = parser.parse_args(["--cross_heads", "8"])
    with pytest.raises(NotImplementedError, match="--cross_heads"):
        tmain.reject_inert_flags(parser, args)


# ------------------------------------------------------------------ errors


def _tiny_model():
    model = CoDA3DETR(SunrgbdAnonymousConfig(), **TINY, device="cpu")
    with torch.no_grad():
        return reset_parameters(model, torch.Generator().manual_seed(0))


def test_checkpoint_errors_and_ignored_keys(tmp_path):
    model = _tiny_model()
    orbax_dir = tmp_path / "checkpoint_best"
    orbax_dir.mkdir()
    with pytest.raises(ValueError, match="torch_convert export"):
        restore_params_only(str(orbax_dir), model)

    sd = {k: v.clone() + 1.0 if v.is_floating_point() else v.clone()
          for k, v in model.state_dict().items()}
    dropped = sorted(sd)[0]
    bad = dict(sd)
    del bad[dropped]
    bad["mlp_heads.extra_head.layers.0.weight"] = torch.zeros(1)
    torch.save({"model": bad}, tmp_path / "bad.pth")
    with pytest.raises(ValueError) as err:
        restore_params_only(str(tmp_path / "bad.pth"), _tiny_model())
    assert dropped in str(err.value) and "extra_head" in str(err.value)

    # what the JAX converter reads past: DDP's prefix, CLIP, logit_scale, BN counters
    full = {"module." + k: v for k, v in sd.items()}
    full.update({"module.clip_model.visual.conv1.weight": torch.zeros(2),
                 "logit_scale": torch.tensor(4.6),
                 "decoder.norm.num_batches_tracked": torch.tensor(3)})
    torch.save({"model": full, "epoch": 7}, tmp_path / "ref.pth")
    loaded = restore_params_only(str(tmp_path / "ref.pth"), _tiny_model())
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def _args(extra=()):
    return ["--dataset_name", "synthetic", "--synthetic_num_scenes", "8", "--num_points", "256",
            *[x for k, v in TINY.items() for x in (f"--{k}", str(v))], *extra]


@pytest.mark.parametrize("extra,match", [
    (["--compute_dtype", "bf16"], None),
    (["--test_only", "--minitest_only"], "minitest"),
], ids=["training", "minitest"])
def test_main_raises_on_what_is_not_ported(extra, match, monkeypatch):
    """--minitest_only raises.  --compute_dtype bf16 without --test_only
    raised until the bf16 detector's training was ported: it now passes the
    checks to build_everything with train=True, where this test stops it
    (tests/test_torch_port_bf16_train.py trains through main)."""
    if match is None:
        class Reached(Exception):
            pass

        def stop(args, device="cuda", train=False, world=1):
            assert args.compute_dtype == "bf16" and train
            raise Reached

        monkeypatch.setattr(tmain, "build_everything", stop)
        with pytest.raises(Reached):
            tmain.main(_args(extra), device="cpu")
        return
    with pytest.raises(NotImplementedError, match=match):
        tmain.main(_args(extra), device="cpu")


@pytest.mark.parametrize("mode", ["show_only", "cal_class_only"])
def test_main_runs_the_mode(tmp_path, monkeypatch, mode):
    """The two modes this test once expected to raise now run through main
    (the CoDA model, its text bank from a seeded tiny CLIP): --show_only
    writes each test scene's files, --cal_class_only returns a
    (test_num_semcls, test_num_semcls) count matrix."""
    from coda_neurips2023_tpu_torch.models import clip as tclip

    stages_cls = stages.StageContext

    def tiny_ctx(args, cfg, device="cuda"):
        clip = tclip.init_clip_parameters(tclip.CLIP(**TINY_CLIP), torch.Generator().manual_seed(0))
        return stages_cls(args, cfg, clip_model=clip, crop_size=16, device=device)

    monkeypatch.setattr(stages, "StageContext", tiny_ctx)
    got = tmain.main(_args(["--test_only", f"--{mode}", "--checkpoint_dir", str(tmp_path)]),
                     device="cpu")
    if mode == "show_only":
        assert got == 2  # synthetic_num_scenes 8 -> a test split of 2
        files = os.listdir(tmp_path / "show")
        assert {"000000_pc.ply", "000001_pc.ply", "000000_gt_boxes.obj"} <= set(files)
    else:
        assert got.shape == (46, 46) and got.dtype == np.int64


def test_scannet_build_dataset_runs(tmp_path):
    """ScanNet's names build their four splits (data-free without
    --dataset_root_dir) on ScanNet's configs."""
    args = tmain.make_args_parser().parse_args(
        ["--dataset_name", "scannet_anonymous_aligned_image", "--synthetic_num_scenes", "8",
         "--num_points", "256"])
    datasets, cfg, real_cfg, cmp_cfg = build_dataset(args)
    assert sorted(datasets) == ["real_cmp_test", "real_test", "test", "train"]
    assert cfg.num_angle_bin == 1 and type(real_cfg).__name__ == "Scannet50ImageConfig"
    assert cmp_cfg.num_semcls == 19 and len(datasets["train"]) == 8


def test_main_needs_a_card_unless_cpu(monkeypatch, tmp_path):
    """The CLI runs on the card by default; without one it raises before
    building anything (test_cli_test_only_matches_jax runs device="cpu")."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tmain, "build_everything",
                        lambda *a, **kw: pytest.fail("built without a device check"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmain.main(_args(["--test_only"]))


def test_new_modules_never_import_jax():
    code = (
        "import importlib, sys\n"
        "for name in ('main', 'native', 'utils.ap_calculator', 'utils.eval_det', 'utils.nms',\n"
        "             'utils.io', 'utils.logger', 'utils.misc', 'datasets', 'datasets.loader',\n"
        "             'datasets.sunrgbd', 'datasets.scannet', 'datasets.augment', 'engine',\n"
        "             'modes', 'utils.ply'):\n"
        "    importlib.import_module('coda_neurips2023_tpu_torch.' + name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'cv2',\n"
        "                                                          'coda_neurips2023_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
