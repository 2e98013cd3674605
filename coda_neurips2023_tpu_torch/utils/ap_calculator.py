"""AP calculator: prediction parsing, the NMS protocol, metric buckets (host numpy).

Counterpart of coda_neurips2023_tpu/utils/ap_calculator.py, copied: the
metric is defined on the host and both packages must report the same
numbers on the same predictions (NMS tie-breaking, the in-hull test, the
per-class proposal scores).

Protocol (the reference's get_ap_config_dict): remove_empty_box (fewer than
5 points inside -> dropped; a scan whose boxes all drop keeps its
max-objectness box), 3D class-aware NMS at IoU 0.25, per-class proposals
above confidence 0.05 scored sem_prob * objectness, AP at IoU 0.25 and 0.5.
Buckets (compute_metrics): SUN RGB-D mAP_fre = classes[:4], common = [4:10],
base = [:10], novel = [10:]; ScanNet (>= 21 classes) from the config's
seen/novel index lists.

The in-hull test keeps scipy's Delaunay (`points_in_box_mask` says why), and
parse_predictions spreads a batch over a process pool one scan a job
(`_ap_pool`, CODA_AP_WORKERS).  This module and what it imports (eval_det,
nms, native) are numpy, scipy and ctypes only, so the pool's workers never
import torch or touch the card.

`METER` adds up where the metering's time goes, for the eval loop's
measurements: seconds in the in-hull test and in NMS (summed over the
processes that ran them), the wall seconds of parse_predictions and of
compute_metrics (the AP curves) in the calling process, the scans parsed and
those whose NMS ran in the host library.  `reset_meter()` zeroes it.
"""

from __future__ import annotations

import time
import types
from collections import OrderedDict

import warnings
from concurrent.futures.process import BrokenProcessPool

import numpy as np
from scipy.spatial import Delaunay, QhullError

from coda_neurips2023_tpu_torch.utils.eval_det import eval_det, get_iou_obb
from coda_neurips2023_tpu_torch.utils.nms import (
    nms_2d_faster,
    nms_3d_faster,
    nms_3d_faster_samecls,
)


def flip_axis_to_depth_np(pc):
    pc2 = pc.copy()
    pc2[..., [0, 1, 2]] = pc2[..., [0, 2, 1]]
    pc2[..., 2] *= -1
    return pc2


def points_in_box_mask(pc: np.ndarray, box3d: np.ndarray) -> np.ndarray:
    """pc: (N, 3), box3d: (8, 3) depth-frame corners of a parallelepiped.

    BIT-FAITHFUL to the reference metric protocol: scipy Delaunay
    `find_simplex` (reference in_hull, box_util.py:22-25) -- its boundary
    tolerance differs from an exact half-space test by ~1e-5 relative, enough
    to flip the >= 5-points empty-box gate on real data (found by the live
    AP-parity test).  The exact half-space test is kept only as the fallback
    for degenerate (coplanar) hulls, where Delaunay raises and the reference
    itself would crash.
    """
    try:
        # (measured: the per-box cost is dominated by the Delaunay
        # CONSTRUCTION ~0.35 ms, not find_simplex over 20k points ~0.15 ms;
        # an AABB prefilter was net-negative.  The reference pays the same
        # construction per box -- scan-level parallelism in
        # parse_predictions is the lever.)
        return Delaunay(box3d).find_simplex(pc) >= 0
    except QhullError:
        pass  # degenerate (coplanar) hull: reference would crash here
    # degenerate-hull fallback: exact membership in the parallelepiped
    # spanned by edges 0->1, 0->3, 0->4 (get_3d_box_batch corner layout)
    origin = box3d[0]
    axes = np.stack([box3d[1] - origin, box3d[3] - origin, box3d[4] - origin])  # (3,3)
    lens = np.sum(axes * axes, axis=1)  # squared lengths
    rel = pc - origin  # (N, 3)
    proj = rel @ axes.T  # (N, 3)
    eps = 1e-9
    ok = np.ones(pc.shape[0], dtype=bool)
    for k in range(3):
        if lens[k] < 1e-12:
            ok &= np.abs(proj[:, k]) < 1e-9
        else:
            ok &= (proj[:, k] >= -eps * lens[k]) & (proj[:, k] <= lens[k] * (1 + eps))
    return ok


def get_ap_config_dict(
    remove_empty_box=True,
    use_3d_nms=True,
    nms_iou=0.25,
    use_old_type_nms=False,
    cls_nms=True,
    per_class_proposal=True,
    use_cls_confidence_only=False,
    conf_thresh=0.05,
    no_nms=False,
    dataset_config=None,
):
    return {
        "remove_empty_box": remove_empty_box,
        "use_3d_nms": use_3d_nms,
        "nms_iou": nms_iou,
        "use_old_type_nms": use_old_type_nms,
        "cls_nms": cls_nms,
        "per_class_proposal": per_class_proposal,
        "use_cls_confidence_only": use_cls_confidence_only,
        "conf_thresh": conf_thresh,
        "no_nms": no_nms,
        "dataset_config": dataset_config,
    }


METER_KEYS = ("in_hull_s", "nms_s", "parse_s", "ap_curve_s", "scans", "native_nms_scans")
METER = dict.fromkeys(METER_KEYS, 0)


def reset_meter():
    for key in METER_KEYS:
        METER[key] = 0


_AP_POOL = None


def _one_blas_thread():
    """The pool's initializer: cap each BLAS library the worker has loaded at
    one thread.  scipy's Delaunay factors every simplex with LAPACK, and each
    of CODA_AP_WORKERS workers otherwise starts a pool of BLAS threads the
    size of the host, which oversubscribes it many times over (measured: a
    batch slower on 8 workers than serial).  A worker runs one scan at a
    time, so one thread is all it uses."""
    import ctypes

    try:
        with open("/proc/self/maps") as f:
            paths = {line.split()[-1] for line in f
                     if "openblas" in line.lower() and line.split()[-1].startswith("/")}
    except OSError:
        return
    for path in sorted(paths):
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        for name in ("openblas_set_num_threads", "openblas_set_num_threads64_",
                     "scipy_openblas_set_num_threads", "scipy_openblas_set_num_threads64_"):
            fn = getattr(lib, name, None)
            if fn is not None:
                fn(1)


def _ap_pool():
    """The forkserver pool for per-scan parse_predictions jobs, made at first
    use.  CODA_AP_WORKERS=0 disables it (serial); the default is
    min(8, cpu_count), or serial on a one-core host.  Scans are independent
    and the pool maps them in order, so the results are bit-identical to the
    serial path.  forkserver, not fork: the parent has CUDA and torch's
    threads by then, and forking after threads can deadlock; the server
    preloads nothing of the parent's __main__.  Each worker runs its BLAS on
    one thread (`_one_blas_thread`)."""
    global _AP_POOL
    if _AP_POOL is None:
        import os

        default = min(8, (os.cpu_count() or 1))
        if default < 2:
            default = 0  # one core: the pool's overhead only hurts
        n = int(os.environ.get("CODA_AP_WORKERS", str(default)))
        if n <= 0:
            _AP_POOL = False
        else:
            try:
                import multiprocessing as mp
                from concurrent.futures import ProcessPoolExecutor

                ctx = mp.get_context("forkserver")
                ctx.set_forkserver_preload([])
                _AP_POOL = ProcessPoolExecutor(max_workers=n, mp_context=ctx,
                                               initializer=_one_blas_thread)
            except Exception:
                _AP_POOL = False
    return _AP_POOL or None


def _ready():
    return True


def start_pool():
    """Start the pool's workers without waiting for them: each imports numpy
    and scipy (a second or more), which then overlaps the first batch's
    loading and device step instead of delaying its metering."""
    pool = _ap_pool()
    if pool is not None:
        for _ in range(pool._max_workers):
            pool.submit(_ready)


def close_pool():
    """Stop the pool's workers; the next parallel parse_predictions reads
    CODA_AP_WORKERS again and makes a new pool."""
    global _AP_POOL
    if _AP_POOL:
        _AP_POOL.shutdown(wait=True)
    _AP_POOL = None


def _parse_one_scan(job):
    """One scan in a worker: its predictions and the worker's METER for it."""
    corners, sem, obj, pc, config_dict = job
    reset_meter()
    out = parse_predictions(
        corners[None], sem[None], obj[None], pc[None], config_dict, parallel=False
    )[0]
    return out, dict(METER)


def parse_predictions(
    predicted_boxes, sem_cls_probs, objectness_probs, point_cloud, config_dict,
    parallel: bool = True,
):
    """The reference's parse_predictions.  Inputs are numpy arrays:
    predicted_boxes (B, K, 8, 3) camera-frame corners; sem_cls_probs
    (B, K, ncls); objectness_probs (B, K); point_cloud (B, N, 3+).
    Returns a list (len B) of [(cls, corners, score), ...].

    The JAX package measured the in-hull empty-box test at ~70 ms a scan on
    its host against 7 ms a scan of device forward; with `parallel` (the
    default) the batch fans out one scan a job over `_ap_pool`, in order and
    bit for bit.  A job carries the number of classes, not the dataset
    config, so a worker unpickles nothing that imports torch.
    """
    t_parse = time.perf_counter()
    if parallel and np.asarray(predicted_boxes).shape[0] > 1:
        pool = _ap_pool()
        if pool is not None:
            corners_a = np.asarray(predicted_boxes)
            sem_a = np.asarray(sem_cls_probs)
            obj_a = np.asarray(objectness_probs)
            pc_a = np.asarray(point_cloud)
            job_config = dict(config_dict, dataset_config=types.SimpleNamespace(
                num_semcls=config_dict["dataset_config"].num_semcls))
            jobs = [
                (corners_a[i], sem_a[i], obj_a[i], pc_a[i], job_config)
                for i in range(corners_a.shape[0])
            ]
            try:
                results = list(pool.map(_parse_one_scan, jobs))
            except BrokenProcessPool:
                # the pool died (an OOM-killed worker, a constrained sandbox):
                # go serial for the rest of the run; an error raised inside a
                # worker propagates instead
                global _AP_POOL
                _AP_POOL = False
                warnings.warn(
                    "AP worker pool broke; parse_predictions falls back to "
                    "serial for the rest of this run",
                    RuntimeWarning,
                )
            else:
                for _, meter in results:
                    for key in ("in_hull_s", "nms_s", "scans", "native_nms_scans"):
                        METER[key] += meter[key]
                METER["parse_s"] += time.perf_counter() - t_parse
                return [out for out, _ in results]
    sem_cls_probs = np.asarray(sem_cls_probs)
    obj_prob = np.asarray(objectness_probs)
    corners = np.asarray(predicted_boxes)
    pred_sem_cls = np.argmax(sem_cls_probs, -1)
    bsize, nprop = corners.shape[0], corners.shape[1]

    t0 = time.perf_counter()
    nonempty_box_mask = np.ones((bsize, nprop))
    if config_dict["remove_empty_box"]:
        batch_pc = np.asarray(point_cloud)[:, :, 0:3]
        for i in range(bsize):
            pc = batch_pc[i]
            for j in range(nprop):
                box3d = flip_axis_to_depth_np(corners[i, j])
                if np.max(box3d) < 1e-32 and np.min(box3d) > -1e-32:
                    nonempty_box_mask[i, j] = 0  # all-zero (padding) boxes
                elif np.sum(points_in_box_mask(pc, box3d)) < 5:
                    nonempty_box_mask[i, j] = 0
            if nonempty_box_mask[i].sum() == 0:
                nonempty_box_mask[i, obj_prob[i].argmax()] = 1
    t1 = time.perf_counter()
    METER["in_hull_s"] += t1 - t0

    xmin = corners[..., 0].min(-1); xmax = corners[..., 0].max(-1)
    ymin = corners[..., 1].min(-1); ymax = corners[..., 1].max(-1)
    zmin = corners[..., 2].min(-1); zmax = corners[..., 2].max(-1)

    pred_mask = np.zeros((bsize, nprop))
    if config_dict.get("no_nms"):
        pred_mask = nonempty_box_mask
    elif not config_dict["use_3d_nms"]:
        for i in range(bsize):
            boxes2d = np.stack(
                [xmin[i], zmin[i], xmax[i], zmax[i], obj_prob[i]], axis=1
            )
            live = np.where(nonempty_box_mask[i] == 1)[0]
            pick = nms_2d_faster(
                boxes2d[live], config_dict["nms_iou"], config_dict["use_old_type_nms"]
            )
            pred_mask[i, live[pick]] = 1
    else:
        native_nms = None
        if config_dict["cls_nms"]:
            try:
                from coda_neurips2023_tpu_torch import native

                if native.available():
                    native_nms = native.nms_3d_samecls
            except Exception:
                native_nms = None
        for i in range(bsize):
            cols = [xmin[i], ymin[i], zmin[i], xmax[i], ymax[i], zmax[i], obj_prob[i]]
            if config_dict["cls_nms"]:
                cols.append(pred_sem_cls[i].astype(np.float64))
                nms_fn = nms_3d_faster_samecls
            else:
                nms_fn = nms_3d_faster
            boxes3d = np.stack(cols, axis=1)
            live = np.where(nonempty_box_mask[i] == 1)[0]
            if native_nms is not None:
                pick = native_nms(
                    boxes3d[live].astype(np.float32),
                    config_dict["nms_iou"],
                    config_dict["use_old_type_nms"],
                )
                METER["native_nms_scans"] += 1
            else:
                pick = nms_fn(
                    boxes3d[live], config_dict["nms_iou"], config_dict["use_old_type_nms"]
                )
            pred_mask[i, live[pick]] = 1
    METER["nms_s"] += time.perf_counter() - t1
    METER["scans"] += bsize

    batch_pred_map_cls = []
    num_semcls = config_dict["dataset_config"].num_semcls
    for i in range(bsize):
        cur_list = []
        keep_j = [
            j
            for j in range(nprop)
            if pred_mask[i, j] == 1 and obj_prob[i, j] > config_dict["conf_thresh"]
        ]
        if config_dict["per_class_proposal"]:
            for ii in range(num_semcls):
                cur_list += [
                    (ii, corners[i, j], sem_cls_probs[i, j, ii] * obj_prob[i, j])
                    for j in keep_j
                ]
        elif config_dict["use_cls_confidence_only"]:
            cur_list = [
                (pred_sem_cls[i, j], corners[i, j], sem_cls_probs[i, j, pred_sem_cls[i, j]])
                for j in keep_j
            ]
        else:
            cur_list = [
                # score is the objectness ALONE (reference
                # ap_calculator.py:996-1007), not sem_prob * objectness
                (pred_sem_cls[i, j], corners[i, j], obj_prob[i, j])
                for j in keep_j
            ]
        batch_pred_map_cls.append(cur_list)
    METER["parse_s"] += time.perf_counter() - t_parse
    return batch_pred_map_cls


class APCalculator:
    """The reference's APCalculator, the parts train and eval use."""

    def __init__(
        self,
        dataset_config,
        ap_iou_thresh=(0.25, 0.5),
        class2type_map=None,
        exact_eval=True,
        ap_config_dict=None,
        dataset_name: str = "sunrgbd",
    ):
        self.ap_iou_thresh = list(ap_iou_thresh)
        if ap_config_dict is None:
            ap_config_dict = get_ap_config_dict(
                dataset_config=dataset_config, remove_empty_box=exact_eval
            )
        self.ap_config_dict = ap_config_dict
        self.class2type_map = class2type_map
        self.dataset_config = dataset_config
        self.dataset_name = dataset_name
        self.reset()

    def reset(self):
        self.gt_map_cls = {}
        self.pred_map_cls = {}
        self.scan_cnt = 0

    @staticmethod
    def make_gt_list(gt_box_corners, gt_box_sem_cls_labels, gt_box_present):
        return [
            [
                (int(gt_box_sem_cls_labels[i, j]), gt_box_corners[i, j])
                for j in range(gt_box_corners.shape[1])
                if gt_box_present[i, j] == 1
            ]
            for i in range(gt_box_corners.shape[0])
        ]

    def step_meter(self, outputs, targets):
        if "outputs" in outputs:
            outputs = outputs["outputs"]
        self.step(
            predicted_box_corners=np.asarray(outputs["box_corners"]),
            sem_cls_probs=np.asarray(outputs["sem_cls_prob"]),
            objectness_probs=np.asarray(outputs["objectness_prob"]),
            point_cloud=np.asarray(targets["point_clouds"]),
            gt_box_corners=np.asarray(targets["gt_box_corners"]),
            gt_box_sem_cls_labels=np.asarray(targets["gt_box_sem_cls_label"]),
            gt_box_present=np.asarray(targets["gt_box_present"]),
        )

    def step(
        self,
        predicted_box_corners,
        sem_cls_probs,
        objectness_probs,
        point_cloud,
        gt_box_corners,
        gt_box_sem_cls_labels,
        gt_box_present,
    ):
        batch_gt_map_cls = self.make_gt_list(
            gt_box_corners, gt_box_sem_cls_labels, gt_box_present
        )
        batch_pred_map_cls = parse_predictions(
            predicted_box_corners,
            sem_cls_probs,
            objectness_probs,
            point_cloud,
            self.ap_config_dict,
        )
        self.accumulate(batch_pred_map_cls, batch_gt_map_cls)

    def accumulate(self, batch_pred_map_cls, batch_gt_map_cls):
        assert len(batch_pred_map_cls) == len(batch_gt_map_cls)
        for i in range(len(batch_pred_map_cls)):
            self.gt_map_cls[self.scan_cnt] = batch_gt_map_cls[i]
            self.pred_map_cls[self.scan_cnt] = batch_pred_map_cls[i]
            self.scan_cnt += 1

    def compute_metrics(self):
        """The reference's compute_metrics, its 'revised setting-2-10classes'
        branch (the one the shipped configs take): {iou: {name: value}}."""
        t0 = time.perf_counter()
        overall_ret = OrderedDict()
        for ap_iou_thresh in self.ap_iou_thresh:
            ret_dict = OrderedDict()
            rec, prec, ap = eval_det(
                self.pred_map_cls, self.gt_map_cls, ovthresh=ap_iou_thresh,
                get_iou_func=get_iou_obb,
            )
            for key in sorted(ap.keys()):
                clsname = self.class2type_map[key] if self.class2type_map else str(key)
                ret_dict["%s Average Precision" % clsname] = ap[key]
            ap_vals = np.array(list(ap.values()), dtype=np.float32)
            ap_vals[np.isnan(ap_vals)] = 0
            if ap_vals.shape[0] > 2:
                if self.dataset_name.find("scannet") == -1 or ap_vals.shape[0] < 21:
                    ret_dict["mAP"] = ap_vals.mean()
                    ret_dict["mAP_fre"] = ap_vals[:4].mean()
                    ret_dict["mAP_common"] = ap_vals[4:10].mean()
                    ret_dict["mAP_base"] = ap_vals[:10].mean()
                    ret_dict["mAP_novel"] = ap_vals[10:].mean()
                else:
                    seen = self.dataset_config.seen_idx_list
                    novel = self.dataset_config.novel_idx_list
                    ret_dict["mAP"] = ap_vals.mean()
                    ret_dict["mAP_fre"] = ap_vals[seen].mean()
                    ret_dict["mAP_common"] = ap_vals[seen].mean()
                    ret_dict["mAP_base"] = ap_vals[seen].mean()
                    ret_dict["mAP_novel"] = ap_vals[novel].mean()
            else:
                ret_dict["mAP"] = ap_vals.mean() if ap_vals.size else 0.0

            prec_list, rec_list = [], []
            for key in sorted(prec.keys()):
                clsname = self.class2type_map[key] if self.class2type_map else str(key)
                p = prec[key][-1] if len(prec[key]) else 0
                ret_dict["%s Prec" % clsname] = p
                prec_list.append(p)
            for key in sorted(rec.keys()):
                clsname = self.class2type_map[key] if self.class2type_map else str(key)
                r = rec[key][-1] if len(rec[key]) else 0
                ret_dict["%s Recall" % clsname] = r
                rec_list.append(r)
            if prec_list:
                prec_vals = np.array(prec_list, dtype=np.float64)
                ret_dict["Prec"] = float(prec_vals.mean())
                # Prec buckets mirror the mAP buckets and are gated on the
                # AP class count like the reference (ap_calculator.py:1660-1675)
                if ap_vals.shape[0] > 2:
                    if self.dataset_name.find("scannet") == -1 or ap_vals.shape[0] < 21:
                        ret_dict["Prec_fre"] = float(prec_vals[:4].mean())
                        ret_dict["Prec_common"] = float(prec_vals[4:10].mean())
                        ret_dict["Prec_base"] = float(prec_vals[:10].mean())
                        ret_dict["Prec_novel"] = float(prec_vals[10:].mean())
                    else:
                        seen = self.dataset_config.seen_idx_list
                        novel = self.dataset_config.novel_idx_list
                        ret_dict["Prec_fre"] = float(prec_vals[seen].mean())
                        ret_dict["Prec_common"] = float(prec_vals[seen].mean())
                        ret_dict["Prec_base"] = float(prec_vals[seen].mean())
                        ret_dict["Prec_novel"] = float(prec_vals[novel].mean())
            if rec_list:
                rec_vals = np.array(rec_list, dtype=np.float32)
                ret_dict["AR"] = rec_vals.mean()
                if rec_vals.shape[0] > 2:
                    if self.dataset_name.find("scannet") == -1 or rec_vals.shape[0] < 21:
                        ret_dict["AR_fre"] = rec_vals[:4].mean()
                        ret_dict["AR_common"] = rec_vals[4:10].mean()
                        ret_dict["AR_base"] = rec_vals[:10].mean()
                        ret_dict["AR_novel"] = rec_vals[10:].mean()
                    else:
                        # fre/common alias seen on scannet, like the
                        # reference (ap_calculator.py:1685-1690)
                        seen_rec = rec_vals[self.dataset_config.seen_idx_list].mean()
                        ret_dict["AR_fre"] = seen_rec
                        ret_dict["AR_common"] = seen_rec
                        ret_dict["AR_base"] = seen_rec
                        ret_dict["AR_novel"] = rec_vals[self.dataset_config.novel_idx_list].mean()
            overall_ret[ap_iou_thresh] = ret_dict
        METER["ap_curve_s"] += time.perf_counter() - t0
        return overall_ret

    def metrics_to_dict(self, overall_ret):
        """ap_calculator.py:1795-1802: flat mAP/AR scalars (x100) per IoU
        threshold for tensorboard logging."""
        metrics_dict = {}
        for t in self.ap_iou_thresh:
            metrics_dict[f"mAP_{t}"] = overall_ret[t].get("mAP", 0.0) * 100
            metrics_dict[f"AR_{t}"] = overall_ret[t].get("AR", 0.0) * 100
        return metrics_dict

    def metrics_to_str(self, overall_ret, per_class=True):
        """ap_calculator.py:1709-1760."""
        mAP_strs, AR_strs = [], []
        per_class_metrics = []
        for ap_iou_thresh in self.ap_iou_thresh:
            mAP = overall_ret[ap_iou_thresh].get("mAP", 0.0) * 100
            mAP_strs.append(f"{mAP:.2f}")
            ar = overall_ret[ap_iou_thresh].get("AR", 0.0) * 100
            AR_strs.append(f"{ar:.2f}")
            if per_class:
                metrics = [
                    f"{x}: {overall_ret[ap_iou_thresh][x] * 100:.2f}"
                    for x in overall_ret[ap_iou_thresh]
                    if x not in ("mAP", "AR")
                ]
                per_class_metrics.append(
                    f"IOU Thresh={ap_iou_thresh}\n" + ", ".join(metrics)
                )
        ap_header = [f"mAP{x:.2f}" for x in self.ap_iou_thresh]
        ap_str = ", ".join([f"{h}: {s}" for h, s in zip(ap_header, mAP_strs)])
        ar_header = [f"AR{x:.2f}" for x in self.ap_iou_thresh]
        ar_str = ", ".join([f"{h}: {s}" for h, s in zip(ar_header, AR_strs)])
        out = ap_str + "\n" + ar_str
        if per_class:
            out += "\n" + "\n".join(per_class_metrics)
        return out
