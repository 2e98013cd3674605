"""VOC-style AP for 3D detection on the host (numpy).

Counterpart of coda_neurips2023_tpu/utils/eval_det.py, copied: it defines
the metric both packages report, so it must give the same numbers on the
same predictions.
  * per class and per scan, detections in descending score order mark a
    true positive on the best-overlapping unmatched ground-truth box when
    `iou > ovthresh`, else a false positive;
  * AP is the area under the interpolated precision-recall curve (the VOC
    "correct" variant) or the VOC07 11-point variant;
  * the IoU of two rotated boxes clips their (x, z) footprints with
    Sutherland-Hodgman (inside := cross > 1e-12, collinear points kept, so
    identical boxes give IoU 1) and takes the shoelace area.
`eval_det_cls` computes one box's IoUs against a scan's ground truth in the
port's host library (`native.box3d_iou_eval_batch`) when it builds, and in
numpy otherwise.  This module imports numpy only.
"""

from __future__ import annotations

import numpy as np

_TOL = 1e-12


def polygon_clip_eval(subject, clip):
    """Eval-path Sutherland-Hodgman (box_util.py:36-107)."""

    def cross(cp1, cp2, p):
        return (cp2[0] - cp1[0]) * (p[1] - cp1[1]) - (cp2[1] - cp1[1]) * (p[0] - cp1[0])

    def intersection(cp1, cp2, s, e):
        dc = (cp1[0] - cp2[0], cp1[1] - cp2[1])
        dp = (s[0] - e[0], s[1] - e[1])
        n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0]
        n2 = s[0] * e[1] - s[1] * e[0]
        denom = dc[0] * dp[1] - dc[1] * dp[0]
        if denom == 0:
            return [e[0], e[1]]
        n3 = 1.0 / denom
        return [(n1 * dp[0] - n2 * dc[0]) * n3, (n1 * dp[1] - n2 * dc[1]) * n3]

    output = list(subject)
    cp1 = clip[-1]
    for cp2 in clip:
        inputList = output
        output = []
        if not inputList:
            return None
        s = inputList[-1]
        for e in inputList:
            ce, cs = cross(cp1, cp2, e), cross(cp1, cp2, s)
            if ce > _TOL:
                if not (cs > _TOL):
                    output.append(intersection(cp1, cp2, s, e))
                output.append(e)
            elif cs > _TOL:
                output.append(intersection(cp1, cp2, s, e))
            elif abs(cs) <= _TOL and abs(ce) <= _TOL:
                output.append(e)
            s = e
        cp1 = cp2
        if len(output) == 0:
            return None
    return output


def _poly_area(xs, ys):
    return 0.5 * np.abs(np.dot(xs, np.roll(ys, 1)) - np.dot(ys, np.roll(xs, 1)))


def _box3d_vol(corners):
    a = np.sqrt(np.sum((corners[0] - corners[1]) ** 2))
    b = np.sqrt(np.sum((corners[1] - corners[2]) ** 2))
    c = np.sqrt(np.sum((corners[0] - corners[4]) ** 2))
    return a * b * c


def box3d_iou(corners1, corners2):
    """(8,3) x (8,3) camera-frame corners -> (iou3d, iou2d)."""
    rect1 = [(corners1[i, 0], corners1[i, 2]) for i in range(3, -1, -1)]
    rect2 = [(corners2[i, 0], corners2[i, 2]) for i in range(3, -1, -1)]
    area1 = _poly_area(np.array([p[0] for p in rect1]), np.array([p[1] for p in rect1]))
    area2 = _poly_area(np.array([p[0] for p in rect2]), np.array([p[1] for p in rect2]))
    inter = polygon_clip_eval(rect1, rect2)
    if inter is None or len(inter) < 3:
        inter_area = 0.0
    else:
        xs = np.array([p[0] for p in inter])
        ys = np.array([p[1] for p in inter])
        inter_area = _poly_area(xs, ys)
    iou_2d = inter_area / max(area1 + area2 - inter_area, 1e-12)
    ymax = min(corners1[0, 1], corners2[0, 1])
    ymin = max(corners1[4, 1], corners2[4, 1])
    inter_vol = inter_area * max(0.0, ymax - ymin)
    vol1 = _box3d_vol(corners1)
    vol2 = _box3d_vol(corners2)
    return inter_vol / max(vol1 + vol2 - inter_vol, 1e-12), iou_2d


def get_iou_obb(bb1, bb2):
    return box3d_iou(np.asarray(bb1), np.asarray(bb2))[0]


def voc_ap(rec, prec, use_07_metric=False):
    """eval_det.py:23-55."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else np.max(prec[rec >= t])
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_det_cls(pred, gt, ovthresh=0.25, use_07_metric=False, get_iou_func=get_iou_obb):
    """eval_det.py:64-165. pred: {img_id: [(bbox, score)]}, gt: {img_id: [bbox]}."""
    class_recs = {}
    npos = 0
    for img_id in gt:
        bbox = np.array(gt[img_id])
        class_recs[img_id] = {"bbox": bbox, "det": [False] * len(bbox)}
        npos += len(bbox)
    for img_id in pred:
        if img_id not in gt:
            class_recs[img_id] = {"bbox": np.array([]), "det": []}

    image_ids, confidence, boxes = [], [], []
    for img_id in pred:
        for box, score in pred[img_id]:
            image_ids.append(img_id)
            confidence.append(score)
            boxes.append(box)
    confidence = np.array(confidence)
    boxes = np.array(boxes)
    sorted_ind = np.argsort(-confidence)
    boxes = boxes[sorted_ind, ...] if boxes.size else boxes
    image_ids = [image_ids[x] for x in sorted_ind]

    # native batched IoU (C++) when the default rotated-IoU is in use
    native_batch = None
    if get_iou_func is get_iou_obb:
        try:
            from coda_neurips2023_tpu_torch import native

            if native.available():
                native_batch = native.box3d_iou_eval_batch
        except Exception:
            native_batch = None

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        rec_entry = class_recs[image_ids[d]]
        bb = boxes[d, ...].astype(float)
        ovmax, jmax = -np.inf, -1
        gt_boxes = rec_entry["bbox"].astype(float)
        if native_batch is not None and gt_boxes.shape[0] > 0:
            ious = native_batch(bb, gt_boxes)
            jmax = int(np.argmax(ious))
            ovmax = float(ious[jmax])
        else:
            for j in range(gt_boxes.shape[0]):
                iou = get_iou_func(bb, gt_boxes[j, ...])
                if iou > ovmax:
                    ovmax, jmax = iou, j
        if ovmax > ovthresh:
            if not rec_entry["det"][jmax]:
                tp[d] = 1.0
                rec_entry["det"][jmax] = True
            else:
                fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(npos) if npos > 0 else np.zeros_like(tp)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def eval_det(pred_all, gt_all, ovthresh=0.25, use_07_metric=False, get_iou_func=get_iou_obb):
    """eval_det.py:171-221. pred_all: {img_id: [(cls, bbox, score)]},
    gt_all: {img_id: [(cls, bbox)]} -> ({cls: rec}, {cls: prec}, {cls: ap})."""
    pred, gt = {}, {}
    for img_id, entries in pred_all.items():
        for classname, bbox, score in entries:
            pred.setdefault(classname, {}).setdefault(img_id, []).append((bbox, score))
            gt.setdefault(classname, {}).setdefault(img_id, [])
    for img_id, entries in gt_all.items():
        for classname, bbox in entries:
            gt.setdefault(classname, {}).setdefault(img_id, []).append(bbox)

    rec, prec, ap = {}, {}, {}
    for classname in list(gt.keys()):
        rec[classname], prec[classname], ap[classname] = eval_det_cls(
            pred.get(classname, {}), gt[classname], ovthresh, use_07_metric, get_iou_func
        )
    return rec, prec, ap
