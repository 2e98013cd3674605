"""Greedy NMS on the host (numpy).

Counterpart of coda_neurips2023_tpu/utils/nms.py, copied: the AP protocol
depends on NMS tie-breaking (np.argsort ascending by score, the last one
picked first), so the metric path stays host numpy.  `ap_calculator` takes
the same-class 3D NMS from the port's host library (`native.py`) when it
builds, and these functions otherwise.  This module imports numpy only, so
the AP worker processes never import torch.
"""

from __future__ import annotations

import numpy as np


def nms_2d_faster(boxes: np.ndarray, overlap_threshold: float, old_type: bool = False):
    """boxes: (K, 5) [x1, y1, x2, y2, score] -> list of picked indices."""
    x1, y1, x2, y2, score = (boxes[:, i] for i in range(5))
    area = (x2 - x1) * (y2 - y1)
    order = np.argsort(score)
    pick = []
    while order.size != 0:
        last = order.size
        i = order[-1]
        pick.append(i)
        rest = order[: last - 1]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        w = np.maximum(0, xx2 - xx1)
        h = np.maximum(0, yy2 - yy1)
        if old_type:
            o = (w * h) / area[rest]
        else:
            inter = w * h
            o = inter / (area[i] + area[rest] - inter)
        order = np.delete(
            order, np.concatenate(([last - 1], np.where(o > overlap_threshold)[0]))
        )
    return pick


def _nms_3d_core(boxes, overlap_threshold, old_type, same_cls):
    x1, y1, z1, x2, y2, z2, score = (boxes[:, i] for i in range(7))
    cls = boxes[:, 7] if same_cls else None
    area = (x2 - x1) * (y2 - y1) * (z2 - z1)
    order = np.argsort(score)
    pick = []
    while order.size != 0:
        last = order.size
        i = order[-1]
        pick.append(i)
        rest = order[: last - 1]
        l = np.maximum(0, np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]))
        w = np.maximum(0, np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]))
        h = np.maximum(0, np.minimum(z2[i], z2[rest]) - np.maximum(z1[i], z1[rest]))
        if old_type:
            o = (l * w * h) / area[rest]
        else:
            inter = l * w * h
            o = inter / (area[i] + area[rest] - inter)
        if same_cls:
            o = o * (cls[i] == cls[rest])
        order = np.delete(
            order, np.concatenate(([last - 1], np.where(o > overlap_threshold)[0]))
        )
    return pick


def nms_3d_faster(boxes, overlap_threshold, old_type=False):
    """boxes: (K, 7) [x1,y1,z1,x2,y2,z2,score]."""
    return _nms_3d_core(boxes, overlap_threshold, old_type, same_cls=False)


def nms_3d_faster_samecls(boxes, overlap_threshold, old_type=False):
    """boxes: (K, 8) [x1,y1,z1,x2,y2,z2,score,cls]: suppress within class only."""
    return _nms_3d_core(boxes, overlap_threshold, old_type, same_cls=True)
