"""PLY and OBJ writers for the visualisation modes (numpy only).

Counterpart of coda_neurips2023_tpu/utils/ply.py, copied: ascii PLY point
clouds and wireframe OBJ boxes, the files `--show_only` writes, without the
reference's trimesh dependency.
"""

from __future__ import annotations

import numpy as np

_BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def write_ply(points: np.ndarray, filename: str, colors: np.ndarray = None):
    """points (N, 3); colors (N, 3) uint8 optional -> ascii PLY."""
    n = points.shape[0]
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i,0]:.6f} {points[i,1]:.6f} {points[i,2]:.6f}"
            if colors is not None:
                row += f" {int(colors[i,0])} {int(colors[i,1])} {int(colors[i,2])}"
            f.write(row + "\n")


def write_bbox_obj(corners: np.ndarray, filename: str):
    """corners (K, 8, 3) -> wireframe OBJ (12 edges per box)."""
    with open(filename, "w") as f:
        for box in corners:
            for v in box:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for k in range(corners.shape[0]):
            base = k * 8 + 1
            for a, b in _BOX_EDGES:
                f.write(f"l {base + a} {base + b}\n")
