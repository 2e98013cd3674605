"""Furthest-point sampling and index gathering (PyTorch + kernels A and C).

Counterparts of coda_neurips2023_tpu/ops/sampling.py:
  * `furthest_point_sample`: index 0 is picked first; points with
    |p|^2 <= 1e-3 are never picked; each step picks the valid point farthest
    from the picked set (running min-distance, initially 1e10), the lowest
    index winning ties.  Kernel A (csrc/fps.cu) on a CUDA tensor, the plain
    version below on a CPU tensor.
  * `gather_points`: out[b, j] = points[b, idx[b, j]], through kernel C
    (`grouping.group_points`) on a (B, 1, M) view of the indices.

Distances are ((dx*dx + dy*dy) + dz*dz) in both versions, in that order, so
they agree bit for bit.  Indices are int32.
"""

from __future__ import annotations

import torch

from coda_neurips2023_tpu_torch import _kernels
from coda_neurips2023_tpu_torch.ops.grouping import group_points

_MAG_EPS = 1e-3
_INIT_DIST = 1e10


def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain PyTorch version of `furthest_point_sample`, on any device."""
    b, n, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    mag = (x * x + y * y) + z * z
    # an invalid point's candidate value is -1; distances are >= 0, so a
    # running minimum started at -1 stays there
    mind = torch.where(mag > _MAG_EPS, _INIT_DIST, -1.0).to(torch.float32)
    out = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    last = out[:, 0]
    for j in range(1, npoint):
        lx, ly, lz = xyz[rows, last].unbind(-1)
        dx, dy, dz = x - lx[:, None], y - ly[:, None], z - lz[:, None]
        mind = torch.minimum(mind, (dx * dx + dy * dy) + dz * dz)
        last = torch.argmax(mind, dim=1)  # the first maximum
        out[:, j] = last
    return out.to(torch.int32)


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz: (B, N, 3) float32 -> (B, npoint) int32 indices; idx[:, 0] == 0."""
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz: expected float32 (B, N, 3), got {xyz.dtype} {tuple(xyz.shape)}")
    b, n, _ = xyz.shape
    if n < 1 or npoint < 1:
        raise ValueError(f"furthest_point_sample: need N >= 1 and npoint >= 1, got {n}, {npoint}")
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    if xyz.device.type != "cuda":
        raise ValueError(f"furthest_point_sample: unsupported device {xyz.device}")
    if not xyz.is_contiguous():
        raise ValueError("furthest_point_sample: xyz must be contiguous")
    max_n = _kernels.library().coda_fps_max_points()
    if n > max_n:
        raise ValueError(f"furthest_point_sample: N={n} exceeds the kernel's {max_n}")
    _kernels.check_cuda_inference(xyz)
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    _kernels.launch("coda_fps", xyz, out, b, n, npoint)
    return out


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points: (B, N, C) float32, idx: (B, M) int32 -> (B, M, C)."""
    if idx.dim() != 2:
        raise ValueError(f"idx: expected (B, M), got {tuple(idx.shape)}")
    b, m = idx.shape
    return group_points(points, idx.reshape(b, 1, m)).reshape(b, m, points.shape[-1])
