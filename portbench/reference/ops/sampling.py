"""Furthest point sampling, plain.

A frozen copy of the plain functions of the port's ops/sampling.py, with no kernel
behind them: every call takes the plain PyTorch path, on any device."""

from __future__ import annotations

import torch

from portbench.reference.ops.grouping import group_points

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
    return furthest_point_sample_plain(xyz, npoint)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points: (B, N, C) float32, idx: (B, M) int32 -> (B, M, C)."""
    b, m = idx.shape
    return group_points(points, idx.reshape(b, 1, m)).reshape(b, m, points.shape[-1])
