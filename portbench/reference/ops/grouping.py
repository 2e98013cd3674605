"""Ball query and grouping, plain.

A frozen copy of the plain functions of the port's ops/grouping.py, with no kernel
behind them: every call takes the plain PyTorch path, on any device."""

from __future__ import annotations

import torch

def _check_points(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
        raise ValueError(f"{name}: expected float32 (B, N, 3), got {t.dtype} {tuple(t.shape)}")


def _check_query(nsample: int, xyz, new_xyz) -> None:
    _check_points("xyz", xyz)
    _check_points("new_xyz", new_xyz)
    if new_xyz.shape[0] != xyz.shape[0] or xyz.device != new_xyz.device:
        raise ValueError("xyz and new_xyz must share batch size and device")
    if nsample < 1:
        raise ValueError(f"nsample must be >= 1, got {nsample}")
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ball query: unsupported device {xyz.device}")
    if xyz.device.type == "cuda" and not (xyz.is_contiguous() and new_xyz.is_contiguous()):
        raise ValueError("ball query: inputs must be contiguous")


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., 3), b (..., 3) broadcast -> ((dx*dx + dy*dy) + dz*dz)."""
    d = a - b
    dx, dy, dz = d.unbind(-1)
    return (dx * dx + dy * dy) + dz * dz


def _r2(radius: float) -> torch.Tensor:
    # r^2 as the f32 of the Python float, as the Pallas kernels take it
    return torch.tensor(float(radius) ** 2, dtype=torch.float32)


def _first_hits(key: torch.Tensor, cnt: torch.Tensor, nsample: int) -> torch.Tensor:
    """key (M, W): each hit's original index, each miss a larger value; cnt
    (M, 1) hits -> (M, nsample) int32: the smallest hit indices ascending,
    trailing slots the first hit, a row without hit zeros."""
    m, w = key.shape
    kk = min(nsample, w)
    first_k = torch.topk(key, kk, dim=1, largest=False, sorted=True).values
    first = first_k[:, :1]
    row = torch.where(torch.arange(kk, device=key.device) < cnt, first_k, first)
    row = torch.cat([row, first.expand(m, nsample - kk)], dim=1)
    return torch.where(cnt > 0, row, 0).to(torch.int32)


def ball_query_plain(radius: float, nsample: int, xyz, new_xyz) -> torch.Tensor:
    """Plain PyTorch version of `ball_query`, on any device."""
    r2 = _r2(radius).to(xyz.device)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    out = torch.zeros((b, m, nsample), dtype=torch.int32, device=xyz.device)
    iota = torch.arange(n, device=xyz.device)
    for bi in range(b):  # one scene at a time bounds the (M, N) buffer
        hit = _sq_dist(new_xyz[bi, :, None, :], xyz[bi, None, :, :]) < r2
        # hits keep their index, misses go after every hit
        key = torch.where(hit, iota, iota + n)
        out[bi] = _first_hits(key, hit.sum(dim=1, keepdim=True), nsample)
    return out


def group_points_plain(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `group_points`, on any device."""
    b, m, k = idx.shape
    c = features.shape[-1]
    flat = idx.reshape(b, m * k, 1).long().expand(-1, -1, c)
    return torch.gather(features, 1, flat).reshape(b, m, k, c)


def ball_query(radius: float, nsample: int, xyz, new_xyz) -> torch.Tensor:
    """xyz: (B, N, 3) points, new_xyz: (B, M, 3) centres -> (B, M, nsample) int32."""
    _check_query(nsample, xyz, new_xyz)
    return ball_query_plain(radius, nsample, xyz, new_xyz)


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features: (B, N, C) float32, idx: (B, M, K) int32 -> (B, M, K, C)."""
    return group_points_plain(features, idx)


def query_and_group(radius: float, nsample: int, xyz, new_xyz, features=None,
                    normalize_xyz: bool = False):
    """Ball query + grouped, re-centred xyz, and the point features grouped
    with the same indices -> (new_features (B, M, nsample, 3 + C),
    grouped_xyz (B, M, nsample, 3))."""
    idx = ball_query(radius, nsample, xyz, new_xyz)
    grouped = group_points(xyz, idx)
    grouped_xyz = grouped - new_xyz[:, :, None, :]
    if normalize_xyz:
        grouped_xyz = grouped_xyz / radius
    if features is None:
        return grouped_xyz, grouped_xyz
    return torch.cat([grouped_xyz, group_points(features, idx)], dim=-1), grouped_xyz
