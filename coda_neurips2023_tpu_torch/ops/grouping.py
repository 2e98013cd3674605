"""Ball query and grouping (PyTorch + kernels B and C).

Counterparts of coda_neurips2023_tpu/ops/grouping.py:
  * `ball_query`: for each centre, the first `nsample` point indices, in
    index order, with squared distance < radius^2; trailing slots are filled
    with the first hit, and a row with no hit is all zeros.  On a CUDA tensor
    it launches kernel B (csrc/ball_query.cu); on a CPU tensor it takes the
    plain version below.
  * `group_points`: the batched gather out[b, m, k] = features[b, idx[b, m, k]].
    Kernel C (csrc/gather.cu) on CUDA, `torch.gather` on the CPU.
  * `query_and_group`: the two above, re-centred and radius-normalized.

Distances are written out as ((dx*dx + dy*dy) + dz*dz), elementwise, in the
kernel's order, so the plain version and kernel B agree bit for bit.  (The
JAX package's CPU path uses |a|^2 + |b|^2 - 2ab instead, which can flip a hit
lying exactly on the radius; see its grouping.py:22-27.)

Indices are int32 in and out, as in the JAX package.  The kernels are
inference only.  No TPU size gate is carried over: every CUDA call launches
its kernel.
"""

from __future__ import annotations

import torch

from coda_neurips2023_tpu_torch import _kernels


def _check_points(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
        raise ValueError(f"{name}: expected float32 (B, N, 3), got {t.dtype} {tuple(t.shape)}")


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., 3), b (..., 3) broadcast -> ((dx*dx + dy*dy) + dz*dz)."""
    d = a - b
    dx, dy, dz = d.unbind(-1)
    return (dx * dx + dy * dy) + dz * dz


def _r2(radius: float) -> torch.Tensor:
    # r^2 as the f32 of the Python float, as the Pallas kernels take it
    return torch.tensor(float(radius) ** 2, dtype=torch.float32)


def ball_query_plain(radius: float, nsample: int, xyz, new_xyz) -> torch.Tensor:
    """Plain PyTorch version of `ball_query`, on any device."""
    r2 = _r2(radius).to(xyz.device)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    out = torch.zeros((b, m, nsample), dtype=torch.int32, device=xyz.device)
    iota = torch.arange(n, device=xyz.device)
    kk = min(nsample, n)
    slot = torch.arange(kk, device=xyz.device)
    for bi in range(b):  # one scene at a time bounds the (M, N) buffer
        hit = _sq_dist(new_xyz[bi, :, None, :], xyz[bi, None, :, :]) < r2
        # hits keep their index, misses go after every hit: the kk smallest
        # keys are the first hits in index order
        key = torch.where(hit, iota, iota + n)
        first_k = torch.topk(key, kk, dim=1, largest=False, sorted=True).indices
        cnt = hit.sum(dim=1, keepdim=True)
        first = first_k[:, :1]
        row = torch.where(slot < cnt, first_k, first)
        row = torch.cat([row, first.expand(m, nsample - kk)], dim=1)
        out[bi] = torch.where(cnt > 0, row, 0).to(torch.int32)
    return out


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """xyz: (B, N, 3) points, new_xyz: (B, M, 3) centres -> (B, M, nsample) int32."""
    _check_points("xyz", xyz)
    _check_points("new_xyz", new_xyz)
    if new_xyz.shape[0] != xyz.shape[0] or xyz.device != new_xyz.device:
        raise ValueError("xyz and new_xyz must share batch size and device")
    if nsample < 1:
        raise ValueError(f"nsample must be >= 1, got {nsample}")
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    if xyz.device.type == "cpu":
        return ball_query_plain(radius, nsample, xyz, new_xyz)
    if xyz.device.type != "cuda":
        raise ValueError(f"ball_query: unsupported device {xyz.device}")
    if not (xyz.is_contiguous() and new_xyz.is_contiguous()):
        raise ValueError("ball_query: inputs must be contiguous")
    _kernels.check_cuda_inference(xyz, new_xyz)
    out = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    _kernels.launch(
        "coda_ball_query", xyz, new_xyz, out, b, n, m, nsample, float(_r2(radius))
    )
    return out


def group_points_plain(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `group_points`, on any device."""
    b, m, k = idx.shape
    c = features.shape[-1]
    flat = idx.reshape(b, m * k, 1).long().expand(-1, -1, c)
    return torch.gather(features, 1, flat).reshape(b, m, k, c)


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features: (B, N, C) float32, idx: (B, M, K) int32 -> (B, M, K, C)."""
    if features.dtype != torch.float32 or features.dim() != 3:
        raise ValueError(f"features: expected float32 (B, N, C), got {features.dtype} {tuple(features.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 3 or idx.shape[0] != features.shape[0]:
        raise ValueError(f"idx: expected int32 (B, M, K), got {idx.dtype} {tuple(idx.shape)}")
    if idx.device != features.device:
        raise ValueError("features and idx must share a device")
    b, n, c = features.shape
    _, m, k = idx.shape
    if features.device.type == "cpu":
        return group_points_plain(features, idx)
    if features.device.type != "cuda":
        raise ValueError(f"group_points: unsupported device {features.device}")
    if not (features.is_contiguous() and idx.is_contiguous()):
        raise ValueError("group_points: inputs must be contiguous")
    _kernels.check_cuda_inference(features)
    out = torch.empty((b, m, k, c), dtype=torch.float32, device=features.device)
    _kernels.launch("coda_gather", features, idx, out, b, n, m * k, c)
    return out


def query_and_group(radius: float, nsample: int, xyz, new_xyz, normalize_xyz: bool = False):
    """Ball query + grouped, re-centred xyz (reference QueryAndGroup, xyz only:
    grouping point features is not ported yet).

    Returns (new_features, grouped_xyz), both (B, M, nsample, 3): without
    point features the two are the same tensor, as in the JAX package.
    """
    idx = ball_query(radius, nsample, xyz, new_xyz)
    grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if normalize_xyz:
        grouped_xyz = grouped_xyz / radius
    return grouped_xyz, grouped_xyz
