"""Furthest-point sampling and index gathering (PyTorch + kernels A and C).

Counterparts of coda_neurips2023_tpu/ops/sampling.py:
  * `furthest_point_sample`: index 0 is picked first; points with
    |p|^2 <= 1e-3 are never picked; each step picks the valid point farthest
    from the picked set (running min-distance, initially 1e10), the lowest
    index winning ties.  Kernel A (csrc/fps.cu) on a CUDA tensor, the plain
    version below on a CPU tensor.  Kernel A spreads a scene over a
    thread-block cluster of `fps_cluster_size` blocks, each an arg-max over
    a contiguous slice, merged across the cluster every step;
    `furthest_point_sample_cluster_plain` writes that scheme out.
  * `gather_points`: out[b, j] = points[b, idx[b, j]], through kernel C
    (`grouping.group_points`) on a (B, 1, M) view of the indices.

Distances are ((dx*dx + dy*dy) + dz*dz) in both versions, in that order, so
they agree bit for bit.  Indices are int32.
"""

from __future__ import annotations

import torch

from coda_neurips2023_tpu_torch import _kernels
from coda_neurips2023_tpu_torch.ops.grouping import group_points
from coda_neurips2023_tpu_torch.utils.device import multi_processor_count

_MAG_EPS = 1e-3
_INIT_DIST = 1e10
# kernel A's launch (csrc/fps.cu): blocks of FPS_THREADS threads, each
# thread at most FPS_MAX_POINTS_PER_THREAD points in registers, a scene on
# a cluster of one of FPS_CLUSTER_SIZES blocks (8 is the portable maximum)
FPS_THREADS = 512
FPS_MAX_POINTS_PER_THREAD = 40
FPS_CLUSTER_SIZES = (1, 2, 4, 8)
# a scene is split only while every block keeps this many points: below it
# a step's work is small against the exchange between blocks it adds
# (measured with scripts/bench_fps_variants.py: at 8 x 20000 a cluster of 4,
# 5000 points a block, ran faster than one of 8, 2500 a block)
FPS_MIN_SLICE = 4096


def fps_cluster_size(b: int, n: int, sm_count: int, resident=None) -> int:
    """Blocks of kernel A a scene of n points takes, for b scenes on a card
    of sm_count SMs (a block an SM).  The largest cluster size whose b
    clusters the card runs at once (one wave) and whose blocks each keep at
    least FPS_MIN_SLICE points; at least the size whose threads hold all n
    points (CS x FPS_THREADS x FPS_MAX_POINTS_PER_THREAD >= n).
    `resident(c)`, where given, is how many clusters of c blocks the card
    runs at once; a cluster's SMs share a GPC, so on the card that can fall
    short of sm_count // c, and the wrapper asks the CUDA occupancy API.  At
    132 SMs and sm_count // c: 4 at 32 x 20000, 4 at 8 x 20000, 8 at
    8 x 40000, 1 at 32 x 2048; an H100 SXM runs only 30 clusters of 4 at
    once, so there 32 x 20000 takes 2."""
    need = -(-n // (FPS_THREADS * FPS_MAX_POINTS_PER_THREAD))
    sizes = [c for c in FPS_CLUSTER_SIZES if c >= need]
    if not sizes:
        raise ValueError(f"furthest_point_sample: N={n} exceeds the kernel's "
                         f"{FPS_CLUSTER_SIZES[-1] * FPS_THREADS * FPS_MAX_POINTS_PER_THREAD}")
    at_once = resident or (lambda c: sm_count // c)
    fits = [c for c in sizes if b <= at_once(c) and -(-n // c) >= FPS_MIN_SLICE]
    return max(fits, default=sizes[0])


_resident = {}  # (device index, cluster size) -> clusters of kernel A the card runs at once


def resident_clusters(device: torch.device, cs: int) -> int:
    """Clusters of cs blocks of kernel A that `device` runs at once
    (cudaOccupancyMaxActiveClusters), asked once a device."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), cs)
    if key not in _resident:
        with torch.cuda.device(key[0]):
            got = _kernels.library().coda_fps_resident_clusters(cs)
        if got < 0:
            raise RuntimeError(f"coda_fps_resident_clusters: CUDA error {-got}")
        _resident[key] = got
    return _resident[key]


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


def furthest_point_sample_cluster_plain(xyz: torch.Tensor, npoint: int, cs: int) -> torch.Tensor:
    """`furthest_point_sample_plain` by kernel A's scheme: the N points in cs
    contiguous slices of ceil(N / cs), each slice's arg-max (its first
    maximum), then the slices merged in rank order, the larger value and
    then the lower index winning; an empty slice offers (-2, N)."""
    b, n, _ = xyz.shape
    chunk = -(-n // cs)
    x, y, z = xyz.unbind(-1)
    mag = (x * x + y * y) + z * z
    mind = torch.where(mag > _MAG_EPS, _INIT_DIST, -1.0).to(torch.float32)
    out = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    last = out[:, 0]
    for j in range(1, npoint):
        lx, ly, lz = xyz[rows, last].unbind(-1)
        dx, dy, dz = x - lx[:, None], y - ly[:, None], z - lz[:, None]
        mind = torch.minimum(mind, (dx * dx + dy * dy) + dz * dz)
        best_v = torch.full((b,), -2.0, device=xyz.device)
        best_i = torch.full((b,), n, dtype=torch.int64, device=xyz.device)
        for r in range(cs):
            part = mind[:, r * chunk:(r + 1) * chunk]
            if part.shape[1] == 0:
                continue
            i = torch.argmax(part, dim=1)
            v = part[rows, i]
            i = i + r * chunk
            take = (v > best_v) | ((v == best_v) & (i < best_i))
            best_v, best_i = torch.where(take, v, best_v), torch.where(take, i, best_i)
        last = best_i
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
    cs = fps_cluster_size(b, n, multi_processor_count(xyz.device),
                          lambda c: resident_clusters(xyz.device, c))
    _kernels.check_no_grad("furthest_point_sample", xyz)
    return _fps_kernel(xyz, npoint, cs)


def _fps_kernel(xyz: torch.Tensor, npoint: int, cs: int) -> torch.Tensor:
    """Kernel A on a cluster of cs blocks a scene (xyz checked by the caller)."""
    b, n, _ = xyz.shape
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    _kernels.launch("coda_fps", xyz, out, b, n, npoint, cs)
    return out


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points: (B, N, C) float32, idx: (B, M) int32 -> (B, M, C)."""
    if idx.dim() != 2:
        raise ValueError(f"idx: expected (B, M), got {tuple(idx.shape)}")
    b, m = idx.shape
    return group_points(points, idx.reshape(b, 1, m)).reshape(b, m, points.shape[-1])
