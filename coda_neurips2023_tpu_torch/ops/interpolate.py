"""3-NN search and weighted feature interpolation (PyTorch + kernel C).

Counterpart of coda_neurips2023_tpu/ops/interpolate.py, the pointnet2
library's feature-propagation upsampling (no wired CoDA model calls it):

  * `three_nn`: for each `unknown` point, the 3 nearest `known` points in
    ascending squared distance, ties broken toward the earlier index (the
    JAX package's stable top_k; the reference CUDA scan's strict `<`).
    Distances are the JAX package's |a|^2 + |b|^2 - 2 a.b, so both packages
    rank the same values; a stable sort decides the ties, since torch.topk
    does not promise an order among equal values.
  * `three_interpolate`: out[b, j] = sum_k points[b, idx[b, j, k]] *
    weight[b, j, k], the rows gathered by `group_points` (kernel C on a
    CUDA tensor, with its scatter-add backward).
  * `interpolation_weights`: inverse-distance weights normalized to 1.
"""

from __future__ import annotations

import torch

from coda_neurips2023_tpu_torch.ops.grouping import group_points


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """unknown (B, N, 3), known (B, M, 3), M >= 3 -> (dist2 (B, N, 3) float32,
    idx (B, N, 3) int32)."""
    a, b = unknown.float(), known.float()
    cross = torch.matmul(a, b.transpose(1, 2))
    d2 = (a * a).sum(-1)[..., None] + (b * b).sum(-1)[:, None, :] - 2.0 * cross
    dist2, idx = torch.sort(d2, dim=-1, stable=True)
    return dist2[..., :3], idx[..., :3].to(torch.int32)


def three_interpolate(points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """points (B, M, C) float32, idx (B, N, 3) int32, weight (B, N, 3) -> (B, N, C)."""
    gathered = group_points(points.contiguous(), idx.contiguous())  # (B, N, 3, C)
    return torch.sum(gathered * weight[..., None].to(points.dtype), dim=2)


def interpolation_weights(dist2: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """1 / (dist2 + eps), normalized over the last axis (the reference's
    callers' dist_recip)."""
    recip = 1.0 / (dist2 + eps)
    return recip / torch.sum(recip, dim=-1, keepdim=True)
