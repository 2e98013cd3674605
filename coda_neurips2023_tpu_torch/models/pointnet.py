"""PointNet++ set abstraction (PyTorch, channels-last).

Counterpart of coda_neurips2023_tpu/models/pointnet.py: FPS (kernel A) ->
gather the centres (kernel C) -> ball query (kernel B) and group the
re-centred, radius-normalized xyz, and the point features where there are
any, beside it (kernel C) -> shared MLP of 1x1 convs
without bias, each followed by BatchNorm and ReLU -> max over the
neighbourhood.  Parameter names are the reference's
(`mlp_module.layer{i}.conv.weight` (O, I, 1, 1), `mlp_module.layer{i}.bn.bn.*`).

With a bf16 compute dtype the convs run in bf16 and BatchNorm and ReLU in
fp32 (JAX pointnet.py:36-45), so the features leave fp32; FPS, the ball
query and the grouping keep the fp32 coordinates, and kernels A, B and C see
the inputs they see in fp32.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from coda_neurips2023_tpu_torch.models.helpers import BatchNorm, Dense
from coda_neurips2023_tpu_torch.ops.grouping import query_and_group
from coda_neurips2023_tpu_torch.ops.sampling import furthest_point_sample, gather_points


class _BNWrapper(nn.Module):  # the reference's BatchNorm2d wrapper: `bn.bn`
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.bn = BatchNorm(dim, device=device)

    def forward(self, x):
        return self.bn(x)


class _ConvBNReLU(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, device=None, dtype=torch.float32):
        super().__init__()
        self.conv = Dense(in_dim, out_dim, bias=False, kernel_dims=2, device=device, dtype=dtype)
        self.bn = _BNWrapper(out_dim, device=device)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class SharedMLP(nn.Module):
    def __init__(self, dims: Sequence[int], device=None, dtype=torch.float32):
        """dims: [in, h1, ..., out] channel counts; dtype: the convs' compute dtype."""
        super().__init__()
        for i in range(len(dims) - 1):
            self.add_module(f"layer{i}", _ConvBNReLU(dims[i], dims[i + 1], device=device,
                                                     dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


class PointnetSAModuleVotes(nn.Module):
    """Single-scale set abstraction with max pooling (use_xyz).

    forward(xyz (B, N, 3), features (B, N, mlp_dims[0]) or None) ->
    (new_xyz (B, npoint, 3), new_features (B, npoint, mlp_dims[-1]),
    inds (B, npoint) int32).  mlp_dims[0] is the feature count (0: xyz
    only); the MLP takes mlp_dims[0] + 3 inputs, the grouped xyz first.
    """

    def __init__(self, npoint: int, radius: float, nsample: int, mlp_dims: Sequence[int],
                 normalize_xyz: bool = False, device=None, dtype=torch.float32):
        super().__init__()
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.normalize_xyz = normalize_xyz
        self.in_features = mlp_dims[0]
        self.mlp_module = SharedMLP([mlp_dims[0] + 3, *mlp_dims[1:]], device=device, dtype=dtype)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor = None):
        width = 0 if features is None else features.shape[-1]
        if width != self.in_features:
            raise ValueError(f"PointnetSAModuleVotes: {width} point features, built for "
                             f"{self.in_features}")
        inds = furthest_point_sample(xyz, self.npoint)
        new_xyz = gather_points(xyz, inds)
        grouped, _ = query_and_group(self.radius, self.nsample, xyz, new_xyz,
                                     None if features is None else features.contiguous(),
                                     normalize_xyz=self.normalize_xyz)
        out = self.mlp_module(grouped)  # (B, npoint, nsample, C)
        return new_xyz, torch.amax(out, dim=2), inds
