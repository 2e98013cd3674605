"""Fourier position embedding over 3D coordinates (PyTorch).

Counterpart of the fourier mode of
coda_neurips2023_tpu/models/position_embedding.py.  `gauss_B` (3,
d_pos // 2) is a fixed Gaussian projection: checkpoint state, so a buffer,
not a parameter.  Points are always normalized into the scene extent first,
as the detector calls it.  The sine mode is not on the ported path.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from coda_neurips2023_tpu_torch.ops.box_ops import shift_scale_points


class PositionEmbeddingCoordsSine(nn.Module):
    def __init__(self, d_pos: int, pos_type: str = "fourier", device=None):
        super().__init__()
        if pos_type != "fourier":
            raise NotImplementedError(f"pos_type {pos_type!r} is not ported yet")
        self.register_buffer("gauss_B", torch.empty((3, d_pos // 2), device=device))

    def forward(self, xyz: torch.Tensor, input_range) -> torch.Tensor:
        """xyz (B, N, 3), normalized into input_range = (min, max), each (B, 3)
        -> (B, N, d_pos)."""
        xyz = shift_scale_points(xyz, input_range)
        proj = torch.matmul(xyz * (2 * math.pi), self.gauss_B)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
