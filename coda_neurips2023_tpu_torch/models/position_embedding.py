"""Position embeddings over 3D coordinates (PyTorch), fourier and sine.

Counterpart of coda_neurips2023_tpu/models/position_embedding.py.  Points
are always normalized into the scene extent first, as the detector calls it.

  * "fourier" (--pos_embed fourier, the default): `gauss_B` (3, d_pos // 2)
    is a fixed Gaussian projection, checkpoint state, so a buffer, not a
    parameter; the output is [sin(2 pi x B), cos(2 pi x B)].
  * "sine" (--pos_embed sine, the reference's get_sine_embeddings): each
    axis takes d_pos // 3 channels rounded down to an even count, the first
    axes two more each while d_pos leaves a remainder; channel c of an axis
    divides 2 pi x by 10000 ** (2 floor(c / 2) / its width), and the sines
    of the even channels and the cosines of the odd ones are interleaved.
    Nothing is drawn, so there is no `gauss_B`: the reference's state dict
    has none, and a strict restore expects none.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from coda_neurips2023_tpu_torch.ops.box_ops import shift_scale_points

POS_TYPES = ("fourier", "sine")
TEMPERATURE = 10000.0


def sine_divisors(d_pos: int) -> list:
    """Each axis's (width,) float32 divisors of the sine mode, as the JAX
    package computes them in numpy."""
    ndim = d_pos // 3
    if ndim % 2 != 0:
        ndim -= 1
    rems = d_pos - ndim * 3
    out = []
    for _ in range(3):
        cdim = ndim
        if rems > 0:
            cdim += 2
            rems -= 2
        dim_t = np.arange(cdim, dtype=np.float32)
        out.append(TEMPERATURE ** (2 * np.floor(dim_t / 2) / cdim))
    return out


class PositionEmbeddingCoordsSine(nn.Module):
    def __init__(self, d_pos: int, pos_type: str = "fourier", device=None):
        super().__init__()
        if pos_type not in POS_TYPES:
            raise ValueError(f"pos_type {pos_type!r} not in {POS_TYPES}")
        self.d_pos = d_pos
        self.pos_type = pos_type
        if pos_type == "fourier":
            self.register_buffer("gauss_B", torch.empty((3, d_pos // 2), device=device))

    def forward(self, xyz: torch.Tensor, input_range) -> torch.Tensor:
        """xyz (B, N, 3), normalized into input_range = (min, max), each (B, 3)
        -> (B, N, d_pos)."""
        xyz = shift_scale_points(xyz, input_range)
        if self.pos_type == "fourier":
            proj = torch.matmul(xyz * (2 * math.pi), self.gauss_B)
            return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
        embeds = []
        for d, dim_t in enumerate(sine_divisors(self.d_pos)):
            pos = (xyz[:, :, d] * (2 * math.pi))[:, :, None] / torch.from_numpy(dim_t).to(xyz.device)
            pos = torch.stack([torch.sin(pos[:, :, 0::2]), torch.cos(pos[:, :, 1::2])], dim=3)
            embeds.append(pos.flatten(2))
        return torch.cat(embeds, dim=-1)
