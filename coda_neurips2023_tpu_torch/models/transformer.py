"""DETR-style pre-norm transformer encoder and decoder (PyTorch, batch-first).

Counterpart of the vanilla encoder and the decoder of
coda_neurips2023_tpu/models/transformer.py, with the reference's parameter
names (`layers.{i}.self_attn.in_proj_weight`, `norm1`, `linear1`, ...).

Attention follows flax's MultiHeadDotProductAttention: q, k and v are
projected, q is scaled by 1/sqrt(D) before the product, and the heads'
outputs go through `out_proj`.  Encoder self-attention and decoder
cross-attention run through `ops.masked_attention` (kernel D on CUDA) at
every size; the decoder's self-attention over the queries stays plain
PyTorch, as flax MHA stays outside any kernel in the JAX package.

The radius-masked encoder with its interim set abstraction is not ported
yet.  Dropout is an eval-time identity and is left out.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from coda_neurips2023_tpu_torch.models.helpers import ACT, Dense, LayerNorm
from coda_neurips2023_tpu_torch.ops.masked_attention import (
    masked_attention,
    masked_attention_plain,
)


class MultiheadAttention(nn.Module):
    """Parameters as torch.nn.MultiheadAttention's: in_proj_weight (3C, C),
    in_proj_bias (3C,), out_proj.{weight, bias}."""

    def __init__(self, d_model: int, nhead: int, device=None):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty((3 * d_model, d_model), device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model, device=device))
        self.out_proj = Dense(d_model, d_model, device=device)

    def forward(self, query, key, value, use_kernel: bool = True) -> torch.Tensor:
        """query (B, Sq, C), key/value (B, Skv, C) -> (B, Sq, C)."""
        b, sq, c = query.shape
        skv = key.shape[1]
        h = self.nhead
        d = c // h
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = nn.functional.linear(query, wq, bq).reshape(b, sq, h, d).transpose(1, 2)
        q = (q / math.sqrt(d)).contiguous()  # (B, H, Sq, D), flax scales first
        k = nn.functional.linear(key, wk, bk).reshape(b, skv, h, d).permute(0, 2, 3, 1)
        v = nn.functional.linear(value, wv, bv).reshape(b, skv, h, d).transpose(1, 2)
        attend = masked_attention if use_kernel else masked_attention_plain
        out = attend(q, k.contiguous(), v.contiguous(), None, None, 0.0)
        return self.out_proj(out.transpose(1, 2).reshape(b, sq, c))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int = 4, dim_feedforward: int = 128,
                 activation: str = "relu", device=None):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, device=device)
        self.linear1 = Dense(d_model, dim_feedforward, device=device)
        self.linear2 = Dense(dim_feedforward, d_model, device=device)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.activation = ACT[activation]()

    def forward(self, src, pos=None):
        src2 = self.norm1(src)
        q = src2 if pos is None else src2 + pos
        src = src + self.self_attn(q, q, src2)
        src2 = self.norm2(src)
        return src + self.linear2(self.activation(self.linear1(src2)))


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int = 4,
                 dim_feedforward: int = 128, activation: str = "relu", device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, activation, device=device)
            for _ in range(num_layers)
        )

    def forward(self, src, xyz=None, pos=None):
        """Returns (xyz, features, inds): the vanilla encoder keeps every point."""
        out = src
        for layer in self.layers:
            out = layer(out, pos=pos)
        return xyz, out, None


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int = 4, dim_feedforward: int = 256,
                 activation: str = "relu", device=None):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, device=device)
        self.multihead_attn = MultiheadAttention(d_model, nhead, device=device)
        self.linear1 = Dense(d_model, dim_feedforward, device=device)
        self.linear2 = Dense(dim_feedforward, d_model, device=device)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.activation = ACT[activation]()

    def forward(self, tgt, memory, query_pos=None, pos=None):
        tgt2 = self.norm1(tgt)
        q = tgt2 if query_pos is None else tgt2 + query_pos
        tgt = tgt + self.self_attn(q, q, tgt2, use_kernel=False)
        tgt2 = self.norm2(tgt)
        qq = tgt2 if query_pos is None else tgt2 + query_pos
        kk = memory if pos is None else memory + pos
        tgt = tgt + self.multihead_attn(qq, kk, memory)
        tgt2 = self.norm3(tgt)
        return tgt + self.linear2(self.activation(self.linear1(tgt2)))


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int = 4,
                 dim_feedforward: int = 256, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_model, nhead, dim_feedforward, device=device)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm(d_model, device=device)

    def forward(self, tgt, memory, query_pos=None, pos=None) -> torch.Tensor:
        """Returns (num_layers, B, nq, C): every layer's output through the
        shared final norm."""
        out = tgt
        intermediate = []
        for layer in self.layers:
            out = layer(out, memory, query_pos=query_pos, pos=pos)
            intermediate.append(self.norm(out))
        return torch.stack(intermediate)
