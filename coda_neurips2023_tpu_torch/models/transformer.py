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

With a bf16 compute dtype (--compute_dtype bf16, eval only) each layer
runs as the JAX package's bf16 layer (transformer.py:138-191, 306-358):
LayerNorms and the residual stream stay fp32; the projections, the out
projection, linear1 and linear2 take bf16 inputs and weights (flax's
`dtype`); q is scaled in bf16; encoder self-attention and decoder
cross-attention run kernel D-bf16 (compute_dtype "bfloat16"); the decoder's
self-attention over the queries is flax's stock MHA in bf16 (bf16 scores
and softmax, `dot_product_attention_weights` with force_fp32_for_softmax
False), which the JAX package takes there even on a TPU (its fused gate
needs 1,024 tokens); and each layer's output is fp32 again.

The radius-masked encoder with its interim set abstraction is not ported
yet.  In training mode each layer applies flax's dropouts at its rate: on
the attention weights inside each attention (kernel D or the plain version
draw the mask from a seed; see ops/masked_attention.py), on the attention
output, after the FFN activation and on the FFN output.  Every draw comes
from the `generator` the forward is given.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from coda_neurips2023_tpu_torch.models.helpers import (
    ACT,
    Dense,
    LayerNorm,
    dropout,
    flax_softmax,
    linear,
    rounded,
)
from coda_neurips2023_tpu_torch.ops.masked_attention import (
    masked_attention,
    masked_attention_plain,
)


class MultiheadAttention(nn.Module):
    """Parameters as torch.nn.MultiheadAttention's: in_proj_weight (3C, C),
    in_proj_bias (3C,), out_proj.{weight, bias}."""

    def __init__(self, d_model: int, nhead: int, device=None, dtype=torch.float32):
        super().__init__()
        self.nhead = nhead
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty((3 * d_model, d_model), device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model, device=device))
        self.out_proj = Dense(d_model, d_model, device=device, weight_init="xavier_uniform",
                              dtype=dtype)

    def forward(self, query, key, value, use_kernel: bool = True, dropout: float = 0.0,
                generator=None) -> torch.Tensor:
        """query (B, Sq, C), key/value (B, Skv, C) -> (B, Sq, C); in training
        mode the attention weights are dropped at rate `dropout`."""
        b, sq, c = query.shape
        skv = key.shape[1]
        h = self.nhead
        d = c // h
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        if self.dtype != torch.float32:
            dt = self.dtype
            q = linear(query, wq, bq, dt).reshape(b, sq, h, d).transpose(1, 2)
            q = (q / rounded(math.sqrt(d), dt)).contiguous()
            k = linear(key, wk, bk, dt).reshape(b, skv, h, d).permute(0, 2, 3, 1).contiguous()
            v = linear(value, wv, bv, dt).reshape(b, skv, h, d).transpose(1, 2).contiguous()
            if use_kernel:
                out = masked_attention(q, k, v, None, None, 0.0, "bfloat16")
            else:
                out = torch.matmul(flax_softmax(torch.matmul(q, k)), v)
            return self.out_proj(out.transpose(1, 2).reshape(b, sq, c))
        q = nn.functional.linear(query, wq, bq).reshape(b, sq, h, d).transpose(1, 2)
        q = (q / math.sqrt(d)).contiguous()  # (B, H, Sq, D), flax scales first
        k = nn.functional.linear(key, wk, bk).reshape(b, skv, h, d).permute(0, 2, 3, 1)
        v = nn.functional.linear(value, wv, bv).reshape(b, skv, h, d).transpose(1, 2)
        attend = masked_attention if use_kernel else masked_attention_plain
        seed = None
        if self.training and dropout > 0:
            seed = torch.randint(0, 2 ** 62, (), dtype=torch.int64, device=query.device,
                                 generator=generator)
        else:
            dropout = 0.0
        out = attend(q, k.contiguous(), v.contiguous(), None, None, 0.0, dropout=dropout,
                     seed=seed)
        return self.out_proj(out.transpose(1, 2).reshape(b, sq, c))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int = 4, dim_feedforward: int = 128,
                 activation: str = "relu", dropout: float = 0.1, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model, nhead, device=device, dtype=dtype)
        self.linear1 = Dense(d_model, dim_feedforward, device=device,
                             weight_init="xavier_uniform", dtype=dtype)
        self.linear2 = Dense(dim_feedforward, d_model, device=device,
                             weight_init="xavier_uniform", dtype=dtype)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.activation = ACT[activation]()

    def _drop(self, x, generator):
        return dropout(x, self.dropout, self.training, generator)

    def forward(self, src, pos=None, generator=None):
        src2 = self.norm1(src)
        q = src2 if pos is None else src2 + pos
        attn = self.self_attn(q, q, src2, dropout=self.dropout, generator=generator)
        src = src + self._drop(attn, generator)
        src2 = self.norm2(src)
        ff = self._drop(self.activation(self.linear1(src2)), generator)
        return src + self._drop(self.linear2(ff), generator)  # fp32 + the dtype's: fp32


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int = 4,
                 dim_feedforward: int = 128, activation: str = "relu",
                 dropout: float = 0.1, device=None, dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, activation, dropout,
                                    device=device, dtype=dtype)
            for _ in range(num_layers)
        )

    def forward(self, src, xyz=None, pos=None, generator=None):
        """Returns (xyz, features, inds): the vanilla encoder keeps every point."""
        out = src
        for layer in self.layers:
            out = layer(out, pos=pos, generator=generator)
        return xyz, out, None


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int = 4, dim_feedforward: int = 256,
                 activation: str = "relu", dropout: float = 0.1, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model, nhead, device=device, dtype=dtype)
        self.multihead_attn = MultiheadAttention(d_model, nhead, device=device, dtype=dtype)
        self.linear1 = Dense(d_model, dim_feedforward, device=device,
                             weight_init="xavier_uniform", dtype=dtype)
        self.linear2 = Dense(dim_feedforward, d_model, device=device,
                             weight_init="xavier_uniform", dtype=dtype)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.activation = ACT[activation]()

    def _drop(self, x, generator):
        return dropout(x, self.dropout, self.training, generator)

    def forward(self, tgt, memory, query_pos=None, pos=None, generator=None):
        tgt2 = self.norm1(tgt)
        q = tgt2 if query_pos is None else tgt2 + query_pos
        sa = self.self_attn(q, q, tgt2, use_kernel=False, dropout=self.dropout, generator=generator)
        tgt = tgt + self._drop(sa, generator)
        tgt2 = self.norm2(tgt)
        qq = tgt2 if query_pos is None else tgt2 + query_pos
        kk = memory if pos is None else memory + pos
        ca = self.multihead_attn(qq, kk, memory, dropout=self.dropout, generator=generator)
        tgt = tgt + self._drop(ca, generator)
        tgt2 = self.norm3(tgt)
        ff = self._drop(self.activation(self.linear1(tgt2)), generator)
        return tgt + self._drop(self.linear2(ff), generator)


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int = 4,
                 dim_feedforward: int = 256, dropout: float = 0.1, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_model, nhead, dim_feedforward, dropout=dropout,
                                    device=device, dtype=dtype)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm(d_model, device=device)

    def forward(self, tgt, memory, query_pos=None, pos=None, generator=None) -> torch.Tensor:
        """Returns (num_layers, B, nq, C): every layer's output through the
        shared final norm."""
        out = tgt
        intermediate = []
        for layer in self.layers:
            out = layer(out, memory, query_pos=query_pos, pos=pos, generator=generator)
            intermediate.append(self.norm(out))
        return torch.stack(intermediate)
