"""DETR-style pre-norm transformer encoder and decoder (PyTorch, batch-first).

Counterpart of coda_neurips2023_tpu/models/transformer.py: the vanilla
and the radius-masked encoder and the decoder, with the reference's
parameter names (`layers.{i}.self_attn.in_proj_weight`, `norm1`, `linear1`,
`interim_downsampling.mlp_module...`).

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

`MaskedTransformerEncoder` (--enc_type masked, JAX transformer.py:230-303)
runs three layers whose self-attention allows a key only where the
euclidean distance of the two points lies below the layer's masking radius,
which is already squared (0.4^2, 0.8^2, 1.2^2: a reference quirk kept
verbatim): kernel D's radius mode, `masked_attention(..., qxyz=xyz,
kxyz_t=xyz^T, radius=r^2)`, on the card, its plain version on the CPU, in
training too (D's dropout and its plain recompute).  After layer 0 an
interim set abstraction, `interim_downsampling`, takes preenc_npoints // 2
of the points (FPS, ball query r 0.4 k 32 over the layer's output as point
features, MLP (d, 256, 256, d)); the encoder returns those points' indices.
The JAX package gives this encoder no dtype, so it stays fp32 under a bf16
compute dtype.

In training mode each layer applies flax's dropouts at its rate: on the
attention weights inside each attention (kernel D or the plain version draw
the mask from a seed; see ops/masked_attention.py), on the attention output,
after the FFN activation and on the FFN output.  Every draw comes from the
`generator` the forward is given.

With `remat` (--remat) each encoder and decoder layer runs under
`torch.utils.checkpoint` in training: its activations are recomputed in the
backward instead of kept.  The JAX package's remat replays the same dropout
masks (its rngs are lifted); checkpoint restores only the global RNG
states, so `_checkpointed` also puts the explicit generator back to its
state at the layer's entry for the recompute, and the recompute draws the
forward's masks: the step is the step without remat, bit for bit.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint
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
from coda_neurips2023_tpu_torch.models.pointnet import PointnetSAModuleVotes
from coda_neurips2023_tpu_torch.ops.masked_attention import (
    masked_attention,
    masked_attention_plain,
)

# the masked encoder's squared radii (JAX model_3detr.py:100) and interim SA
MASKING_RADIUS = tuple(x ** 2 for x in (0.4, 0.8, 1.2))
INTERIM_RADIUS = 0.4
INTERIM_NSAMPLE = 32


def _checkpointed(layer, generator, *args):
    """layer(*args, generator=generator) under non-reentrant activation
    checkpointing; the recompute starts from the generator's state at the
    layer's entry (and leaves it where it was), so it draws the forward's
    dropout masks."""
    if generator is None:  # the default generators: checkpoint restores them
        return torch.utils.checkpoint.checkpoint(layer, *args, use_reentrant=False)
    entry = generator.get_state()
    calls = []

    def run(*a):
        if not calls:
            calls.append(True)
            return layer(*a, generator=generator)
        now = generator.get_state()
        generator.set_state(entry)
        try:
            return layer(*a, generator=generator)
        finally:
            generator.set_state(now)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


def _remat(module) -> bool:
    return module.remat and module.training and torch.is_grad_enabled()


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
                generator=None, xyz=None, radius: float = 0.0) -> torch.Tensor:
        """query (B, Sq, C), key/value (B, Skv, C) -> (B, Sq, C); in training
        mode the attention weights are dropped at rate `dropout`.  With
        radius > 0 (self-attention, fp32) a key is allowed only within the
        radius of the query's point: xyz (B, S, 3)."""
        b, sq, c = query.shape
        skv = key.shape[1]
        h = self.nhead
        d = c // h
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        if self.dtype != torch.float32:
            if radius > 0:
                raise ValueError("the radius-masked attention is fp32 (JAX model_3detr.py:97-108)")
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
        qxyz = kxyz_t = None
        if radius > 0:
            qxyz = xyz.contiguous()
            kxyz_t = xyz.transpose(1, 2).contiguous()
        out = attend(q, k.contiguous(), v.contiguous(), qxyz, kxyz_t, radius, dropout=dropout,
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

    def forward(self, src, pos=None, xyz=None, radius: float = 0.0, generator=None):
        """With radius > 0 the self-attention is masked to keys within the
        radius (already squared) of the query's point of xyz (B, S, 3)."""
        src2 = self.norm1(src)
        q = src2 if pos is None else src2 + pos
        attn = self.self_attn(q, q, src2, dropout=self.dropout, generator=generator, xyz=xyz,
                              radius=radius)
        src = src + self._drop(attn, generator)
        src2 = self.norm2(src)
        ff = self._drop(self.activation(self.linear1(src2)), generator)
        return src + self._drop(self.linear2(ff), generator)  # fp32 + the dtype's: fp32


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int = 4,
                 dim_feedforward: int = 128, activation: str = "relu",
                 dropout: float = 0.1, device=None, dtype=torch.float32, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, activation, dropout,
                                    device=device, dtype=dtype)
            for _ in range(num_layers)
        )

    def forward(self, src, xyz=None, pos=None, generator=None):
        """Returns (xyz, features, inds): the vanilla encoder keeps every point."""
        out = src
        for layer in self.layers:
            if _remat(self):
                out = _checkpointed(layer, generator, out, pos)
            else:
                out = layer(out, pos=pos, generator=generator)
        return xyz, out, None


class MaskedTransformerEncoder(nn.Module):
    """Radius-masked encoder with interim downsampling after layer 0
    (reference MaskedTransformerEncoder; JAX transformer.py:230-303), fp32."""

    def __init__(self, d_model: int, interim_npoint: int, nhead: int = 4,
                 dim_feedforward: int = 128, activation: str = "relu", dropout: float = 0.1,
                 device=None, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, activation, dropout,
                                    device=device)
            for _ in MASKING_RADIUS
        )
        self.interim_downsampling = PointnetSAModuleVotes(
            npoint=interim_npoint, radius=INTERIM_RADIUS, nsample=INTERIM_NSAMPLE,
            mlp_dims=(d_model, 256, 256, d_model), normalize_xyz=True, device=device,
        )

    def forward(self, src, xyz, pos=None, generator=None):
        """src (B, S, d), xyz (B, S, 3) -> (xyz (B, S', 3), features (B, S',
        d), inds (B, S') int32: the kept points' indices into xyz), S' = the
        interim SA's npoint."""
        out, inds = src, None
        for i, (layer, radius) in enumerate(zip(self.layers, MASKING_RADIUS)):
            if _remat(self):
                out = _checkpointed(layer, generator, out, pos, xyz, radius)
            else:
                out = layer(out, pos=pos, xyz=xyz, radius=radius, generator=generator)
            if i == 0:
                xyz, out, inds = self.interim_downsampling(xyz, out)
        return xyz, out, inds


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
                 dtype=torch.float32, remat: bool = False):
        super().__init__()
        self.remat = remat
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
            if _remat(self):
                out = _checkpointed(layer, generator, out, memory, query_pos, pos)
            else:
                out = layer(out, memory, query_pos=query_pos, pos=pos, generator=generator)
            intermediate.append(self.norm(out))
        return torch.stack(intermediate)
