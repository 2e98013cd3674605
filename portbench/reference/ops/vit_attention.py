"""The image tower's softmax attention, plain.

A frozen copy of the plain functions of the port's ops/vit_attention.py, with no kernel
behind them: every call takes the plain PyTorch path, on any device."""

from __future__ import annotations

import math

import torch

def vit_attention_plain(q, k, v) -> torch.Tensor:
    """Plain PyTorch version of `vit_attention`, on any device."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if q.dtype != torch.bfloat16:
        scores = torch.matmul(q, k.transpose(-1, -2)) * scale
        return torch.matmul(torch.softmax(scores, dim=-1), v)
    # bf16 products are exact in fp32, so fp32 matmuls of the upcast
    # operands are the fp32-accumulated bf16 products
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = (e * (1.0 / e.sum(-1, keepdim=True))).to(torch.bfloat16)
    return torch.matmul(p.float(), v.float()).to(torch.bfloat16)


def vit_attention(q, k, v) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v at (B, H, S, D), no mask, in q's dtype."""
    return vit_attention_plain(q, k, v)
