"""Radius-masked softmax attention with hashed dropout, plain.

A frozen copy of the plain functions of the port's ops/masked_attention.py, with no kernel
behind them: every call takes the plain PyTorch path, on any device."""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 on int64 tensors holding uint32 values (kernel D's mix32)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def dropout_constants(dropout: float):
    """(threshold, scale): keep where hash >= threshold, times scale (f32)."""
    threshold = min(int(dropout * 2 ** 32), _M32)
    scale = float(torch.tensor(1.0 / (1.0 - dropout), dtype=torch.float32))
    return threshold, scale


def attention_keep_mask(seed: torch.Tensor, sq: int, skv: int, dropout: float) -> torch.Tensor:
    """(Sq, Skv) bool: the attention weights kept by dropout (as kernel D)."""
    threshold, _ = dropout_constants(dropout)
    ij = torch.arange(sq * skv, dtype=torch.int64, device=seed.device) & _M32
    return (_mix32(_mix32(seed & _M32) ^ ij) >= threshold).reshape(sq, skv)


def _scores(q, k, qxyz, kxyz_t, radius: float) -> torch.Tensor:
    """(B, H, Sq, Skv) scores, disallowed keys at finfo(f32).min."""
    scores = torch.matmul(q, k)
    if radius > 0:
        # elementwise, in kernel D's order, so both decide the mask alike
        qx, qy, qz = (qxyz[:, :, i, None] for i in range(3))
        kx, ky, kz = (kxyz_t[:, None, i] for i in range(3))
        cross = (qx * kx + qy * ky) + qz * kz
        sq_q = (qx * qx + qy * qy) + qz * qz
        sq_k = (kx * kx + ky * ky) + kz * kz
        d2 = torch.clamp((sq_q + sq_k) - 2.0 * cross, min=0.0)
        allowed = torch.sqrt(d2) < radius
        scores = scores.masked_fill(~allowed[:, None], torch.finfo(torch.float32).min)
    return scores


def _compute_dtype(compute_dtype) -> torch.dtype:
    """"float32" / "bfloat16" (or "bf16", or a torch dtype) -> torch dtype."""
    if compute_dtype in ("bfloat16", "bf16", torch.bfloat16):
        return torch.bfloat16
    if compute_dtype in ("float32", torch.float32):
        return torch.float32
    raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")


def _bf16_scores(q, k, qxyz, kxyz_t, radius: float) -> torch.Tensor:
    """The scores of bf16-rounded q and k: bf16 products are exact in fp32,
    so an fp32 matmul of the upcast operands sums them in fp32."""
    return _scores(q.to(torch.bfloat16).float(), k.to(torch.bfloat16).float(), qxyz, kxyz_t,
                   radius)


def bf16_dropout_multiplier(dropout: float) -> float:
    """flax's bf16 dropout multiplier: bf16(1) / bf16(1 - dropout), the
    quotient rounded to bf16."""
    keep_prob = torch.tensor(1.0 - dropout, dtype=torch.bfloat16)
    return float(torch.tensor(1.0, dtype=torch.bfloat16) / keep_prob)


def bf16_drop(p: torch.Tensor, keep: torch.Tensor, dropout: float) -> torch.Tensor:
    """bf16 weights `p` dropped in flax's bf16 order: kept ones times
    `bf16_dropout_multiplier`, the product rounded to bf16 (exact in fp32
    before that: both factors hold 8 significant bits); 0 elsewhere."""
    kept = (p.float() * bf16_dropout_multiplier(dropout)).to(torch.bfloat16)
    return torch.where(keep, kept, torch.zeros((), dtype=torch.bfloat16, device=p.device))


def masked_attention_plain(q, k, v, qxyz, kxyz_t, radius: float, compute_dtype="float32",
                           dropout: float = 0.0, seed=None) -> torch.Tensor:
    """Plain PyTorch version of `masked_attention`, on any device."""
    if _compute_dtype(compute_dtype) == torch.bfloat16:
        scores = _bf16_scores(q, k, qxyz, kxyz_t, radius)
        e = torch.exp(scores - scores.amax(-1, keepdim=True))
        p = (e / e.sum(-1, keepdim=True)).to(torch.bfloat16)
        if dropout > 0:
            p = bf16_drop(p, attention_keep_mask(seed, q.shape[2], v.shape[2], dropout), dropout)
        return torch.matmul(p.float(), v.to(torch.bfloat16).float()).to(q.dtype)
    weights = torch.softmax(_scores(q, k, qxyz, kxyz_t, radius), dim=-1)
    if dropout > 0:
        keep = attention_keep_mask(seed, q.shape[2], v.shape[2], dropout)
        _, scale = dropout_constants(dropout)
        weights = torch.where(keep, weights * scale, torch.zeros((), dtype=weights.dtype,
                                                                  device=weights.device))
    return torch.matmul(weights, v)


def masked_attention(q, k, v, qxyz=None, kxyz_t=None, radius: float = 0.0,
                     compute_dtype="float32", dropout: float = 0.0, seed=None) -> torch.Tensor:
    """`masked_attention_plain`, differentiated by autograd."""
    return masked_attention_plain(q, k, v, qxyz, kxyz_t, float(radius), compute_dtype,
                                  float(dropout), seed)
