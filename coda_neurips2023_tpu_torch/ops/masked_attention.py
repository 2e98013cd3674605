"""Softmax attention, optionally radius-masked (PyTorch + kernel D).

Counterpart of coda_neurips2023_tpu/ops/pallas_masked_attention.py.  The
layouts and argument order are the JAX package's: q (B, H, Sq, D) already
scaled by 1/sqrt(D), k (B, H, D, Skv), v (B, H, Skv, D), qxyz (B, Sq, 3),
kxyz_t (B, 3, Skv).  With radius > 0 a key is allowed where
sqrt(max(|q|^2 + |k|^2 - 2 q.k, 0)) < radius, the radius being already
squared by the caller (a reference quirk kept verbatim); disallowed scores
are set to finfo(f32).min before the softmax.  With radius <= 0 the
coordinates are ignored and may be None.

On a CUDA tensor `masked_attention` launches kernel D (csrc/attention.cu);
on a CPU tensor it takes `masked_attention_plain`.  Both run in fp32: the
JAX package's TPU default of bf16 operands is a precision choice for a later,
measured change.
"""

from __future__ import annotations

import torch

from coda_neurips2023_tpu_torch import _kernels

KERNEL_HEAD_DIMS = (16, 32, 64, 128)


def masked_attention_plain(q, k, v, qxyz, kxyz_t, radius: float) -> torch.Tensor:
    """Plain PyTorch version of `masked_attention`, on any device."""
    scores = torch.matmul(q, k)  # (B, H, Sq, Skv)
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
    return torch.matmul(torch.softmax(scores, dim=-1), v)


def _check(q, k, v, qxyz, kxyz_t, radius) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32 or t.dim() != 4:
            raise ValueError(f"{name}: expected float32 4-D, got {t.dtype} {tuple(t.shape)}")
    b, h, sq, d = q.shape
    skv = v.shape[2]
    if tuple(k.shape) != (b, h, d, skv) or tuple(v.shape) != (b, h, skv, d):
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not"
            " match (B,H,Sq,D), (B,H,D,Skv), (B,H,Skv,D)"
        )
    if radius > 0:
        if qxyz is None or kxyz_t is None:
            raise ValueError("radius > 0 needs qxyz and kxyz_t")
        if tuple(qxyz.shape) != (b, sq, 3) or tuple(kxyz_t.shape) != (b, 3, skv):
            raise ValueError(f"qxyz {tuple(qxyz.shape)} / kxyz_t {tuple(kxyz_t.shape)} mismatch")
        if qxyz.dtype != torch.float32 or kxyz_t.dtype != torch.float32:
            raise ValueError("qxyz and kxyz_t must be float32")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k and v must share a device")


def masked_attention(q, k, v, qxyz=None, kxyz_t=None, radius: float = 0.0) -> torch.Tensor:
    """Radius-masked (radius > 0) or plain (radius <= 0) softmax attention
    -> (B, H, Sq, D)."""
    radius = float(radius)
    _check(q, k, v, qxyz, kxyz_t, radius)
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, qxyz, kxyz_t, radius)
    if q.device.type != "cuda":
        raise ValueError(f"masked_attention: unsupported device {q.device}")
    b, h, sq, d = q.shape
    skv = v.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"masked_attention: head width {d} not in {KERNEL_HEAD_DIMS}")
    coords = (qxyz, kxyz_t) if radius > 0 else ()
    if not all(t.is_contiguous() for t in (q, k, v, *coords)):
        raise ValueError("masked_attention: inputs must be contiguous")
    _kernels.check_cuda_inference(q, k, v)
    out = torch.empty_like(q)
    qx, kx = coords if coords else (None, None)
    _kernels.launch("coda_attention", q, k, v, qx, kx, out, b, h, sq, skv, d, radius)
    return out
