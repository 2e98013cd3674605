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

In training, `dropout` > 0 drops attention weights as flax's
MultiHeadDotProductAttention does by default (broadcast_dropout): one keep
mask over (query, key) shared by every batch row and head, kept weights
scaled by 1 / (1 - dropout), the softmax normalized before the drop.  The
mask comes from a counter-based hash of (i * Skv + j) and `seed`, a 0-d
int64 tensor on the inputs' device (drawn from a generator without a host
sync); kernel D and `masked_attention_plain` form the same mask.

`MaskedAttention` is the autograd Function around them, with the JAX
package's backward design (pallas_masked_attention.py:182-200): recompute
the forward through `masked_attention_plain` and pull dq, dk and dv back
through it with autograd.  The coordinates take no gradient.  The backward
is plain PyTorch on both devices; a hand-written backward kernel is later,
measured work.
"""

from __future__ import annotations

import torch

from coda_neurips2023_tpu_torch import _kernels

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
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


def masked_attention_plain(q, k, v, qxyz, kxyz_t, radius: float,
                           dropout: float = 0.0, seed=None) -> torch.Tensor:
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
    weights = torch.softmax(scores, dim=-1)
    if dropout > 0:
        keep = attention_keep_mask(seed, q.shape[2], v.shape[2], dropout)
        _, scale = dropout_constants(dropout)
        weights = torch.where(keep, weights * scale, torch.zeros((), dtype=weights.dtype,
                                                                  device=weights.device))
    return torch.matmul(weights, v)


def _check(q, k, v, qxyz, kxyz_t, radius, dropout, seed) -> None:
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
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout must lie in [0, 1), got {dropout}")
    if dropout > 0 and (seed is None or seed.dtype != torch.int64 or seed.dim() != 0
                        or seed.device != q.device):
        raise ValueError("dropout > 0 needs `seed`, a 0-d int64 tensor on the inputs' device")


def masked_attention(q, k, v, qxyz=None, kxyz_t=None, radius: float = 0.0,
                     dropout: float = 0.0, seed=None) -> torch.Tensor:
    """Radius-masked (radius > 0) or plain (radius <= 0) softmax attention,
    with the attention weights dropped at rate `dropout` -> (B, H, Sq, D)."""
    radius, dropout = float(radius), float(dropout)
    _check(q, k, v, qxyz, kxyz_t, radius, dropout, seed)
    if q.device.type == "cuda":
        d = q.shape[-1]
        if d not in KERNEL_HEAD_DIMS:
            raise ValueError(f"masked_attention: head width {d} not in {KERNEL_HEAD_DIMS}")
        coords = (qxyz, kxyz_t) if radius > 0 else ()
        if not all(t.is_contiguous() for t in (q, k, v, *coords)):
            raise ValueError("masked_attention: inputs must be contiguous")
    elif q.device.type != "cpu":
        raise ValueError(f"masked_attention: unsupported device {q.device}")
    return MaskedAttention.apply(q, k, v, qxyz, kxyz_t, radius, dropout, seed)


def _attention_kernel(q, k, v, qxyz, kxyz_t, radius: float, dropout: float, seed) -> torch.Tensor:
    b, h, sq, d = q.shape
    skv = v.shape[2]
    out = torch.empty_like(q)
    qx, kx = (qxyz, kxyz_t) if radius > 0 else (None, None)
    threshold, scale = dropout_constants(dropout) if dropout > 0 else (0, 0.0)
    _kernels.launch("coda_attention", q, k, v, qx, kx, out, b, h, sq, skv, d, radius,
                    seed if dropout > 0 else None, threshold, scale)
    return out


class MaskedAttention(torch.autograd.Function):
    """Forward: kernel D on a CUDA tensor, `masked_attention_plain` on a CPU
    one.  Backward: autograd of `masked_attention_plain`, recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, qxyz, kxyz_t, radius, dropout=0.0, seed=None):
        ctx.save_for_backward(q, k, v, qxyz, kxyz_t, seed)
        ctx.radius, ctx.dropout = radius, dropout
        if q.device.type == "cpu":
            return masked_attention_plain(q, k, v, qxyz, kxyz_t, radius, dropout, seed)
        return _attention_kernel(q, k, v, qxyz, kxyz_t, radius, dropout, seed)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, qxyz, kxyz_t, seed = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip((q, k, v), ctx.needs_input_grad[:3])]
            out = masked_attention_plain(*leaves, qxyz, kxyz_t, ctx.radius, ctx.dropout, seed)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad) if wanted else ())
        return (*(next(grads) if t.requires_grad else None for t in leaves),
                None, None, None, None, None)
