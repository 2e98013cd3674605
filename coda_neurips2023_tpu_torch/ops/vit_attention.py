"""Unmasked softmax attention for the CLIP ViT image tower (PyTorch + kernel E).

Counterpart of coda_neurips2023_tpu/ops/pallas_vit_attention.py ::
vit_attention.  q, k and v are (B, H, S, D) in the JAX kernel's layout (k is
not transposed), q unscaled; the result is softmax(q k^T / sqrt(D)) v over
all S keys, (B, H, S, D), with the scores and the softmax in fp32.

On a CUDA tensor `vit_attention` launches kernel E (csrc/vit_attention.cu);
on a CPU tensor it takes `vit_attention_plain`.  Both run in fp32; the JAX
package reaches its kernel only with a bf16 tower, which the port does not
have yet.
"""

from __future__ import annotations

import math

import torch

from coda_neurips2023_tpu_torch import _kernels

KERNEL_HEAD_DIMS = (32, 64)
_MAX_SMEM_BYTES = 232448  # a block's shared-memory limit on sm_90
_TQ = _TK = 64


def _smem_bytes(s: int, d: int) -> int:
    """Kernel E's shared memory at sequence length s (csrc :: smem_bytes)."""
    sp = -(-s // _TK) * _TK
    return 4 * (sp * (d + 1) + s * d + _TQ * (d + 1) + _TQ * (sp + 1) + _TQ)


def vit_attention_plain(q, k, v) -> torch.Tensor:
    """Plain PyTorch version of `vit_attention`, on any device."""
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    return torch.matmul(torch.softmax(scores, dim=-1), v)


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32 or t.dim() != 4:
            raise ValueError(f"{name}: expected float32 (B, H, S, D), got {t.dtype} {tuple(t.shape)}")
    if not q.shape == k.shape == v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} differ")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k and v must share a device")


def vit_attention(q, k, v) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v at (B, H, S, D), no mask."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return vit_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"vit_attention: unsupported device {q.device}")
    b, h, s, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"vit_attention: head width {d} not in {KERNEL_HEAD_DIMS}")
    if _smem_bytes(s, d) > _MAX_SMEM_BYTES:
        raise ValueError(f"vit_attention: S={s} at D={d} needs more shared memory than a block has")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("vit_attention: inputs must be contiguous and 16-byte aligned")
    _kernels.check_no_grad("vit_attention", q, k, v)
    out = torch.empty_like(q)
    _kernels.launch("coda_vit_attention", q, k, v, out, b * h, s, d, 1.0 / math.sqrt(d))
    return out
