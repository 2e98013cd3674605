"""Unmasked softmax attention for the CLIP ViT image tower (PyTorch + kernel E).

Counterpart of coda_neurips2023_tpu/ops/pallas_vit_attention.py ::
vit_attention.  q, k and v are (B, H, S, D) in the JAX kernel's layout (k is
not transposed), q unscaled; the result is softmax(q k^T / sqrt(D)) v over
all S keys, (B, H, S, D), with the scores and the softmax in fp32.

On a CUDA tensor `vit_attention` launches kernel E (csrc/vit_attention.cu),
whose two products run in 3xTF32 on the tensor cores (fp32-level error); on
a CPU tensor it takes `vit_attention_plain`.  The port's fp32 tower calls it
on every layer, unconditionally.  The JAX package reaches its Pallas kernel
only when three conditions hold at once: a bf16 tower, CODA_CLIP_FUSED_ATTN=1
(coda_neurips2023_tpu/models/clip.py:37, 163) and CODA_VIT_ATTN_IMPL=pallas
(clip.py:128); by default it runs flax's stock attention.  Both compute the
same function; the port has no such gate.
"""

from __future__ import annotations

import math

import torch

from coda_neurips2023_tpu_torch import _kernels

KERNEL_HEAD_DIMS = (32, 64)
_MAX_SMEM_BYTES = 232448  # a block's shared-memory limit on sm_90
# K and V resident in shared memory as TF32 hi and lo parts (csrc kPreSplit)
_RESIDENT_COPIES = 4


def _smem_bytes(s: int, d: int) -> int:
    """Kernel E's shared memory at sequence length s (csrc :: smem_bytes):
    the copies of K and V, rows padded to a multiple of 8 keys, each row to
    d + 4 floats."""
    return 4 * _RESIDENT_COPIES * (-(-s // 8) * 8) * (d + 4)


def max_sequence(d: int) -> int:
    """The longest S kernel E takes at head width d: the largest multiple of
    8 whose `_smem_bytes` fit a block."""
    return _MAX_SMEM_BYTES // _smem_bytes(8, d) * 8


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
        raise ValueError(f"vit_attention: S={s} at D={d} exceeds the kernel's {max_sequence(d)}"
                         " (a head's K and V stay in shared memory)")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("vit_attention: inputs must be contiguous and 16-byte aligned")
    _kernels.check_no_grad("vit_attention", q, k, v)
    out = torch.empty_like(q)
    _kernels.launch("coda_vit_attention", q, k, v, out, b * h, s, d, 1.0 / math.sqrt(d))
    return out
