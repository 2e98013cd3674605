"""Unmasked softmax attention for the CLIP ViT image tower (PyTorch + kernels
E and E-bf16).

Counterpart of coda_neurips2023_tpu/ops/pallas_vit_attention.py ::
vit_attention.  q, k and v are (B, H, S, D) in the JAX kernel's layout (k is
not transposed), q unscaled, all fp32 or all bf16; the result is softmax(q
k^T / sqrt(D)) v over all S keys, (B, H, S, D) in the inputs' dtype, with
the scores and the softmax in fp32.  In bf16 the numerics are the JAX
kernel's at its own operands (_attn_kernel): fp32 sums of bf16 products, p =
e * (1 / sum e) rounded to bf16 before an fp32-summed PV product, the output
rounded to bf16 once.

On a CUDA tensor `vit_attention` launches kernel E (csrc/vit_attention.cu;
fp32, its two products in 3xTF32 on the tensor cores, fp32-level error) or
kernel E-bf16 (csrc/vit_attention_bf16.cu; bf16 mma.sync, one pass over a
head's keys with the score row in registers for S <= 256, persistent blocks
with the next head's TMA copies in flight; two passes for longer S); on a
CPU tensor it takes `vit_attention_plain`.  The port's towers call it on every layer of
the image tower, unconditionally.  The JAX package reaches its Pallas kernel
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
DTYPES = (torch.float32, torch.bfloat16)


def _smem_bytes(s: int, d: int, dtype=torch.float32) -> int:
    """Kernel E's shared memory at sequence length s (csrc :: smem_bytes):
    fp32, the copies of K and V, rows padded to a multiple of 8 keys, each
    row to d + 4 floats; bf16 (E-bf16's two-pass branch for S > 256, which
    sets the longest S; the one-pass branch's two buffers fit at any S <=
    256), K and V once, rows padded to a multiple of 16 keys, each row to d
    + 8 bf16."""
    if dtype == torch.bfloat16:
        return 2 * 2 * (-(-s // 16) * 16) * (d + 8)
    return 4 * _RESIDENT_COPIES * (-(-s // 8) * 8) * (d + 4)


def max_sequence(d: int, dtype=torch.float32) -> int:
    """The longest S the kernel of `dtype` takes at head width d: the
    largest multiple of its key padding whose `_smem_bytes` fit a block."""
    pad = 16 if dtype == torch.bfloat16 else 8
    return _MAX_SMEM_BYTES // _smem_bytes(pad, d, dtype) * pad


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


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES or t.dim() != 4:
            raise ValueError(f"{name}: expected float32 or bfloat16 (B, H, S, D), got {t.dtype} "
                             f"{tuple(t.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype} differ")
    if not q.shape == k.shape == v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} differ")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k and v must share a device")


def vit_attention(q, k, v) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v at (B, H, S, D), no mask, in q's dtype."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return vit_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"vit_attention: unsupported device {q.device}")
    b, h, s, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"vit_attention: head width {d} not in {KERNEL_HEAD_DIMS}")
    if _smem_bytes(s, d, q.dtype) > _MAX_SMEM_BYTES:
        raise ValueError(f"vit_attention: S={s} at D={d} in {q.dtype} exceeds the kernel's "
                         f"{max_sequence(d, q.dtype)} (a head's K and V stay in shared memory)")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("vit_attention: inputs must be contiguous and 16-byte aligned")
    _kernels.check_no_grad("vit_attention", q, k, v)
    out = torch.empty_like(q)
    fn = "coda_vit_attention_bf16" if q.dtype == torch.bfloat16 else "coda_vit_attention"
    _kernels.launch(fn, q, k, v, out, b * h, s, d, 1.0 / math.sqrt(d))
    return out
