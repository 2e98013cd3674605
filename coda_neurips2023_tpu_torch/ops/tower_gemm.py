"""The frozen CLIP image tower's fp32 linear layers (PyTorch + kernel H).

`tower_linear(x, weight, bias, epilogue)` is `F.linear(x, weight, bias)`
followed by its epilogue:
  * "bias": nothing more (the attention's qkv projection);
  * "gelu": `quick_gelu` (the MLP's c_fc);
  * "residual": `residual + y` (out_proj and c_proj, so that a block's
    `x + attn(...)` and `x + mlp(...)` cost no pass of their own);
  * "qkv": q, k and v in kernel E's (B, H, S, D) layout, stacked as (3, B,
    H, S, D), from x (B, S, W) and the (3 W, W) in-projection of `heads`
    heads (what `.view(b, s, 3, h, d).permute(2, 0, 3, 1, 4)` and three
    `.contiguous()` copies give).

On a CUDA tensor it launches kernel H (csrc/tower_gemm.cu): 3xTF32 `wgmma`
products at fp32-level error, the epilogue on the accumulators, one launch a
call (`_kernels.LAUNCHES["tower_gemm"]`).  The weight's TF32 parts, hi =
tf32(W) and lo = tf32(W - hi), are made once a weight (`weight_parts`) and
kept beside it until its storage or version changes.  On a CPU tensor it
takes `tower_linear_plain`, the same function in PyTorch.  There is no
fallback from the kernel to cuBLAS, and no backward: the tower is frozen
(`StageContext.clip_image_fn` runs it under no_grad), so an input that would
need a gradient raises, on every device.

Only the image tower calls it (models/clip.py), in fp32 and off a
tensor-parallel grid; the text tower, the bf16 tower and the grid's blocks
keep `helpers.linear`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from coda_neurips2023_tpu_torch import _kernels

EPILOGUES = {"bias": 0, "gelu": 1, "residual": 2, "qkv": 3}
# weight -> ((data_ptr, version), hi, lo)
_PARTS = WeakIdKeyDictionary()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), the constant rounded to x's dtype as JAX rounds it
    (models/helpers.py `rounded`)."""
    return x * torch.sigmoid(float(torch.tensor(1.702, dtype=x.dtype)) * x)


def split_tf32(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 w as hi + lo, both TF32 (the low 13 bits zero), each rounded to
    nearest with ties away from zero as csrc/tf32_mma.cuh's `tf32_rna`
    rounds them: hi = tf32(w), lo = tf32(w - hi)."""
    hi = ((w.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    lo = (((w - hi).view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return hi, lo


def weight_parts(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`split_tf32(weight)`, made once and kept while the weight's storage
    and version stay the same (a load_state_dict or any in-place write
    makes them anew)."""
    key = (weight.data_ptr(), weight._version)
    kept = _PARTS.get(weight)
    if kept is None or kept[0] != key:
        with torch.no_grad():
            kept = (key, *split_tf32(weight.detach()))
        _PARTS[weight] = kept
    return kept[1], kept[2]


def _qkv_layout(y: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, n = y.shape
    return y.view(b, s, 3, heads, n // (3 * heads)).permute(2, 0, 3, 1, 4).contiguous()


def tower_linear_plain(x, weight, bias, epilogue="bias", residual=None, heads=None):
    """Plain PyTorch version of `tower_linear`, on any device."""
    y = F.linear(x, weight, bias)
    if epilogue == "gelu":
        return quick_gelu(y)
    if epilogue == "residual":
        return residual + y
    if epilogue == "qkv":
        return _qkv_layout(y, heads)
    return y


def _check(x, weight, bias, epilogue, residual, heads) -> None:
    if epilogue not in EPILOGUES:
        raise ValueError(f"tower_linear: epilogue {epilogue!r} not in {sorted(EPILOGUES)}")
    tensors = {"x": x, "weight": weight, "bias": bias}
    if epilogue == "residual":
        tensors["residual"] = residual
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise ValueError(f"tower_linear: {name} must be a float32 tensor, got "
                             f"{getattr(t, 'dtype', type(t))}")
        if not t.is_contiguous():
            raise ValueError(f"tower_linear: {name} must be contiguous")
    if len({t.device for t in tensors.values()}) != 1:
        raise ValueError("tower_linear: the tensors must share a device")
    n, k = weight.shape if weight.dim() == 2 else (None, None)
    if k is None or x.dim() < 2 or x.shape[-1] != k or tuple(bias.shape) != (n,):
        raise ValueError(f"tower_linear: x {tuple(x.shape)}, weight {tuple(weight.shape)} and "
                         f"bias {tuple(bias.shape)} do not make a linear layer")
    if epilogue == "residual" and residual.shape != x.shape[:-1] + (n,):
        raise ValueError(f"tower_linear: residual {tuple(residual.shape)} is not the output's "
                         f"{tuple(x.shape[:-1]) + (n,)}")
    if epilogue == "qkv" and (x.dim() != 3 or not heads or n % (3 * heads)
                              or (n // (3 * heads)) % 2):
        raise ValueError(f"tower_linear: qkv needs x (B, S, W) and 3 x `heads` heads of an even "
                         f"width, got x {tuple(x.shape)}, N {n}, heads {heads}")
    _kernels.check_no_grad("tower_gemm", *tensors.values())


def tower_linear(x, weight, bias, epilogue="bias", residual=None, heads=None) -> torch.Tensor:
    """epilogue(x @ weight^T + bias) for fp32 x (..., K), weight (N, K) and
    bias (N,); see the module's note for the epilogues."""
    _check(x, weight, bias, epilogue, residual, heads)
    if x.device.type == "cpu":
        return tower_linear_plain(x, weight, bias, epilogue, residual, heads)
    if x.device.type != "cuda":
        raise ValueError(f"tower_linear: unsupported device {x.device}")
    n, k = weight.shape
    m = x.numel() // k
    if k % 4 or n % 8:
        raise ValueError(f"tower_linear: kernel H takes K % 4 == 0 and N % 8 == 0, got K {k}, "
                         f"N {n}")
    if x.data_ptr() % 16 or any(t.data_ptr() % 8 for t in (bias, residual) if t is not None):
        raise ValueError("tower_linear: x must be 16-byte aligned, bias and residual 8-byte")
    w_hi, w_lo = weight_parts(weight)
    if epilogue == "qkv":
        b, s, _ = x.shape
        out = torch.empty((3, b, heads, s, n // (3 * heads)), dtype=x.dtype, device=x.device)
        seq, d = s, n // (3 * heads)
    else:
        out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
        seq, heads, d = 1, 1, 2
    _kernels.launch("coda_tower_gemm", x, w_hi, w_lo, bias,
                    residual if epilogue == "residual" else None, out, m, n, k,
                    EPILOGUES[epilogue], seq, heads, d)
    return out
