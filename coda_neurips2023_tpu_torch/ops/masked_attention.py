"""Softmax attention, optionally radius-masked (PyTorch + kernel D).

Counterpart of coda_neurips2023_tpu/ops/pallas_masked_attention.py.  The
layouts and argument order are the JAX package's: q (B, H, Sq, D) already
scaled by 1/sqrt(D), k (B, H, D, Skv), v (B, H, Skv, D), qxyz (B, Sq, 3),
kxyz_t (B, 3, Skv).  With radius > 0 a key is allowed where
sqrt(max(|q|^2 + |k|^2 - 2 q.k, 0)) < radius, the radius being already
squared by the caller (a reference quirk kept verbatim); disallowed scores
are set to finfo(f32).min before the softmax.  With radius <= 0 the
coordinates are ignored and may be None.

`compute_dtype` is the JAX signature's last argument: the operand type of
the two products.  The port's default is "float32" (the JAX package's is
"bfloat16"): the fp32 detector runs kernel D at fp32 accuracy, which is the
JAX package's own numerics off the TPU, where it takes the Pallas kernel
only on a TPU backend (models/transformer.py:47-57) and flax's fp32
attention elsewhere.  With "bfloat16" the numerics are the JAX kernel's
(_reference): q, k and v rounded to bf16 (fp32 inputs are cast before the
launch, as the TPU kernel casts them inside), fp32 sums of bf16 products,
the mask from the fp32 coordinates, an fp32 softmax, p = e / sum e rounded
to bf16, an fp32-summed PV product and the output in q's dtype.  bf16
inputs need compute_dtype "bfloat16".

On a CUDA tensor `masked_attention` launches kernel D (csrc/attention.cu)
or, in bf16, kernel D-bf16 (csrc/attention_bf16.cuh); on a CPU tensor it
takes `masked_attention_plain`.  Kernel D runs its two products on the
tensor cores in 3xTF32 (each operand split into two TF32 parts, three
products summed in fp32), about 22 of fp32's 24 bits, on mma.sync; D-bf16
on wgmma, its tiles loaded by TMA (one block of 128 query rows an SM, keys
in tiles of 128, 64 at D = 128).  D-bf16's TMA copies read rows of a
multiple of 16 bytes: where Skv is not a multiple of 8 the wrapper pads
K^T's and the key coordinates' rows with zeros (keys the kernel never
counts).

Where (B*H) x ceil(Sq / query tile) blocks would leave the card idle (the
decoder's cross-attention under kernel D), `attention_splits` cuts the keys
into chunks, one a block, and a second launch combines the chunks' partial
(max, sum, output) triples; it takes each kernel's own query and key tiles
and blocks an SM.  `masked_attention_split_plain` is that scheme written
out in PyTorch, the reference for the combine.  In bf16 each chunk rounds p
normalized by its own sum and hands the combine its fp32 output times that
sum; the combine casts once to the output dtype.

In training, `dropout` > 0 drops attention weights as flax's
MultiHeadDotProductAttention does by default (broadcast_dropout): one keep
mask over (query, key) shared by every batch row and head, the softmax
normalized before the drop.  The mask comes from a counter-based hash of
(i * Skv + j) and `seed`, a 0-d int64 tensor on the inputs' device (drawn
from a generator without a host sync); kernels D and D-bf16 and
`masked_attention_plain` form the same mask.  In fp32 the kept weights are
scaled by 1 / (1 - dropout).  In bf16 the order is flax's bf16 one
(dot_product_attention_weights at dtype bf16): p, normalized and rounded to
bf16, is multiplied where kept by flax's multiplier bf16(1) / bf16(1 -
dropout) (`bf16_dropout_multiplier`: 1.109375 at 0.1, not 1 / 0.9) and the
product rounded to bf16.  Flax also rounds the scores and the softmax to
bf16, which kernel D-bf16 (the JAX Pallas kernel's numerics) does not, and
draws its mask from its own generator: the two differ there by design.

`MaskedAttention` is the autograd Function around them, in fp32 and in
bf16, with the JAX package's backward design (pallas_masked_attention.py:
182-200): recompute the forward through `masked_attention_plain` at the
same compute dtype, with the same mask, and pull dq, dk and dv back through
it with autograd.  The coordinates take no gradient.  The backward is plain
PyTorch on both devices; a hand-written backward kernel is later, measured
work.
"""

from __future__ import annotations

import torch

from coda_neurips2023_tpu_torch import _kernels
from coda_neurips2023_tpu_torch.utils.device import multi_processor_count

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_M32 = 0xFFFFFFFF
# blocks of kernel D resident on one SM at once (two of ~110 KB of shared
# memory); the card holds this many times its SM count.  Kernel D-bf16 runs
# one block of ~150-200 KB an SM.
BLOCKS_PER_SM = 2
BF16_BLOCKS_PER_SM = 1
# a chunk spans at least this many keys: below it the blocks' fixed cost
# (the query tile's load, the partials' store and combine) outweighs the
# parallelism gained
MIN_CHUNK_KEYS = 256
QUERY_TILE = 128  # query rows a block of kernel D (csrc/attention.cu Cfg::TQ)
# query rows a block of kernel D-bf16: two consumer warpgroups of 64 rows
# (csrc/attention_bf16.cuh Cfg::TQ)
BF16_QUERY_TILE = 128


def key_tile(d: int, bf16: bool = False) -> int:
    """Keys a tile of kernel D (csrc/attention.cu Cfg::TK) or, with `bf16`,
    of kernel D-bf16 (csrc/attention_bf16.cuh Cfg::TK) at head width d."""
    if bf16:
        return 128 if d <= 64 else 64
    return 32 if d <= 64 else 16


def attention_splits(b: int, h: int, sq: int, skv: int, d: int, sm_count: int,
                     bf16: bool = False):
    """(splits, chunk): kernel D (with `bf16`, kernel D-bf16) cuts the Skv
    keys into `splits` chunks of `chunk` keys (a whole number of its key
    tiles, at least MIN_CHUNK_KEYS), one chunk a block, where the (B*H) x
    ceil(Sq / query tile) blocks are fewer than the resident blocks a SM x
    sm_count (a wave) and so leave the card idle.  Kernel D: a block's time
    falls as 1/splits while the card runs ceil(blocks * splits / wave) waves
    of them, so the fewest splits that minimise waves / splits (a split that
    fills waves badly, 3 at 128 blocks on 132 SMs, measured slower than 2 or
    4).  Kernel D-bf16: the most splits whose blocks still run in one wave
    (on an H100 SXM at the decoder's 128 x 2048 keys, D = 128, measured on
    the card's clock: 32 blocks 2.2x faster as 4 splits, 64 blocks 1.19x as
    2; 96 blocks 1.15x slower as 4 splits, in three waves).  Every chunk
    holds at least one key (the combine of an all-padding chunk would divide
    0 by 0) and the chunks cover the keys exactly."""
    tk = key_tile(d, bf16)
    tiles = -(-skv // tk)
    blocks = b * h * -(-sq // (BF16_QUERY_TILE if bf16 else QUERY_TILE))
    wave = (BF16_BLOCKS_PER_SM if bf16 else BLOCKS_PER_SM) * sm_count
    most = 1 if blocks >= wave else max(1, min(tiles, skv // MIN_CHUNK_KEYS))
    if bf16:
        want = max(1, min(most, wave // blocks))
    else:
        want = min(range(1, most + 1), key=lambda s: -(-blocks * s // wave) / s)
    per = -(-tiles // want)  # tiles a chunk
    return -(-tiles // per), per * tk


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


def combine_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Merge per-chunk softmax partials (kernel D's combine): m, l (S, ...,
    Sq) the chunks' running max and sum, o (S, ..., Sq, D) their unnormalized
    outputs -> sum_s o_s e^(m_s - M) / sum_s l_s e^(m_s - M), M = max_s m_s."""
    w = torch.exp(m - m.amax(0))
    return (o * w[..., None]).sum(0) / (l * w).sum(0)[..., None]


def masked_attention_split_plain(q, k, v, qxyz, kxyz_t, radius: float, chunk: int,
                                 compute_dtype="float32", dropout: float = 0.0,
                                 seed=None) -> torch.Tensor:
    """`masked_attention_plain` by kernel D's split-key scheme: the keys in
    chunks of `chunk`, each chunk's (max, sum, unnormalized output), then
    `combine_partials`.  The sum takes the weights before the drop.  In
    bf16 (kernel D-bf16's scheme) a chunk's p is normalized by its own sum,
    rounded to bf16 and dropped, and its output, an fp32 sum, is multiplied
    by that sum again for the combine."""
    bf16 = _compute_dtype(compute_dtype) == torch.bfloat16
    if bf16:
        scores = _bf16_scores(q, k, qxyz, kxyz_t, radius)
        v = v.to(torch.bfloat16).float()
    else:
        scores = _scores(q, k, qxyz, kxyz_t, radius)
    sq, skv = scores.shape[-2:]
    keep = attention_keep_mask(seed, sq, skv, dropout) if dropout > 0 else None
    scale = dropout_constants(dropout)[1] if dropout > 0 else 1.0
    parts = []
    for c0 in range(0, skv, chunk):
        s = scores[..., c0:c0 + chunk]
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        l = p.sum(-1)
        if bf16:
            p = (p / l[..., None]).to(torch.bfloat16)
            if keep is not None:
                p = bf16_drop(p, keep[:, c0:c0 + chunk], dropout)
            p = p.float()
            parts.append((m, l, torch.matmul(p, v[..., c0:c0 + chunk, :]) * l[..., None]))
            continue
        if keep is not None:
            p = torch.where(keep[:, c0:c0 + chunk], p * scale, torch.zeros((), dtype=p.dtype,
                                                                           device=p.device))
        parts.append((m, l, torch.matmul(p, v[..., c0:c0 + chunk, :])))
    m, l, o = (torch.stack(x) for x in zip(*parts))
    return combine_partials(m, l, o).to(q.dtype)


def _check(q, k, v, qxyz, kxyz_t, radius, dropout, seed) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dim() != 4:
            raise ValueError(f"{name}: expected float32 or bfloat16 4-D, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype} differ")
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
                     compute_dtype="float32", dropout: float = 0.0, seed=None) -> torch.Tensor:
    """Radius-masked (radius > 0) or plain (radius <= 0) softmax attention
    with `compute_dtype` operands, the attention weights dropped at rate
    `dropout` -> (B, H, Sq, D) in q's dtype."""
    radius, dropout = float(radius), float(dropout)
    bf16 = _compute_dtype(compute_dtype) == torch.bfloat16
    _check(q, k, v, qxyz, kxyz_t, radius, dropout, seed)
    if q.dtype == torch.bfloat16 and not bf16:
        raise ValueError("bf16 inputs need compute_dtype='bfloat16'")
    if q.device.type == "cuda":
        d = q.shape[-1]
        if d not in KERNEL_HEAD_DIMS:
            raise ValueError(f"masked_attention: head width {d} not in {KERNEL_HEAD_DIMS}")
        coords = (qxyz, kxyz_t) if radius > 0 else ()
        if not all(t.is_contiguous() for t in (q, k, v, *coords)):
            raise ValueError("masked_attention: inputs must be contiguous")
    elif q.device.type != "cpu":
        raise ValueError(f"masked_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return MaskedAttention.apply(q, k, v, qxyz, kxyz_t, radius, dropout, seed, bf16)
    return _attention_forward(q, k, v, qxyz, kxyz_t, radius, dropout, seed, bf16)


def _attention_kernel(q, k, v, qxyz, kxyz_t, radius: float, dropout: float = 0.0, seed=None,
                      bf16: bool = False) -> torch.Tensor:
    """Kernel D, or with `bf16` kernel D-bf16 on q, k and v rounded to bf16;
    the output in q's dtype."""
    b, h, sq, d = q.shape
    skv = v.shape[2]
    out = torch.empty_like(q)
    qx, kx = (qxyz, kxyz_t) if radius > 0 else (None, None)
    splits, chunk = attention_splits(b, h, sq, skv, d, multi_processor_count(q.device), bf16)
    o_part = ml_part = None
    if splits > 1:  # scratch for the chunks' partials, merged by the combine
        o_part = torch.empty((splits, b, h, sq, d), dtype=torch.float32, device=q.device)
        ml_part = torch.empty((splits, b, h, sq, 2), dtype=torch.float32, device=q.device)
    out_bf16 = int(q.dtype == torch.bfloat16)
    seed = seed if dropout > 0 else None
    if bf16:
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))  # no copy where already bf16
        # the TMA copies read rows of 16-byte multiples at 16-byte aligned
        # addresses: K^T's and the key coordinates' rows padded to ldk keys
        ldk = -(-skv // 8) * 8
        if ldk != skv:
            k = torch.nn.functional.pad(k, (0, ldk - skv))
            kx = None if kx is None else torch.nn.functional.pad(kx, (0, ldk - skv))
        q, k, v, kx = (t if t is None or t.data_ptr() % 16 == 0 else t.clone()
                       for t in (q, k, v, kx))
        threshold = dropout_constants(dropout)[0] if dropout > 0 else 0
        mult = bf16_dropout_multiplier(dropout) if dropout > 0 else 0.0
        _kernels.launch("coda_attention_bf16", q, k, v, qx, kx, seed, out, o_part, ml_part, b, h,
                        sq, skv, ldk, d, radius, threshold, mult, out_bf16, splits, chunk)
    else:
        threshold, scale = dropout_constants(dropout) if dropout > 0 else (0, 0.0)
        _kernels.launch("coda_attention", q, k, v, qx, kx, out, o_part, ml_part, b, h, sq, skv,
                        d, radius, seed, threshold, scale, splits, chunk)
    if splits > 1:
        _kernels.launch("coda_attention_combine", o_part, ml_part, out, b, h, sq, d, splits,
                        out_bf16, count_as="attention_bf16" if bf16 else "attention")
    return out


def _attention_forward(q, k, v, qxyz, kxyz_t, radius: float, dropout: float, seed, bf16: bool):
    """Kernel D (with `bf16`, D-bf16) on a CUDA tensor, `masked_attention_plain`
    on a CPU one."""
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, qxyz, kxyz_t, radius,
                                      "bfloat16" if bf16 else "float32", dropout, seed)
    return _attention_kernel(q, k, v, qxyz, kxyz_t, radius, dropout, seed, bf16)


class MaskedAttention(torch.autograd.Function):
    """Forward: `_attention_forward`.  Backward: autograd of
    `masked_attention_plain` at the same compute dtype, recomputed.
    `masked_attention` takes it where q, k or v needs a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, qxyz, kxyz_t, radius, dropout=0.0, seed=None, bf16=False):
        ctx.save_for_backward(q, k, v, qxyz, kxyz_t, seed)
        ctx.radius, ctx.dropout = radius, dropout
        ctx.compute_dtype = "bfloat16" if bf16 else "float32"
        return _attention_forward(q, k, v, qxyz, kxyz_t, radius, dropout, seed, bf16)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, qxyz, kxyz_t, seed = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip((q, k, v), ctx.needs_input_grad[:3])]
            out = masked_attention_plain(*leaves, qxyz, kxyz_t, ctx.radius, ctx.compute_dtype,
                                         ctx.dropout, seed)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad) if wanted else ())
        return (*(next(grads) if t.requires_grad else None for t in leaves),
                None, None, None, None, None, None)
