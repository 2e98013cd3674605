"""The yardstick's arithmetic: the H100's peaks, the model FLOPs of the
detector and of CLIP's image tower from a configuration's widths, and the
operations and bytes of the attention ops whose roofline share the
benchmark reports.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): 495 TFLOP/s
TF32 on the tensor cores, the most any path with fp32 operands can reach,
so no fp32-accurate implementation can read over 100% against it; HBM3 at
3.35 TB/s.

Model FLOPs count the multiply-adds (2 FLOPs each) of every matrix product
and attention product of a forward, from the shapes alone: recomputed work
and the elementwise rest are not counted, so the count is a floor of the
work and the share it gives can only read low.  A training step counts its
detector three times its forward (the backward's two products a forward
one); CLIP is frozen, so its tower counts its forward alone.
"""

from __future__ import annotations

PEAK_FLOPS = 495e12  # TF32 dense
PEAK_BYTES = 3.35e12  # HBM3


def _mlp(rows: int, dims) -> int:
    """FLOPs of a stack of dense layers dims[0] -> dims[1] -> ... over `rows` rows."""
    return 2 * rows * sum(a * b for a, b in zip(dims, dims[1:]))


def _attention_block(sq: int, skv: int, d: int, proj_kv: bool = True) -> int:
    """Q, K, V and output projections and the QK and PV products of one
    multi-head attention of width d (heads split d), Sq queries over Skv keys."""
    q = 2 * sq * d * d
    kv = 2 * skv * d * 2 * d if proj_kv else 0
    out = 2 * sq * d * d
    return q + kv + out + 4 * sq * skv * d


def detector_forward(w: dict) -> int:
    """Model FLOPs of one scene's forward through the 3DETR trunk and heads.
    `w`: preenc_npoints, nsample, enc_dim, enc_nlayers, enc_ffn_dim,
    dec_dim, dec_nlayers, dec_ffn_dim, nqueries, heads (the output widths of
    the MLP heads, applied to every decoder layer), in_channels (3, or 6
    with colour)."""
    m, k = w["preenc_npoints"], w["nsample"]
    enc, dec, nq = w["enc_dim"], w["dec_dim"], w["nqueries"]
    pre = _mlp(m * k, (w["in_channels"], 64, 128, enc))
    enc_layer = _attention_block(m, m, enc) + _mlp(m, (enc, w["enc_ffn_dim"], enc))
    proj = _mlp(m, (enc, 512, 512, dec))
    query = _mlp(nq, (dec, dec, dec))
    dec_layer = (_attention_block(nq, nq, dec) + _attention_block(nq, m, dec)
                 + _mlp(nq, (dec, w["dec_ffn_dim"], dec)))
    heads = w["dec_nlayers"] * sum(_mlp(nq, (dec, dec, dec, h)) for h in w["heads"])
    return (pre + w["enc_nlayers"] * enc_layer + proj + query
            + w["dec_nlayers"] * dec_layer + heads)


def tower_forward(w: dict) -> int:
    """Model FLOPs of one crop through CLIP's image tower: patch embedding,
    `layers` pre-LN blocks of width `width` with a 4x MLP over
    (resolution / patch)^2 + 1 tokens, and the output projection."""
    p = (w["resolution"] // w["patch"]) ** 2
    s, d = p + 1, w["width"]
    block = _attention_block(s, s, d) + _mlp(s, (d, 4 * d, d))
    return 2 * p * 3 * w["patch"] ** 2 * d + w["layers"] * block + 2 * d * w["embed_dim"]


def step_flops(w: dict, scenes: int, crops: int, train: bool) -> int:
    """Model FLOPs of a step over `scenes` scenes and `crops` crops."""
    det = detector_forward(w["detector"]) * scenes
    return (3 * det if train else det) + tower_forward(w["clip"]) * crops


def attention_cost(b: int, h: int, sq: int, skv: int, d: int, itemsize: int = 4):
    """(FLOPs, bytes) an attention op needs: QK and PV products; q, k, v read
    once and the output written once."""
    flops = 4 * b * h * sq * skv * d
    nbytes = itemsize * b * h * (2 * sq * d + 2 * skv * d)
    return flops, nbytes


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip can take: the larger of the operations' time at
    the TF32 peak and the bytes' time at HBM's."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
