"""Kernel D's arithmetic on the CPU: 3xTF32 products, the key split, the combine.

Kernel D (csrc/attention.cu) runs QK^T and PV on the tensor cores in
3xTF32 and, where its blocks would not fill the card, splits the keys into
chunks whose partial (max, sum, output) triples a second launch combines.
None of that runs here, so these tests hold its arithmetic in PyTorch:

  * a TF32 emulation of cvt.rna (round the low 13 mantissa bits to nearest,
    ties away from zero) shows that the hi/lo split keeps the products at
    the encoder's and decoder's widths within ATTN_TOL of fp64, and that a
    single TF32 pass does not;
  * `attention_splits` gives chunks that are whole key tiles, none all
    padding, covering Skv exactly;
  * `masked_attention_split_plain` (the combine written out beside the
    kernel) equals `masked_attention_plain` and the JAX package's reference,
    with all-masked rows and with dropout.

Kernel E (csrc/vit_attention.cu) runs the CLIP tower's attention in the same
3xTF32, its keys padded to a multiple of 8; the ViT case below holds that
arithmetic against fp64 and the JAX package's reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coda_neurips2023_tpu.ops import pallas_masked_attention as jattn
from coda_neurips2023_tpu.ops.pallas_vit_attention import _attention_reference as jvit_reference

from coda_neurips2023_tpu_torch.ops.masked_attention import (
    MIN_CHUNK_KEYS,
    BF16_BLOCKS_PER_SM,
    BF16_QUERY_TILE,
    QUERY_TILE,
    BLOCKS_PER_SM,
    attention_splits,
    combine_partials,
    key_tile,
    masked_attention,
    masked_attention_plain,
    masked_attention_split_plain,
)
from torch_one_thread import one_intra_op_thread  # noqa: F401

ATTN_TOL = 1e-4
VIT_ATTN_TOL = 1e-4  # chip_smoke.py's bound for kernel E


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as cvt.rna.tf32.f32: the low 13 mantissa bits rounded to
    nearest, ties away from zero (a carry moves into the exponent)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product_3x(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32: lo*hi + hi*lo + hi*hi, each product exact in fp32
    (11-bit by 11-bit significands), summed in fp32 as the MMA accumulates."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def product_1x(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def _inputs(seed, b, h, sq, skv, d):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, sq, d)) / np.sqrt(d)).astype(np.float32)
    k = rng.standard_normal((b, h, d, skv)).astype(np.float32)
    v = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    return map(torch.from_numpy, (q, k, v))


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 2 - ulp / 2, 0.0], dtype=torch.float32)
    # ties away from zero on both signs, below a tie down, a carry into the exponent
    assert tf32(x).tolist() == [one + ulp, -(one + ulp), one, one + 2 * ulp, 2.0, 0.0]
    assert (tf32(torch.randn(1000)).view(torch.int32) & 0x1FFF).eq(0).all()
    hi, lo = split(torch.tensor([np.pi], dtype=torch.float32))
    assert abs((hi + lo).double().item() - np.float32(np.pi)) <= 2.0 ** -22 * np.pi


@pytest.mark.parametrize("sq,skv,d", [(256, 2048, 64), (128, 2048, 128)],
                         ids=["encoder", "decoder"])
def test_3xtf32_products_keep_fp32_parity(sq, skv, d):
    """At the encoder's (D = 64) and the decoder's (D = 128) widths, QK^T and
    PV in 3xTF32 err from fp64 about as much as fp32 products do, far inside
    ATTN_TOL, and so does the attention they make; single-pass TF32 scores
    miss ATTN_TOL tenfold."""
    q, k, v = _inputs(d, 1, 2, sq, skv, d)
    exact = q.double() @ k.double()
    fp32_err = ((q @ k).double() - exact).abs().max().item()
    scores = product_3x(q, k)
    err3 = (scores.double() - exact).abs().max().item()
    err1 = (product_1x(q, k).double() - exact).abs().max().item()
    assert err3 <= 2 * fp32_err and err3 <= ATTN_TOL / 10
    assert err1 > 10 * ATTN_TOL
    p = torch.softmax(scores, -1)
    out = product_3x(p, v)
    assert (out.double() - p.double() @ v.double()).abs().max().item() <= ATTN_TOL / 100
    want = torch.softmax(exact, -1) @ v.double()
    assert (out.double() - want).abs().max().item() <= ATTN_TOL / 100


# an H100 SXM and an H100 PCIe
SM_COUNTS = (132, 114)


@pytest.mark.parametrize("skv", [1, 63, 64, 65, 2048, 2049])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sm_count", SM_COUNTS)
@pytest.mark.parametrize("bf16", [False, True], ids=["D", "D-bf16"])
def test_attention_splits_cover_the_keys(skv, d, sm_count, bf16):
    """Chunks are whole key tiles (kernel D's or D-bf16's), every chunk
    starts before Skv (none is all padding), and they cover Skv exactly, at
    the paths' shapes and small ones."""
    wave = (BF16_BLOCKS_PER_SM if bf16 else BLOCKS_PER_SM) * sm_count
    for b, h, sq in ((32, 4, 2048), (32, 4, 128), (8, 4, 128), (2, 3, 70), (1, 1, 1)):
        splits, chunk = attention_splits(b, h, sq, skv, d, sm_count, bf16)
        assert splits >= 1 and chunk % key_tile(d, bf16) == 0
        assert (splits - 1) * chunk < skv <= splits * chunk
        blocks = b * h * -(-sq // (BF16_QUERY_TILE if bf16 else QUERY_TILE))
        if splits > 1:  # split only where the blocks leave the card idle
            assert blocks < wave and chunk >= MIN_CHUNK_KEYS
            waves = -(-blocks * splits // wave)
            assert waves / splits < 1  # fewer waves a split than unsplit
            if bf16:  # D-bf16: the split blocks run in one wave
                assert waves == 1


@pytest.mark.parametrize("sm_count", SM_COUNTS)
def test_attention_splits_at_the_paths_shapes(sm_count):
    """At 132 SMs a wave is 264 blocks: the eval encoder's 4096 and the
    training encoder's 512 blocks fill whole waves unsplit; the eval
    decoder's 128 fill one wave twice over as 2 splits, the training
    decoder's 32 as 8 (the splits measured fastest there).  At 114 SMs (a wave of
    228) the encoders stay unsplit, and 7 splits of 304 keys fill a wave
    best for 128 blocks (896 blocks in 4 waves) and for 32 (224 in 1)."""
    want = {132: [(1, 2048), (1, 2048), (2, 1024), (8, 256)],
            114: [(1, 2048), (1, 2048), (7, 304), (7, 304)]}[sm_count]
    got = [attention_splits(32, 4, 2048, 2048, 64, sm_count),
           attention_splits(8, 4, 2048, 2048, 64, sm_count),
           attention_splits(32, 4, 128, 2048, 128, sm_count),
           attention_splits(8, 4, 128, 2048, 128, sm_count)]
    assert got == want


@pytest.mark.parametrize("sm_count", SM_COUNTS)
def test_attention_bf16_splits_at_the_paths_shapes(sm_count):
    """Kernel D-bf16 runs one block of 128 query rows an SM, keys in tiles
    of 128 (64 at D = 128): a wave is the SM count, and it splits into the
    most chunks whose blocks still fit in one wave.  The eval encoder's
    4096 blocks and the encoder's 1024 at 8 scenes run unsplit; so does the
    decoder's cross-attention at 32 scenes (128 blocks) and at 24 (96: 4
    splits measured 1.15x slower at 132 SMs).  At 16 scenes (64 blocks) it
    splits 2 ways at 132 SMs and not at 114; at 8 (32 blocks) 4 ways at 132
    SMs and 3 at 114; the decoder's shape cut to 2 scenes (8 blocks) 7 ways
    (no chunk under MIN_CHUNK_KEYS)."""
    want = {132: [(1, 2048), (1, 2048), (1, 2048), (1, 2048), (2, 1024), (4, 512), (7, 320)],
            114: [(1, 2048), (1, 2048), (1, 2048), (1, 2048), (1, 2048), (3, 704),
                  (7, 320)]}[sm_count]
    got = [attention_splits(32, 4, 2048, 2048, 64, sm_count, bf16=True),
           attention_splits(8, 4, 2048, 2048, 64, sm_count, bf16=True),
           attention_splits(32, 4, 128, 2048, 128, sm_count, bf16=True),
           attention_splits(24, 4, 128, 2048, 128, sm_count, bf16=True),
           attention_splits(16, 4, 128, 2048, 128, sm_count, bf16=True),
           attention_splits(8, 4, 128, 2048, 128, sm_count, bf16=True),
           attention_splits(2, 4, 128, 2000, 128, sm_count, bf16=True)]
    assert got == want


def _attention_args(seed, b, h, sq, skv, d, radius):
    q, k, v = _inputs(seed, b, h, sq, skv, d)
    rng = np.random.default_rng(seed + 1)
    kxyz = rng.uniform(-1, 1, (b, skv, 3)).astype(np.float32)
    qxyz = rng.uniform(-1, 1, (b, sq, 3)).astype(np.float32)
    qxyz[:, 0] = 100.0  # with radius > 0, a row with no allowed key: uniform
    qxyz, kxyz_t = torch.from_numpy(qxyz), torch.from_numpy(np.ascontiguousarray(kxyz.transpose(0, 2, 1)))
    return q, k, v, qxyz, kxyz_t, radius


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("radius", [0.0, 0.8])
@pytest.mark.parametrize("chunk", [32, 64, 96])
def test_split_combine_matches_plain_and_jax(chunk, radius, dropout):
    """The keys in chunks, each chunk's (max, sum, unnormalized output), then
    the combine: equal to the plain version within fp32 rounding (and to the
    JAX reference without dropout), all-masked rows uniform."""
    args = _attention_args(chunk, 2, 3, 40, 150, 16, radius)
    seed = torch.tensor(987654321, dtype=torch.int64)
    got = masked_attention_split_plain(*args, chunk=chunk, dropout=dropout, seed=seed)
    want = masked_attention_plain(*args, dropout=dropout, seed=seed)
    assert (got - want).abs().max().item() <= 1e-6
    if dropout == 0:
        ref = jattn._reference(*(jnp.asarray(t.numpy()) for t in args[:5]), radius, jnp.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATTN_TOL)
        if radius > 0:
            np.testing.assert_allclose(got[:, :, 0].numpy(), args[2].mean(2).numpy(), rtol=0,
                                       atol=ATTN_TOL)


def test_split_combine_at_the_kernels_own_split():
    """The decoder's cross-attention shape cut to 2 scenes, at the split the
    kernel takes there (a last chunk shorter than the rest), with dropout."""
    b, h, sq, skv, d = 2, 4, 128, 2000, 128
    splits, chunk = attention_splits(b, h, sq, skv, d, 132)
    assert splits > 1 and skv - (splits - 1) * chunk < chunk
    args = _attention_args(5, b, h, sq, skv, d, 0.0)
    seed = torch.tensor(5, dtype=torch.int64)
    got = masked_attention_split_plain(*args, chunk=chunk, dropout=0.1, seed=seed)
    assert (got - masked_attention(*args, dropout=0.1, seed=seed)).abs().max().item() <= 1e-6


def test_combine_partials_weights_chunks_by_their_max():
    """Two chunks, one whose every key was radius-masked (max finfo.min):
    its weight underflows to 0 and the other chunk's output stands."""
    fmin = torch.finfo(torch.float32).min
    m = torch.tensor([[fmin], [2.0]])
    l = torch.tensor([[3.0], [1.5]])
    o = torch.tensor([[[9.0, 9.0]], [[3.0, -1.5]]])
    assert combine_partials(m, l, o).tolist() == [[2.0, -1.0]]
    # both chunks fully masked: uniform over all keys (l counts them)
    m = torch.tensor([[fmin], [fmin]])
    want = torch.tensor([[12.0, 7.5]]) / 4.5
    assert torch.allclose(combine_partials(m, l, o), want, rtol=1e-6, atol=0)


def vit_attention_3x(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel E's arithmetic: q times 1/sqrt(D) (1/8 at D = 64, exact) before
    the split, K and V padded with zero rows to a multiple of 8 keys, QK^T
    in 3xTF32, the padded keys' scores at -inf before the softmax, PV in
    3xTF32."""
    s, d = q.shape[-2:]
    pad = -(-s // 8) * 8 - s
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    scores = product_3x(q * (1.0 / d ** 0.5), kp.transpose(-1, -2).contiguous())
    assert scores.shape[-1] == s + pad and not scores[..., s:].any()
    scores[..., s:] = -torch.inf
    p = torch.softmax(scores, -1)
    assert not p[..., s:].any()  # a padded key takes no weight
    return product_3x(p, vp)


def test_3xtf32_vit_attention_keeps_fp32_parity():
    """ViT-B/16's attention, S = 197 (keys padded to 200), D = 64, 12 heads:
    kernel E's 3xTF32 arithmetic lies within VIT_ATTN_TOL of fp64 and of the
    JAX package's reference, about as close as fp32 products come; a single
    TF32 pass does not."""
    rng = np.random.default_rng(197)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 12, 197, 64)).astype(np.float32))
               for _ in range(3))
    got = vit_attention_3x(q, k, v)
    scores = (q.double() @ k.double().transpose(-1, -2)) / 8.0
    exact = torch.softmax(scores, -1) @ v.double()
    err = (got.double() - exact).abs().max().item()
    fp32_err = ((torch.softmax((q @ k.transpose(-1, -2)) / 8.0, -1) @ v).double()
                - exact).abs().max().item()
    assert err <= VIT_ATTN_TOL / 10 and err <= 4 * fp32_err
    ref = jvit_reference(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=VIT_ATTN_TOL)
    one_pass = torch.softmax(product_1x(q / 8.0, k.transpose(-1, -2).contiguous()), -1)
    assert ((one_pass.double() @ v.double()) - exact).abs().max().item() > VIT_ATTN_TOL
