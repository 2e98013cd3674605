"""The PyTorch port's bf16 paths against the JAX package on the CPU: the plain
bf16 versions of kernels D and E, the bf16 CLIP towers, the bf16 detector at
eval, and the flags through `main`.

Inputs are made from seeds with numpy.  The JAX side runs its Pallas
kernels, as its own tests do on the CPU: masked_attention and vit_attention
in interpret mode, reached through the fused paths its modules take on a TPU
(`transformer._FUSED_MASKED_ATTN = "1"`, `clip._FUSED_ATTN = "1"` with
CODA_VIT_ATTN_IMPL=pallas), set from here.  Tolerances, each with its
reason:

  * kernels D and E in bf16 (`within_one_ulp`): each element within one
    bf16 ulp of the larger magnitude of its row (the larger of the two
    rows' largest |value|).  Both sides sum the products in fp32 in their
    own orders and take their own exp, so a p that lies at a bf16 rounding
    boundary may round the other way; that moves every output of its row by
    up to 2^-9 p |v|, a share of the row's scale and not of the element's,
    which may be small by cancellation (measured: 10 of 75,648 elements of
    E's (3, 4, 197, 32) case exceed one ulp of their own magnitude, all
    within one ulp of their row's);
  * D's split keys against the unsplit version in bf16 (`split_bound`):
    each chunk rounds p normalized by its own sum, the unsplit version by
    the row's, so each p carries a different rounding error of up to half
    a bf16 ulp, at most 2^-8 of itself, on each side: the outputs may
    differ by 2^-7 sum_j p_j |v_j| before their rounding to bf16, which
    adds one ulp of the row's largest magnitude;
  * the bf16 towers: cosine >= 0.999 and the normalized features within 2e-2
    (two layers of bf16 rounding at different places: flax rounds under
    XLA's excess-precision rules, PyTorch after every op);
  * the bf16 detector: integer outputs (FPS and ball-query indices,
    `enc_inds`) equal, floats within 3e-2 of each output's largest
    magnitude (where an angle class differs the angle, which jumps by a
    bin, is compared only on the rows whose classes agree), and
    `sem_cls_logits` within 6e-2 of its.  Given the same inputs the
    pre-encoder, decoder and heads agree with JAX's to fp32 rounding; the
    encoder's attention rounds its fp32 PV sums (summed in another order
    than XLA's) to bf16, so about 4e-4 of its outputs land on the
    neighbouring bf16 value, each moves its row's LayerNorm, and 1.2% of
    the encoder's outputs differ by a bf16 ulp.  The heads see that as
    input noise of ~0.4%; the sem head's logits, whose largest magnitude
    (0.22) is small against the activations that feed them, differ by
    5.45% of it, as far as the port's fp32 model is from JAX's bf16 one
    (4.8%), and as far as JAX's own bf16 model is from itself under XLA's
    default excess precision, which keeps fused intermediates in fp32
    (4.1%, against the model run eagerly; the reference here is compiled
    without it, so each op rounds its output as PyTorch does); the other
    outputs by 0.4-1% (all measured on these weights).
"""

import math
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coda_neurips2023_tpu.datasets.config import SunrgbdAnonymousConfig as JaxConfig
from coda_neurips2023_tpu.models import clip as jclip
from coda_neurips2023_tpu.models import model_3detr as jmodel
from coda_neurips2023_tpu.models import transformer as jtransformer
from coda_neurips2023_tpu.ops import pallas_masked_attention as pma
from coda_neurips2023_tpu.ops import pallas_vit_attention as pva

from coda_neurips2023_tpu_torch import main as tmain
from coda_neurips2023_tpu_torch import stages
from coda_neurips2023_tpu_torch.criterion import build_criterion
from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
from coda_neurips2023_tpu_torch.models import clip as tclip
from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
from coda_neurips2023_tpu_torch.ops.masked_attention import (
    _bf16_scores,
    attention_splits,
    masked_attention,
    masked_attention_plain,
    masked_attention_split_plain,
)
from coda_neurips2023_tpu_torch.ops.vit_attention import vit_attention, vit_attention_plain
from coda_neurips2023_tpu_torch.optimizer import build_optimizer
from coda_neurips2023_tpu_torch.stages import StageContext
from coda_neurips2023_tpu_torch.utils.weights import clip_state_dict_from_flax, to_torch

from test_torch_port_clip import _perturb_clip
from test_torch_port_model import NO_LAYER_AXIS, _assert_no_boundary_flip, _batch
from test_torch_port_model import TINY, _build
from torch_one_thread import one_intra_op_thread  # noqa: F401

BF16 = torch.bfloat16
TOWER_COS = 0.999
TOWER_TOL = 2e-2
DETECTOR_TOL = 3e-2
SEM_LOGITS_TOL = 6e-2  # see the module docstring
# the JAX fused gates: the encoder's needs S >= 1024 (a multiple of 128), the
# decoder's nqueries % 128 == 0
BF16_DETECTOR = dict(enc_dim=64, dec_dim=64, enc_nlayers=1, dec_nlayers=1, enc_ffn_dim=32,
                     dec_ffn_dim=32, preenc_npoints=1024, nqueries=128)
# a scene on which the JAX CPU ball query (|a|^2 + |b|^2 - 2ab) picks what
# the port's direct differences pick (`_assert_no_boundary_flip`): at 2048
# points 4 of 65,536 indices sit within rounding of the radius
BF16_POINTS = 4096
BF16_CLIP = dict(embed_dim=32, image_resolution=32, vision_patch_size=8, vision_width=64,
                 vision_layers=2, text_width=64, text_layers=2, text_heads=2,
                 context_length=16, vocab_size=4096)


def _ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits); 0 at 0."""
    mag = np.abs(x.astype(np.float64))
    exp = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    return np.where(mag > 0, 2.0 ** (exp - 7), 0.0)


def within_one_ulp(got, want, what):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    bound = _ulp(np.maximum(np.abs(got), np.abs(want)).max(-1, keepdims=True))
    bad = err > bound
    print(f"{what}: {np.mean(got == want):.4f} of {got.size} elements bit-equal, "
          f"max_abs_err {err.max():.3e}")
    assert not bad.any(), (what, int(bad.sum()), err[bad].max())


def _jnp_bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _t_bf16(a):
    return torch.from_numpy(a).to(BF16)


# ------------------------------------------------------------- kernel E, bf16


@pytest.mark.parametrize("shape", [(3, 4, 197, 32), (2, 12, 197, 64)])
def test_vit_attention_plain_bf16_matches_pallas_interpret(monkeypatch, shape):
    rng = np.random.default_rng(sum(shape))
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    monkeypatch.setattr(pva, "_INTERPRET", True)
    want = pva.vit_attention(*map(_jnp_bf16, (q, k, v)))
    assert want.dtype == jnp.bfloat16
    got = vit_attention_plain(*map(_t_bf16, (q, k, v)))
    assert got.dtype == BF16
    within_one_ulp(got, np.asarray(want.astype(jnp.float32)), f"E-bf16 plain {shape}")
    # on the CPU the wrapper takes the plain version
    assert torch.equal(vit_attention(*map(_t_bf16, (q, k, v))), got)


# ------------------------------------------------------------- kernel D, bf16


def _d_inputs(seed, b, h, sq, skv, d):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, sq, d)) / math.sqrt(d)).astype(np.float32)
    k = rng.standard_normal((b, h, d, skv)).astype(np.float32)
    v = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    kxyz = rng.uniform(-1, 1, (b, skv, 3)).astype(np.float32)
    qxyz = rng.uniform(-1, 1, (b, sq, 3)).astype(np.float32)
    qxyz[:, 0] = 100.0  # with radius > 0, a row with no allowed key: uniform
    return q, k, v, qxyz, np.ascontiguousarray(kxyz.transpose(0, 2, 1))


D_SHAPES = [(2, 2, 256, 256, 16, 0.0), (2, 2, 256, 256, 16, 0.6), (1, 2, 128, 384, 32, 0.0)]


@pytest.mark.parametrize("b,h,sq,skv,d,radius", D_SHAPES, ids=["self", "radius", "cross"])
def test_masked_attention_plain_bf16_matches_pallas_interpret(monkeypatch, b, h, sq, skv, d,
                                                              radius):
    """bf16 inputs (a bf16 output) and fp32 inputs cast inside (an fp32
    output, as the JAX kernel writes q's dtype)."""
    q, k, v, qxyz, kxyz_t = _d_inputs(sq + skv + d, b, h, sq, skv, d)
    monkeypatch.setattr(pma, "_INTERPRET", True)
    jx = jnp.asarray(qxyz), jnp.asarray(kxyz_t)
    tx = torch.from_numpy(qxyz), torch.from_numpy(kxyz_t)
    want = pma.masked_attention(*map(_jnp_bf16, (q, k, v)), *jx, radius, "bfloat16")
    assert want.dtype == jnp.bfloat16
    got = masked_attention_plain(*map(_t_bf16, (q, k, v)), *tx, radius, "bfloat16")
    assert got.dtype == BF16
    within_one_ulp(got, np.asarray(want.astype(jnp.float32)), f"D-bf16 plain r={radius}")
    assert torch.equal(masked_attention(*map(_t_bf16, (q, k, v)), *tx, radius, "bfloat16"), got)
    want32 = pma.masked_attention(*map(jnp.asarray, (q, k, v)), *jx, radius, "bfloat16")
    got32 = masked_attention(*map(torch.from_numpy, (q, k, v)), *tx, radius, "bfloat16")
    assert want32.dtype == jnp.float32 and got32.dtype == torch.float32
    within_one_ulp(got32, np.asarray(want32), f"D-bf16 plain, fp32 inputs r={radius}")
    if radius > 0:  # the row with no allowed key: uniform over v's bf16 values
        uniform = _t_bf16(v).float().mean(2)
        np.testing.assert_allclose(got32[:, :, 0].numpy(), uniform.numpy(), rtol=0, atol=1e-2)


def split_bound(q, k, v, qxyz, kxyz_t, radius, want):
    """2^-7 sum_j p_j |v_j| (fp32 softmax of the bf16 scores) plus one bf16
    ulp of the row's largest |want|."""
    p = torch.softmax(_bf16_scores(q, k, qxyz, kxyz_t, radius), dim=-1)
    row = torch.from_numpy(_ulp(want.float().abs().amax(-1, keepdim=True).numpy())).float()
    return 2.0 ** -7 * torch.matmul(p, v.float().abs()) + row


@pytest.mark.parametrize("chunk", [64, 96, 160])
@pytest.mark.parametrize("radius", [0.0, 0.6])
def test_split_combine_bf16_matches_unsplit(chunk, radius):
    """Kernel D-bf16's split scheme in PyTorch against the unsplit version:
    each chunk's p normalized by its own sum and rounded, the combine in
    fp32, one rounding to bf16 at the end."""
    q, k, v, qxyz, kxyz_t = _d_inputs(chunk, 2, 3, 40, 300, 16)
    args = (*map(_t_bf16, (q, k, v)), torch.from_numpy(qxyz), torch.from_numpy(kxyz_t), radius)
    got = masked_attention_split_plain(*args, chunk=chunk, compute_dtype="bfloat16")
    want = masked_attention_plain(*args, "bfloat16")
    assert got.dtype == want.dtype == BF16
    err = (got.float() - want.float()).abs()
    print(f"split {chunk} r={radius}: {(got == want).float().mean().item():.4f} bit-equal, "
          f"max_abs_err {err.max().item():.3e}")
    assert (err <= split_bound(*args, want)).all()


@pytest.mark.parametrize("sm_count", [132, 114])
def test_split_at_the_kernels_own_split_in_bf16(monkeypatch, sm_count):
    """The decoder's cross-attention shape cut to 2 scenes, at the split
    kernel D-bf16 takes there on an H100 SXM and PCIe (7 chunks of 320 keys,
    a last chunk shorter than the rest), against the unsplit version
    (`split_bound`), which is held against the Pallas kernel in interpret
    mode on the same inputs (`within_one_ulp`)."""
    b, h, sq, skv, d = 2, 4, 128, 2000, 128
    splits, chunk = attention_splits(b, h, sq, skv, d, sm_count, bf16=True)
    assert splits > 1 and skv - (splits - 1) * chunk < chunk
    q, k, v, qxyz, kxyz_t = _d_inputs(11, b, h, sq, skv, d)
    args = (*map(_t_bf16, (q, k, v)), None, None, 0.0)
    got = masked_attention_split_plain(*args, chunk=chunk, compute_dtype="bfloat16")
    want = masked_attention_plain(*args, "bfloat16")
    assert ((got.float() - want.float()).abs() <= split_bound(*args, want)).all()
    monkeypatch.setattr(pma, "_INTERPRET", True)
    pallas = pma.masked_attention(*map(_jnp_bf16, (q, k, v)), jnp.asarray(qxyz),
                                  jnp.asarray(kxyz_t), 0.0, "bfloat16")
    within_one_ulp(want, np.asarray(pallas.astype(jnp.float32)), "D-bf16 plain, decoder shape")


def test_combine_partials_weights_chunks_by_their_max_bf16():
    """bf16 split keys where one chunk of a row is all radius-masked (its
    max finfo(f32).min): its weight underflows to 0 and the row is the other
    chunk's attention; a row with no allowed key anywhere comes out uniform."""
    b, h, sq, skv, d = 1, 1, 3, 8, 8
    rng = np.random.default_rng(4)
    q = _t_bf16(rng.standard_normal((b, h, sq, d)).astype(np.float32))
    k = _t_bf16(rng.standard_normal((b, h, d, skv)).astype(np.float32))
    v = _t_bf16(rng.standard_normal((b, h, skv, d)).astype(np.float32))
    kxyz = np.zeros((b, skv, 3), np.float32)
    kxyz[0, :4, 0] = 10.0  # the first chunk's keys are far from every query
    qxyz = np.zeros((b, sq, 3), np.float32)
    qxyz[0, 2] = 50.0  # the last query is far from every key
    args = (q, k, v, torch.from_numpy(qxyz), torch.from_numpy(kxyz.transpose(0, 2, 1).copy()), 1.0)
    got = masked_attention_split_plain(*args, chunk=4, compute_dtype="bfloat16")
    near = masked_attention_plain(q, k[..., 4:], v[..., 4:, :], None, None, 0.0, "bfloat16")
    assert torch.equal(got[:, :, :2], near[:, :, :2])
    np.testing.assert_allclose(got[0, 0, 2].float().numpy(), v[0, 0].float().mean(0).numpy(),
                               rtol=0, atol=1e-2)
    assert torch.equal(got, masked_attention_plain(*args, "bfloat16"))


def test_bf16_attention_refuses_training():
    """The bf16 attention refused a gradient and attention-weight dropout
    until the bf16 detector's training was ported; it now takes both (its
    backward and the dropout's order: tests/test_torch_port_bf16_train.py).
    bf16 inputs still need compute_dtype bfloat16."""
    q = torch.randn(1, 2, 16, 8, requires_grad=True)
    k, v = torch.randn(1, 2, 8, 16), torch.randn(1, 2, 16, 8)
    masked_attention(q, k, v, compute_dtype="bfloat16").sum().backward()
    assert q.grad.dtype == torch.float32 and torch.isfinite(q.grad).all() and q.grad.abs().sum() > 0
    seed = torch.tensor(1)
    got = masked_attention(q.detach(), k, v, compute_dtype="bfloat16", dropout=0.1, seed=seed)
    assert torch.equal(got, masked_attention_plain(q.detach(), k, v, None, None, 0.0, "bfloat16",
                                                   0.1, seed))
    assert not torch.equal(got, masked_attention(q.detach(), k, v, compute_dtype="bfloat16"))
    with pytest.raises(ValueError, match="compute_dtype"):
        masked_attention(*(t.detach().to(BF16) for t in (q, k, v)))


# --------------------------------------------------------------- bf16 towers


@pytest.fixture(scope="module")
def bf16_towers():
    jm32 = jclip.CLIP(**BF16_CLIP)
    res = BF16_CLIP["image_resolution"]
    toks0 = jnp.zeros((1, BF16_CLIP["context_length"]), jnp.int32)
    init = jax.jit(lambda r: jm32.init(r, jnp.zeros((1, res, res, 3)), toks0))
    params = _perturb_clip(init(jax.random.PRNGKey(7))["params"], 7)
    # the JAX package's cast (stages.py:86-97)
    cast = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16)
                        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, params)
    tm = tclip.CLIP(**BF16_CLIP)
    tm.load_state_dict(to_torch(clip_state_dict_from_flax(params)), strict=True)
    return jclip.CLIP(dtype=jnp.bfloat16, **BF16_CLIP), cast, tm.eval().to(BF16)


def test_bf16_tower_state_dict_equals_the_jax_bf16_tree(bf16_towers):
    _, cast, tm = bf16_towers
    want = clip_state_dict_from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32), cast))
    got = tm.state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == BF16, key
        np.testing.assert_array_equal(got[key].float().numpy(), w, err_msg=key)


def test_bf16_towers_match_flax_through_the_pallas_path(monkeypatch, bf16_towers):
    from coda_neurips2023_tpu.models.tokenizer import tokenize as jax_tokenize
    from coda_neurips2023_tpu.models.text_bank import prompt

    jm, cast, tm = bf16_towers
    monkeypatch.setattr(jclip, "_FUSED_ATTN", "1")
    monkeypatch.setenv("CODA_VIT_ATTN_IMPL", "pallas")
    monkeypatch.setattr(pva, "_INTERPRET", True)
    rng = np.random.default_rng(8)
    res = BF16_CLIP["image_resolution"]
    imgs = rng.standard_normal((4, res, res, 3)).astype(np.float32)
    names = ["chair", "table", "night stand", "bathtub", "sofa bed"]
    toks = jax_tokenize([prompt(n) for n in names], context_length=BF16_CLIP["context_length"])
    toks = np.minimum(toks, BF16_CLIP["vocab_size"] - 1)  # EOT stays the row's largest id
    variables = {"params": cast}
    want_img = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, method=jm.encode_image))(
        variables, jnp.asarray(imgs)))
    want_txt = np.asarray(jax.jit(lambda v, t: jm.apply(v, t, method=jm.encode_text))(
        variables, jnp.asarray(toks)))
    with torch.inference_mode():
        got_img = tm.encode_image(torch.from_numpy(imgs))
        got_txt = tm.encode_text(torch.from_numpy(toks).long())
    for what, got, want in (("image", got_img, want_img), ("text", got_txt, want_txt)):
        assert got.dtype == torch.float32 and want.dtype == np.float32
        g = got.numpy() / np.linalg.norm(got.numpy(), axis=-1, keepdims=True)
        w = want / np.linalg.norm(want, axis=-1, keepdims=True)
        cos = (g * w).sum(-1)
        print(f"bf16 {what} tower: cosine min {cos.min():.6f}, normalized max_abs_err "
              f"{np.abs(g - w).max():.3e}")
        assert cos.min() >= TOWER_COS, (what, cos)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOWER_TOL, err_msg=what)


# ------------------------------------------------------------ bf16 detector


@pytest.fixture(scope="module")
def bf16_detector():
    batch = _batch(1, BF16_POINTS)
    jm32, variables, sd, _ = _build(BF16_DETECTOR, batch)
    tm = CoDA3DETR(SunrgbdAnonymousConfig(), compute_dtype=BF16, **BF16_DETECTOR)
    tm.load_state_dict(to_torch(sd), strict=True)
    jm = jmodel.CoDA3DETR(dataset_config=JaxConfig(), compute_dtype=jnp.bfloat16, **BF16_DETECTOR)
    return dict(batch=batch, variables=variables, jm=jm, tm=tm.eval())


def test_bf16_detector_matches_jax_through_the_fused_path(monkeypatch, bf16_detector):
    batch, jm, tm = bf16_detector["batch"], bf16_detector["jm"], bf16_detector["tm"]
    _assert_no_boundary_flip(batch, BF16_DETECTOR["preenc_npoints"])
    monkeypatch.setattr(jtransformer, "_FUSED_MASKED_ATTN", "1")
    monkeypatch.setattr(jtransformer, "_FUSED_MASKED_ATTN_DTYPE", "bfloat16")
    monkeypatch.setattr(pma, "_INTERPRET", True)
    # without XLA's excess precision, so that each op's output is rounded to
    # its dtype as PyTorch rounds it
    variables = bf16_detector["variables"]
    fn = jax.jit(lambda v, b: jm.apply(v, b, train=False)).lower(variables, batch).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want = jax.tree.map(np.asarray, fn(variables, batch))
    with torch.inference_mode():
        got = tm({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    assert set(got) == set(want)
    for key in NO_LAYER_AXIS:
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    same_bin = got["angle_logits"].argmax(-1).numpy() == want["angle_logits"].argmax(-1)
    print(f"angle classes: {int((~same_bin).sum())} of {same_bin.size} rows differ")
    assert same_bin.mean() >= 0.95
    angle_keys = ("angle_continuous", "box_corners", "box_corners_xyz")
    for key, w in want.items():
        g = got[key].numpy()
        assert g.dtype == w.dtype, key
        if key in NO_LAYER_AXIS:
            continue
        if key in angle_keys:
            g, w = g[same_bin], w[same_bin]
        tol = (SEM_LOGITS_TOL if key == "sem_cls_logits" else DETECTOR_TOL) * np.abs(w).max()
        print(f"{key}: max_abs_err {np.abs(g - w).max():.3e} (tol {tol:.3e})")
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=key)


def test_bf16_detector_refuses_training(bf16_detector):
    """The bf16 detector refused training mode until its training was
    ported; its training forward now runs: fp32 outputs, finite, with a
    gradient, and BatchNorm's running statistics moved in fp32."""
    tm = bf16_detector["tm"]
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in bf16_detector["batch"].items()}
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    try:
        out = tm.train()(batch, generator=torch.Generator().manual_seed(0))
        assert out["sem_cls_logits"].dtype == torch.float32
        assert all(torch.isfinite(v).all() for v in out.values() if v.is_floating_point())
        assert out["sem_cls_logits"].requires_grad
        stats = [k for k in before if k.endswith("running_var")]
        assert all(tm.state_dict()[k].dtype == torch.float32 for k in stats)
        assert any(not torch.equal(tm.state_dict()[k], before[k]) for k in stats)
    finally:
        tm.load_state_dict(before)
        tm.eval()


# ------------------------------------------------------------------ the CLI


def _cli_args(extra=()):
    return ["--dataset_name", "synthetic", "--synthetic_num_scenes", "8", "--num_points", "256",
            *[x for k, v in TINY.items() for x in (f"--{k}", str(v))], *extra]


TINY_CLIP = dict(embed_dim=512, image_resolution=16, vision_patch_size=8, vision_width=64,
                 vision_layers=1, text_width=32, text_layers=1, text_heads=2,
                 context_length=8, vocab_size=64)


def _tiny_context(monkeypatch):
    stages_cls = stages.StageContext

    def tiny_ctx(args, cfg, device="cuda"):
        clip = tclip.init_clip_parameters(tclip.CLIP(**TINY_CLIP), torch.Generator().manual_seed(0))
        return stages_cls(args, cfg, clip_model=clip, crop_size=16, device=device)

    monkeypatch.setattr(stages, "StageContext", tiny_ctx)


def test_cli_test_only_in_bf16_matches_test_model(monkeypatch, tmp_path):
    """`main --test_only --compute_dtype bf16`: a bf16 detector and a bf16
    tower, whose metrics are test_model's on that model."""
    monkeypatch.setenv("CODA_AP_WORKERS", "0")
    _tiny_context(monkeypatch)
    built = {}
    build = tmain.build_everything

    def keep(*a, **kw):
        built.update(build(*a, **kw))
        return built

    monkeypatch.setattr(tmain, "build_everything", keep)
    argv = _cli_args(["--test_only", "--compute_dtype", "bf16", "--log_file",
                      str(tmp_path / "bf16.lst")])
    got = tmain.main(argv, device="cpu")
    assert built["model"].compute_dtype == BF16
    assert built["stage_ctx"].clip_model.dtype == BF16
    args = tmain.make_args_parser().parse_args(argv)
    assert tmain.test_model(args, built) == got
    assert (tmp_path / "bf16.lst").read_text().startswith("mAP0.25")


@pytest.mark.parametrize("extra", [
    ["--compute_dtype", "bf16", "--max_epoch", "1", "--model_name", "3detrmulticlasshead",
     "--if_with_clip", "--if_input_image"],
    ["--compute_dtype", "bfloat16", "--test_only", "--show_only"],
], ids=["training", "mode"])
def test_cli_bf16_detector_only_at_eval(extra, tmp_path, monkeypatch):
    """`main --compute_dtype bf16` ran only with --test_only and no mode
    until the bf16 detector's training was ported; training and a mode now
    run: one epoch trains the baseline's bf16 detector (fp32 parameters, no
    text head) and writes its checkpoints (stage 1 and stage 2 through main:
    tests/test_torch_port_bf16_train.py); --show_only writes each test
    scene's files."""
    monkeypatch.setenv("CODA_AP_WORKERS", "0")
    _tiny_context(monkeypatch)
    got = tmain.main(_cli_args(extra + ["--checkpoint_dir", str(tmp_path)]), device="cpu")
    if "--show_only" in extra:
        assert got == 2  # synthetic_num_scenes 8 -> a test split of 2
        assert {"000000_pc.ply", "000001_pc.ply"} <= set(os.listdir(tmp_path / "show"))
    else:
        assert got.compute_dtype == BF16 and "text_correlation_head" not in got.mlp_heads
        assert all(p.dtype == torch.float32 for p in got.parameters())
        assert {"checkpoint.pth", "metrics.jsonl"} <= set(os.listdir(tmp_path))


def test_stage1_step_with_bf16_tower():
    """One stage-1 step (scripts/coda_sunrgbd_stage1.sh's losses) with
    --clip_dtype bf16: the frozen tower cast to bf16 and untouched by the
    step, a finite loss with its distillation term, the text banks from the
    bf16 tower."""
    from test_torch_port_stage1 import STAGE1_ARGS, _image_scenes

    args = types.SimpleNamespace(**dict(STAGE1_ARGS, clip_dtype="bf16"))
    clip = tclip.init_clip_parameters(tclip.CLIP(**TINY_CLIP), torch.Generator().manual_seed(0))
    ctx = StageContext(args, SunrgbdAnonymousConfig(), clip_model=clip, crop_size=16,
                       device="cpu")
    assert stages.clip_tower_dtype(args) == BF16 and ctx.clip_model.dtype == BF16
    assert all(p.dtype == BF16 for p in ctx.clip_model.parameters())
    bank = ctx.text_banks["test"]
    assert bank.dtype == torch.float32 and torch.isfinite(bank).all()
    torch.testing.assert_close(torch.linalg.vector_norm(bank, dim=1), torch.ones(len(bank)))
    before = {k: v.clone() for k, v in ctx.clip_model.state_dict().items()}
    model = CoDA3DETR(SunrgbdAnonymousConfig(), **TINY)
    from coda_neurips2023_tpu_torch.models.helpers import reset_parameters

    reset_parameters(model, torch.Generator().manual_seed(1)).train()
    opt, sched = build_optimizer(args, model, 600)
    step = ctx.make_fused_train_step(model, build_criterion(args, SunrgbdAnonymousConfig()), opt,
                                     lr_schedule=sched)
    batch = {k: torch.from_numpy(v) for k, v in _image_scenes().items()}
    metrics = step(batch, torch.Generator().manual_seed(0))
    loss = float(metrics["loss"])
    print(f"stage-1 step with the bf16 tower: loss {loss!r}, "
          f"distillation {float(metrics['loss_predicted_region_embed_l1'])!r}")
    assert math.isfinite(loss)
    assert float(metrics["loss_predicted_region_embed_l1"]) > 0
    for k, v in ctx.clip_model.state_dict().items():
        assert torch.equal(v, before[k]), k


# ------------------------------------------- stage 2's discovery, bf16 tower

# |p_port - p_jax| of a crop's class probabilities between the two bf16
# towers (measured 1.36e-2 on this case: logit scale 100 turns the
# embeddings' bf16 rounding into a few tenths of a logit); a crop whose JAX
# top-1 probability lies this close to the keep threshold, or to its
# runner-up, may be decided either way
DISCOVERY_PROB_TOL = 2e-2


def test_discovery_with_bf16_tower_matches_jax(monkeypatch):
    """discover_novel_boxes with --clip_dtype bf16's tower on both sides (the
    JAX tower through its fused Pallas path): the gates before CLIP's equal;
    the novel mask equal except on crops that the JAX scores leave within
    DISCOVERY_PROB_TOL of the threshold or of a tie (counted and printed),
    scene by scene; the rows both keep equal but for the probability,
    within DISCOVERY_PROB_TOL."""
    from coda_neurips2023_tpu.models import discovery as jdisc
    from coda_neurips2023_tpu_torch.models import discovery as tdisc
    from test_torch_port_clip import TINY_CLIP as DISC_CLIP
    from test_torch_port_clip import _jax_clip, _port_clip
    from test_torch_port_discovery import CROP, ROW_TOL, _assert_rects_away_from_integers
    from test_torch_port_discovery import _discovery_inputs

    batch, outputs, text = _discovery_inputs()
    _assert_rects_away_from_integers(batch, outputs)
    _, params = _jax_clip(DISC_CLIP)
    cast = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), params)
    jm = jclip.CLIP(dtype=jnp.bfloat16, **DISC_CLIP)
    tm = _port_clip(DISC_CLIP, params).to(BF16)
    monkeypatch.setattr(jclip, "_FUSED_ATTN", "1")
    monkeypatch.setenv("CODA_VIT_ATTN_IMPL", "pallas")
    monkeypatch.setattr(pva, "_INTERPRET", True)
    kw = dict(train_range_max=10, save_objectness=0.3, clip_driven_keep_thres=0.3,
              crop_size=CROP)
    j_tower = jax.jit(lambda x: jm.apply({"params": cast}, x, method=jm.encode_image))
    want = jax.tree.map(np.asarray, jax.jit(
        lambda o, bt, tx: jdisc.discover_novel_boxes(o, bt, j_tower, tx, 100.0, **kw))(
        outputs, batch, text))
    crops = []

    def t_tower(images):
        crops.append(images)
        return tm.encode_image(images)

    got = tdisc.discover_novel_boxes({k: torch.from_numpy(v) for k, v in outputs.items()},
                                     {k: torch.from_numpy(v) for k, v in batch.items()},
                                     t_tower, torch.from_numpy(text), 100.0, **kw)
    got = {k: v.numpy() for k, v in got.items()}

    def probs(emb):
        unit = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
        logits = 100.0 * unit @ text.T
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    p_jax = probs(np.asarray(j_tower(jnp.asarray(crops[0].numpy()))))
    with torch.no_grad():
        p_port = probs(tm.encode_image(crops[0]).numpy())
    print(f"crop class probabilities, bf16 towers: max |port - jax| "
          f"{np.abs(p_port - p_jax).max():.3e}")
    assert np.abs(p_port - p_jax).max() <= DISCOVERY_PROB_TOL
    top2 = np.sort(p_jax, -1)[:, ::-1][:, :2]
    undecided = ((np.abs(top2[:, 0] - kw["clip_driven_keep_thres"]) <= DISCOVERY_PROB_TOL)
                 | (top2[:, 0] - top2[:, 1] <= DISCOVERY_PROB_TOL)).reshape(2, -1)
    print(f"crops left out of the mask comparison (JAX score within {DISCOVERY_PROB_TOL} of the "
          f"threshold or a tie): {int(undecided.sum())} of {undecided.size}")
    print(f"novel rows: port {int(got['novel_mask'].sum())}, JAX {int(want['novel_mask'].sum())}")
    both = got["novel_mask"] & want["novel_mask"]
    for i in range(2):
        differ = int((got["novel_mask"][i] != want["novel_mask"][i]).sum())
        assert differ <= int(undecided[i].sum()), (i, differ)
    rows_got, rows_want = got["save_box_info"][both], want["save_box_info"][both]
    np.testing.assert_allclose(rows_got[:, [0, 1, 2, 3, 4, 5, 6, 7, 9]],
                               rows_want[:, [0, 1, 2, 3, 4, 5, 6, 7, 9]], rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(rows_got[:, 8], rows_want[:, 8], rtol=0, atol=DISCOVERY_PROB_TOL)
