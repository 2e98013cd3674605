"""The PyTorch port's CLIP and CLIP-crop eval against the JAX package on the CPU.

Inputs are made from seeds with numpy; flax weights reach the port through
`utils.weights.clip_state_dict_from_flax` (CLIP) and `state_dict_from_flax`
(detector).  Tolerances, each with its reason:

  * token ids, rects and the `clip_state_dict_from_flax` round trip: exact;
  * `vit_attention_plain` vs the Pallas kernel in interpret mode: 2e-5 (fp32
    sums in another order, O(1) outputs);
  * the towers, the text banks, sem_cls_prob: 1e-4 (fp32, XLA's and
    PyTorch's matmuls sum in different orders through every layer);
  * `_bicubic_matrix`: 1e-6 (weights in [-0.1, 1], a few fp32 operations);
  * crops: exact, except where the unrounded value lies within 1e-3 of a
    half-integer, where the last bits of the two einsums decide the rounding.

Rects are compared only after asserting that no projected coordinate lies
within 1e-4 of an integer, where truncation would depend on the order of
the projection's sums.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coda_neurips2023_tpu.datasets.config import SunrgbdImageConfig as JaxImageConfig
from coda_neurips2023_tpu.datasets.config import load_cmp_names as jax_load_cmp_names
from coda_neurips2023_tpu.datasets.config import load_superset_names as jax_load_superset_names
from coda_neurips2023_tpu.datasets.synthetic import SyntheticDetectionDataset as JaxScenes
from coda_neurips2023_tpu.engine import TrainState
from coda_neurips2023_tpu.engine import make_eval_step as jax_make_eval_step
from coda_neurips2023_tpu.models import clip as jclip
from coda_neurips2023_tpu.models import distillation as jdist
from coda_neurips2023_tpu.models import text_bank as jbank
from coda_neurips2023_tpu.models.tokenizer import tokenize as jax_tokenize
from coda_neurips2023_tpu.ops import pallas_vit_attention as pva
from coda_neurips2023_tpu.ops import projection as jproj
from coda_neurips2023_tpu.stages import StageContext as JaxStageContext

from coda_neurips2023_tpu_torch.datasets.config import SunrgbdImageConfig, load_cmp_names
from coda_neurips2023_tpu_torch.datasets.config import load_superset_names
from coda_neurips2023_tpu_torch.engine import make_eval_step
from coda_neurips2023_tpu_torch.models import distillation as tdist
from coda_neurips2023_tpu_torch.models import tokenizer as ttok
from coda_neurips2023_tpu_torch.models.clip import CLIP
from coda_neurips2023_tpu_torch.models.text_bank import build_text_banks
from coda_neurips2023_tpu_torch.ops import projection as tproj
from coda_neurips2023_tpu_torch.ops.vit_attention import vit_attention, vit_attention_plain
from coda_neurips2023_tpu_torch.stages import StageContext
from coda_neurips2023_tpu_torch.utils.weights import clip_state_dict_from_flax, to_torch

from test_torch_port_model import TINY, _build
from torch_one_thread import one_intra_op_thread  # noqa: F401

TOL = 1e-4
ATTN_TOL = 2e-5
# the tiny CLIP of tests/test_stages.py, and one with two heads and two layers
TINY_CLIP = dict(embed_dim=512, image_resolution=16, vision_patch_size=8, vision_width=64,
                 vision_layers=1, text_width=32, text_layers=1, text_heads=2,
                 context_length=8, vocab_size=64)
SMALL_CLIP = dict(embed_dim=32, image_resolution=32, vision_patch_size=8, vision_width=128,
                  vision_layers=2, text_width=64, text_layers=2, text_heads=4,
                  context_length=16, vocab_size=49408)


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _perturb_clip(params, seed):
    """flax CLIP params with random LayerNorm scales and biases, so that no
    norm is an identity and no bias is zero."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        name = jax.tree_util.keystr(path[-1:])
        if "bias" in name or "scale" in name:
            return (x + rng.normal(0.0, 0.1, x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


def _jax_clip(config, seed=0):
    jm = jclip.CLIP(**config)
    res = config["image_resolution"]
    imgs = jnp.zeros((1, res, res, 3))
    toks = jnp.zeros((1, config["context_length"]), jnp.int32)
    params = _perturb_clip(jm.init(jax.random.PRNGKey(seed), imgs, toks)["params"], seed)
    return jm, params


def _port_clip(config, params):
    tm = CLIP(**config)
    result = tm.load_state_dict(to_torch(clip_state_dict_from_flax(params)), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    return tm.eval()


def _class_prompts():
    cfg = SunrgbdImageConfig()
    return [jbank.prompt(n) for n in cfg.vocab_names + load_cmp_names()]


# ------------------------------------------------------------ tokenizer, config


@pytest.mark.parametrize("pattern", ["regex", "re"])
def test_tokenizer_ids_equal(monkeypatch, pattern):
    """All 46 SUN RGB-D prompts and the cmp vocabulary; with `re` the port
    takes the pattern it uses where the `regex` package is missing."""
    prompts = _class_prompts()
    assert len(prompts) == 46 + 20
    want = jax_tokenize(prompts)
    if pattern == "re":
        monkeypatch.setattr(ttok, "_has_regex_module", lambda: False)
    got = ttok.tokenize(prompts)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == ttok.VOCAB_SIZE - 2).all() and (got.max(1) == ttok.VOCAB_SIZE - 1).all()


def test_config_vocabularies_match_jax():
    got, want = SunrgbdImageConfig(), JaxImageConfig()
    assert got.vocab_names == want.vocab_names and len(got.vocab_names) == 46
    assert got.seen_vocab_idx == want.seen_vocab_idx == list(range(10))
    assert got.image_size == want.image_size == [730, 531]
    assert got.num_semcls == want.num_semcls == 46
    assert load_cmp_names() == jax_load_cmp_names()
    assert load_superset_names() == jax_load_superset_names()


# --------------------------------------------------------------- weight bridge


@pytest.mark.parametrize("config", [TINY_CLIP, SMALL_CLIP], ids=["tiny", "small"])
def test_clip_state_dict_round_trip(config):
    """clip_state_dict_from_flax o convert_openai_state_dict is the identity on
    a random OpenAI-layout state dict with the port's names and shapes."""
    names = CLIP(**config).state_dict()
    rng = np.random.default_rng(1)
    sd = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32) for k, v in names.items()}
    params = jclip.convert_openai_state_dict(
        sd, vision_heads=max(config["vision_width"] // 64, 1), text_heads=config["text_heads"]
    )
    back = clip_state_dict_from_flax(params)
    assert set(back) == set(names)
    for k, v in sd.items():
        assert back[k].shape == v.shape and back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


# -------------------------------------------------------------------- kernel E


def test_vit_attention_plain_matches_pallas_interpret():
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((3, 4, 197, 32)).astype(np.float32) for _ in range(3))
    old = pva._INTERPRET
    pva._INTERPRET = True
    try:
        want = np.asarray(pva.vit_attention(*map(jnp.asarray, (q, k, v))))
    finally:
        pva._INTERPRET = old
    got = vit_attention_plain(*map(torch.from_numpy, (q, k, v)))
    _close(got, want, ATTN_TOL, "vit_attention_plain")
    wrapped = vit_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


# ---------------------------------------------------------------------- towers


@pytest.mark.parametrize("config", [TINY_CLIP, SMALL_CLIP], ids=["tiny", "small"])
def test_towers_match_flax(config):
    jm, params = _jax_clip(config)
    tm = _port_clip(config, params)
    rng = np.random.default_rng(3)
    res = config["image_resolution"]
    imgs = rng.standard_normal((3, res, res, 3)).astype(np.float32)
    toks = jax_tokenize(_class_prompts()[:5], context_length=config["context_length"])
    toks = np.minimum(toks, config["vocab_size"] - 1)
    variables = {"params": params}
    want_img = jm.apply(variables, jnp.asarray(imgs), method=jm.encode_image)
    want_txt = jm.apply(variables, jnp.asarray(toks), method=jm.encode_text)
    want_logits = jm.apply(variables, jnp.asarray(imgs), jnp.asarray(toks))[0]
    with torch.inference_mode():
        t_imgs, t_toks = torch.from_numpy(imgs), torch.from_numpy(toks).long()
        _close(tm.encode_image(t_imgs), want_img, what="encode_image")
        _close(tm.encode_text(t_toks), want_txt, what="encode_text")
        _close(tm(t_imgs, t_toks)[0], want_logits, 1e-3, "logits (x exp(logit_scale) = 14.3)")


@pytest.mark.parametrize("superset", [False, True])
def test_text_banks_match_jax(superset):
    jm, params = _jax_clip(TINY_CLIP)
    tm = _port_clip(TINY_CLIP, params)
    kw = dict(train_range_max=10, test_range_max=46, cmp_names=load_cmp_names(),
              superset_names=load_superset_names() if superset else None,
              if_clip_more_prompts=superset)
    want = jbank.build_text_banks(JaxImageConfig(), clip_model=jm,
                                  clip_variables={"params": params}, **kw)
    got = build_text_banks(SunrgbdImageConfig(), clip_model=tm, **kw)
    assert set(got) == set(want)
    assert got["superset_prompts"] == want["superset_prompts"]
    for key in ("train", "test", "cmp", "superset"):
        _close(got[key], want[key], what=key)
    assert got["test"].shape == (46, 512)
    if superset:
        assert got["superset"].shape[0] > 1000


# ------------------------------------------------------- crops and projection


def _rect_cases():
    rng = np.random.default_rng(4)
    x0 = rng.integers(0, 80, 12)
    y0 = rng.integers(0, 50, 12)
    rects = np.stack([x0, y0, x0 + rng.integers(0, 40, 12), y0 + rng.integers(0, 40, 12)], 1)
    rects[0] = [3, 4, 3, 20]  # zero width
    rects[1] = [0, 0, 96, 64]  # the whole image
    rects[2] = [10, 10, 11, 12]  # tiny: upscaled
    return rects.astype(np.int32)


def test_bicubic_matrix_matches_jax():
    rects = _rect_cases()
    edge = np.maximum(rects[:, 3] - rects[:, 1], rects[:, 2] - rects[:, 0]).astype(np.int32)
    taps = jdist._crop_max_taps(64, 96, 16)
    assert taps == tdist._crop_max_taps(64, 96, 16)
    for size_img, lo, ln in ((64, rects[:, 1], rects[:, 3] - rects[:, 1]),
                             (96, rects[:, 0], rects[:, 2] - rects[:, 0])):
        begin = ((edge - ln) // 2).astype(np.float32)
        got_k, got_m = tdist._bicubic_matrix(*map(torch.from_numpy, (edge, lo, begin, ln)),
                                             size_img, 16, taps)
        for i in range(len(rects)):
            want_k, want_m = jdist._bicubic_matrix(*map(jnp.asarray, (edge[i], lo[i], begin[i], ln[i])),
                                                   size_img, 16, taps)
            _close(got_k[i], want_k, 1e-6, f"K rect {i}")
            _close(got_m[i], want_m, 1e-6, f"m rect {i}")


@pytest.mark.parametrize("out_size", [16, 224])
def test_crops_match_jax(out_size):
    rng = np.random.default_rng(5)
    image = rng.integers(0, 255, (64, 96, 3)).astype(np.float32)
    rects = _rect_cases()
    got = tdist.crop_square_resize_white(torch.from_numpy(image), torch.from_numpy(rects), out_size)
    want = np.stack([np.asarray(jdist.crop_square_resize_white(jnp.asarray(image), jnp.asarray(r),
                                                               out_size)) for r in rects])
    # the JAX crop before rounding, to find the values at a rounding boundary
    taps = jdist._crop_max_taps(64, 96, out_size)
    raw = []
    for r in rects:
        w, h = r[3] - r[1], r[2] - r[0]
        e = max(w, h)
        ky, my = jdist._bicubic_matrix(jnp.int32(e), jnp.int32(r[1]), jnp.float32((e - w) // 2),
                                       jnp.int32(w), 64, out_size, taps)
        kx, mx = jdist._bicubic_matrix(jnp.int32(e), jnp.int32(r[0]), jnp.float32((e - h) // 2),
                                       jnp.int32(h), 96, out_size, taps)
        val = jnp.einsum("pw,owc->opc", kx, jnp.einsum("oh,hwc->owc", ky, jnp.asarray(image)))
        raw.append(np.asarray(val + 255.0 * (1.0 - my[:, None] * mx[None, :])[..., None]))
    raw = np.clip(np.stack(raw), 0, 255)
    boundary = np.abs(raw - np.floor(raw) - 0.5) < 1e-3
    assert got.shape == want.shape == (len(rects), out_size, out_size, 3)
    np.testing.assert_array_equal(got.numpy()[~boundary], want[~boundary])
    assert np.abs(got.numpy() - want).max() <= 1.0
    assert boundary.mean() < 0.01
    assert (got.numpy()[0] == 255).all()  # zero-width rect: all white


def test_preprocess_crops_constants_per_device():
    """The plain normalisation copies CLIP's constants to a device once and
    gives, bit for bit, the formula that copied them at every call."""
    crops = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (3, 8, 8, 3))
                             .astype(np.float32))
    want = (crops / 255.0 - torch.from_numpy(tdist.IMAGE_MEAN)) / torch.from_numpy(tdist.IMAGE_STD)
    got = tdist.preprocess_crops(crops)
    consts = tdist._NORMALISE[crops.device]
    with torch.inference_mode():
        again = tdist.preprocess_crops(crops)
    assert tdist._NORMALISE[crops.device] is consts
    assert not any(c.is_inference() for c in consts)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(again.numpy(), want.numpy())


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_clip_crops_cpu_takes_the_plain_path(monkeypatch, dtype):
    """On the CPU `clip_crops` and `crop_square_resize_white` never reach the
    crop kernel: every scene's crops are the plain crop and normalisation of
    its own image, bit for bit, scene-major."""
    def refuse(*args, **kw):
        raise AssertionError("a CPU crop reached the kernel")

    monkeypatch.setattr(tdist._kernels, "launch", refuse)
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (2, 64, 96, 3)).astype(dtype)
    rects = np.stack([_rect_cases(), _rect_cases()[::-1]])
    got = tdist.clip_crops(torch.from_numpy(images), torch.from_numpy(rects), 16)
    assert got.shape == (2 * len(rects[0]), 16, 16, 3) and got.dtype == torch.float32
    for i in range(2):
        image = torch.from_numpy(images[i].astype(np.float32))
        plain = tdist.crop_square_resize_white_plain(image, torch.from_numpy(rects[i]), 16)
        want = tdist.preprocess_crops(plain)
        np.testing.assert_array_equal(got[i * len(rects[i]):(i + 1) * len(rects[i])].numpy(),
                                      want.numpy())
        np.testing.assert_array_equal(
            tdist.crop_square_resize_white(image, torch.from_numpy(rects[i]), 16).numpy(),
            plain.numpy())


def _calibrated_corners(seed):
    rng = np.random.default_rng(seed)
    b, q = 2, 6
    corners = rng.uniform(-2, 2, (b, q, 8, 3)).astype(np.float32)
    corners[..., 1] = rng.uniform(0.5, 4, (b, q, 8))  # in front of the camera
    corners[1, 0, :, 1] = -1.0  # behind it
    ang = rng.uniform(-0.3, 0.3, b)
    rot = np.stack([np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
                    for a in ang]).astype(np.float32)
    batch = {
        "scale_array": rng.uniform(0.9, 1.1, (b, 3)).astype(np.float32),
        "rot_array": rot,
        "flip_array": np.array([1, -1], np.float32),
        "zx_flip_array": np.array([-1, 1], np.float32),
        "K": np.array([[[500, 0, 360], [0, 500, 260], [0, 0, 1]]] * b, np.float32),
        "Rtilt": rot.transpose(0, 2, 1).copy(),
        "ori_width": np.array([730, 700], np.float32),
        "ori_height": np.array([531, 500], np.float32),
        "x_offset": np.array([0, 15], np.float32),
        "y_offset": np.array([0, 12], np.float32),
        "image_flip_array": np.array([1, 0], np.float32),
        "flip_length": np.array([730, 730], np.float32),
    }
    return corners, batch


def _assert_no_integer_boundary(uv, batch):
    """No projected coordinate (float64) that the clip to the image leaves as
    it is lies within 1e-4 of an integer; the offsets and flip lengths are
    integers, so they move no coordinate onto one."""
    for c, bound in ((uv[..., 0], batch["ori_width"]), (uv[..., 1], batch["ori_height"])):
        inside = (c > 0) & (c < bound[:, None, None] - 1)
        frac = np.abs(c - np.round(c))[inside]
        assert frac.size and frac.min() > 1e-4, "a coordinate lies at an integer: pick another seed"


def test_projection_and_rects_match_jax():
    corners, batch = _calibrated_corners(7)
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    args = ("scale_array", "rot_array", "flip_array", "zx_flip_array")
    want_un = jproj.unaugment_corners(jnp.asarray(corners), *(j[a] for a in args))
    got_un = tproj.unaugment_corners(torch.from_numpy(corners), *(t[a] for a in args))
    _close(got_un, want_un, 1e-6, "unaugment_corners")
    un = np.array(want_un)
    b, q = un.shape[:2]
    uv, depth = tproj.project_upright_depth_to_image(
        torch.from_numpy(un.reshape(b, q * 8, 3)), t["K"], t["Rtilt"])
    want_uv, want_depth = jproj.project_upright_depth_to_image(
        jnp.asarray(un.reshape(b, q * 8, 3)), j["K"], j["Rtilt"])
    _close(uv, want_uv, 1e-3, "uv (pixels)")
    _close(depth, want_depth, 1e-6, "depth")
    _assert_no_integer_boundary(np.asarray(want_uv, np.float64).reshape(b, q, 8, 2), batch)
    geo = ("K", "Rtilt", "ori_width", "ori_height", "x_offset", "y_offset", "image_flip_array",
           "flip_length")
    got_r, got_d = tproj.corners_to_image_rects(torch.from_numpy(un), *(t[a] for a in geo))
    want_r, want_d = jproj.corners_to_image_rects(jnp.asarray(un), *(j[a] for a in geo))
    assert got_r.dtype == torch.int32
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    _close(got_d, want_d, 1e-6, "min depth")
    assert (got_d.numpy() < 0).any() and (got_d.numpy() >= 0).any()  # both sides of the camera


def test_expand_box_floors_like_jax():
    rects = _rect_cases()
    rects[3] = [50, 10, 53, 60]  # tall: odd difference
    rects[4] = [5, 5, 70, 8]  # wide
    got = tdist.expand_box(torch.from_numpy(rects), 64, 96).numpy()
    xmin, ymin, xmax, ymax = (rects[:, i] for i in range(4))
    bw, bh = xmax - xmin, ymax - ymin
    dx = np.where(bh > bw, (bh - bw) // 2, 0)
    dy = np.where(bh > bw, 0, (bw - bh) // 2)
    want = np.stack([np.clip(xmin - dx, 0, 96), np.clip(ymin - dy, 0, 64),
                     np.clip(xmax + dx, 0, 96), np.clip(ymax + dy, 0, 64)], -1)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ CLIP eval step


def _stage_args(**over):
    base = dict(train_range_max=10, test_range_max=46, if_clip_more_prompts=True,
                if_clip_superset=False, clip_model_path=None, clip_bpe_path=None,
                dataset_name="sunrgbd")
    base.update(over)
    return types.SimpleNamespace(**base)


@pytest.fixture(scope="module")
def clip_eval():
    """The tiny baseline detector (no text head) and the tiny CLIP, in flax
    and in the port, on 2 scenes with 64 x 96 images."""
    jds = JaxScenes(JaxImageConfig(), num_scenes=2, num_points=1024, with_images=True, seed=2)
    samples = [jds[i] for i in range(2)]
    batch = {k: np.stack([s[k] for s in samples]) for k, v in samples[0].items()
             if not isinstance(v, str)}
    kw = dict(TINY, with_text_head=False)
    jm, variables, _, tm = _build(kw, {k: batch[k] for k in ("point_clouds",
                                                             "point_cloud_dims_min",
                                                             "point_cloud_dims_max")})
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], constants=variables["constants"],
                       opt_state=())
    jclip_model = jclip.CLIP(**TINY_CLIP)
    return dict(batch=batch, jm=jm, state=state, tm=tm, jclip=jclip_model)


def _contexts(clip_eval, **over):
    args = _stage_args(**over)
    jctx = JaxStageContext(args, JaxImageConfig(), clip_model=clip_eval["jclip"], crop_size=16)
    tclip = _port_clip(TINY_CLIP, jax.tree.map(np.asarray, jctx.clip_variables["params"]))
    tctx = StageContext(args, SunrgbdImageConfig(), clip_model=tclip, crop_size=16, device="cpu")
    return jctx, tctx


def _check_rects(clip_eval, got_last):
    """The port's rects equal the JAX rects of the same boxes (boundary guarded)."""
    batch = clip_eval["batch"]
    last = {k: jnp.asarray(v.numpy()) for k, v in got_last.items()}
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    un = jproj.unaugment_corners(last["box_corners_xyz"], j["scale_array"], j["rot_array"],
                                 j["flip_array"])
    b, q = un.shape[:2]
    uv, _ = jproj.project_upright_depth_to_image(un.reshape(b, q * 8, 3), j["K"], j["Rtilt"])
    _assert_no_integer_boundary(np.asarray(uv, np.float64).reshape(b, q, 8, 2), batch)
    want, _ = jproj.corners_to_image_rects(un, *(j[k] for k in (
        "K", "Rtilt", "ori_width", "ori_height", "x_offset", "y_offset", "image_flip_array",
        "flip_length")))
    got, valid = tdist.crop_rects(got_last, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return valid


@pytest.mark.parametrize("flags", [{}, {"if_expand_box": True}, {"if_only_novel_prompt": True},
                                   {"if_use_gt_box": True}],
                         ids=["default", "expand_box", "only_novel_prompt", "use_gt_box"])
def test_clip_eval_step_matches_jax(clip_eval, flags):
    batch = clip_eval["batch"]  # holds the ground-truth boxes that if_use_gt_box reads
    jctx, tctx = _contexts(clip_eval, **flags)
    for key in ("train", "test", "cmp", "superset"):
        _close(tctx.text_banks[key], jctx.text_banks[key], what=f"bank {key}")
    want = jctx.make_clip_eval_step(clip_eval["jm"])(clip_eval["state"], batch)
    got = tctx.make_clip_eval_step(clip_eval["tm"])({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want)
    ncls = 27 if flags.get("if_only_novel_prompt") else 46
    assert tuple(got["sem_cls_prob"].shape) == (2, TINY["nqueries"], ncls)
    for key in want:
        _close(got[key], want[key], what=key)
    sums = got["sem_cls_prob"].sum(-1)
    assert ((sums - 1).abs() < 1e-5).logical_or(sums == 0).all()
    assert (sums > 0).any()


def test_engine_eval_step_with_clip_crop_fn_matches_jax(clip_eval):
    batch = clip_eval["batch"]
    jctx, tctx = _contexts(clip_eval)
    jtext, ttext = jctx.text_banks["test"], tctx.text_banks["test"]

    def jax_crop_fn(last, b):
        return jdist.clip_crop_scores(last, b, jctx.clip_image_fn, jtext, 100.0, 16)

    def port_crop_fn(last, b):
        _check_rects(clip_eval, last)
        return tdist.clip_crop_scores(last, b, tctx.clip_image_fn, ttext, 100.0, 16)

    want = jax_make_eval_step(clip_eval["jm"], clip_crop_fn=jax_crop_fn)(clip_eval["state"], batch)
    got = make_eval_step(clip_eval["tm"], clip_crop_fn=port_crop_fn)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in want:
        _close(got[key], want[key], what=key)


@pytest.mark.parametrize("scale,want", [(50.0, 50.0), (200.0, 100.0)])
def test_stage_context_loads_openai_checkpoint(tmp_path, scale, want):
    """A checkpoint at --clip_model_path loads by OpenAI's names (its
    hyper-parameter entries dropped), strict; logit scale min(exp, 100)."""
    _, params = _jax_clip(TINY_CLIP)
    sd = to_torch(clip_state_dict_from_flax(params))
    sd["logit_scale"] = torch.tensor(np.log(scale), dtype=torch.float32)
    sd.update(input_resolution=torch.tensor(16), context_length=torch.tensor(8),
              vocab_size=torch.tensor(64))
    path = tmp_path / "ViT-tiny.pt"
    torch.save(sd, path)
    tm = CLIP(**TINY_CLIP)
    ctx = StageContext(_stage_args(clip_model_path=str(path)), SunrgbdImageConfig(),
                       clip_model=tm, crop_size=16, device="cpu")
    assert ctx.clip_model is tm
    assert ctx.logit_scale == pytest.approx(want, rel=1e-6)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert tuple(ctx.text_banks["test"].shape) == (46, 512)


@pytest.mark.slow
def test_clip_eval_vit_b16_width_one_scene(clip_eval):
    """ViT-B/16 and the CLIP text tower at their published widths (random
    weights, JAX's PRNGKey(0) init), crops of 224, on one scene with a
    531 x 730 image, against the JAX StageContext."""
    jds = JaxScenes(JaxImageConfig(), num_scenes=1, num_points=1024, with_images=True, seed=2,
                    image_hw=(531, 730))
    s = jds[0]
    batch = {k: np.stack([v]) for k, v in s.items() if not isinstance(v, str)}
    args = _stage_args()
    jctx = JaxStageContext(args, JaxImageConfig())
    tclip = CLIP()
    tclip.load_state_dict(to_torch(clip_state_dict_from_flax(
        jax.tree.map(np.asarray, jctx.clip_variables["params"]))), strict=True)
    tctx = StageContext(args, SunrgbdImageConfig(), clip_model=tclip, device="cpu")
    _close(tctx.text_banks["test"], jctx.text_banks["test"], what="bank")
    pts = {k: batch[k] for k in ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")}
    jm, variables, _, tm = _build(dict(TINY, with_text_head=False), pts)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], constants=variables["constants"],
                       opt_state=())
    want = jctx.make_clip_eval_step(jm)(state, batch)
    got = tctx.make_clip_eval_step(tm)({k: torch.from_numpy(v) for k, v in batch.items()})
    for key in want:
        _close(got[key], want[key], what=key)
