"""Kernel H's wrapper (ops/tower_gemm.py) on the CPU: the plain path with
each epilogue against F.linear and the tower's own ops bit for bit, the
weights' TF32 split, the refusals, and the CLIP towers' linear layers routed
through it with unchanged results.  The kernel itself runs only on the card
(tests/test_torch_port_cuda.py, chip_smoke.py phase 23); its parity with
the JAX package's CLIP is tests/test_torch_port_clip.py's."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from coda_neurips2023_tpu_torch.models import clip as tclip
from coda_neurips2023_tpu_torch.ops import tower_gemm as tg

from torch_one_thread import one_intra_op_thread  # noqa: F401


def _case(seed, m=(2, 7), k=64, n=96):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(m + (k,)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(n) * 0.02).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal(m + (n,)).astype(np.float32))
    return x, w, b, r


@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual", "qkv"])
def test_plain_epilogues_bit_for_bit(epilogue):
    """On the CPU each epilogue is the tower's former ops, bit for bit."""
    x, w, b, r = _case(1)
    y = F.linear(x, w, b)
    want = {
        "bias": y,
        "gelu": tclip.quick_gelu(y),
        "residual": r + y,
        "qkv": y.view(2, 7, 3, 4, 8).permute(2, 0, 3, 1, 4).contiguous(),
    }[epilogue]
    got = tg.tower_linear(x, w, b, epilogue, residual=r if epilogue == "residual" else None,
                          heads=4 if epilogue == "qkv" else None)
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want)


def _rna_numpy(v):
    """TF32 rounding to nearest, ties away from zero, on the bits (numpy)."""
    bits = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    return (((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("case", ["normal", "ties", "tiny_and_huge"])
def test_split_tf32(case):
    """hi = tf32(w) and lo = tf32(w - hi), each with its low 13 bits zero,
    rounded as the kernels' `tf32_rna`; hi + lo holds w to 2^-22 of it."""
    rng = np.random.default_rng(7)
    if case == "normal":
        w = rng.standard_normal(4096).astype(np.float32)
    elif case == "ties":  # the 13th bit set and nothing below: exact halves
        bits = (rng.integers(0x3F000000, 0x41000000, 4096, dtype=np.uint32) & ~np.uint32(0x1FFF))
        w = (bits | 0x1000).view(np.float32) * np.where(rng.random(4096) < 0.5, -1, 1)
        w = w.astype(np.float32)
    else:
        w = (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)).astype(np.float32)
        w[:4] = [0.0, -0.0, 1.0, -2.0]
    hi, lo = tg.split_tf32(torch.from_numpy(w))
    hi, lo = hi.numpy(), lo.numpy()
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi, _rna_numpy(w))
    np.testing.assert_array_equal(lo, _rna_numpy(w - hi))
    rest = np.abs(w.astype(np.float64) - hi - lo)
    assert (rest <= 2.0 ** -22 * np.abs(w.astype(np.float64))).all()


def test_weight_parts_kept_and_remade():
    """The parts are made once a weight, and anew after an in-place write."""
    w = torch.nn.Parameter(torch.randn(16, 8))
    hi, lo = tg.weight_parts(w)
    assert tg.weight_parts(w)[0] is hi
    with torch.no_grad():
        w.mul_(3.0)
    hi3, lo3 = tg.weight_parts(w)
    assert hi3 is not hi
    ref_hi, ref_lo = tg.split_tf32(w.detach())
    assert torch.equal(hi3, ref_hi) and torch.equal(lo3, ref_lo)


def _refused(kind):
    x, w, b, r = _case(2)
    kw = {}
    if kind == "bf16":
        x, w, b = x.bfloat16(), w.bfloat16(), b.bfloat16()
    elif kind == "x_not_contiguous":
        x = x.transpose(0, 1)
    elif kind == "residual_not_contiguous":
        kw = dict(epilogue="residual", residual=torch.randn(7, 2, 96).transpose(0, 1))
    elif kind == "residual_missing":
        kw = dict(epilogue="residual")
    elif kind == "residual_shape":
        kw = dict(epilogue="residual", residual=r[:, :3])
    elif kind == "weight_shape":
        w = w[:, :32].contiguous()
    elif kind == "epilogue":
        kw = dict(epilogue="relu")
    elif kind == "qkv_heads":
        kw = dict(epilogue="qkv", heads=5)
    return lambda: tg.tower_linear(x, w, b, **kw)


@pytest.mark.parametrize("kind", ["bf16", "x_not_contiguous", "residual_not_contiguous",
                                  "residual_missing", "residual_shape", "weight_shape",
                                  "epilogue", "qkv_heads"])
def test_wrapper_refuses(kind):
    with pytest.raises(ValueError):
        _refused(kind)()


@pytest.mark.parametrize("which", ["x", "weight", "bias", "residual"])
def test_wrapper_refuses_inputs_that_need_a_gradient(which):
    """Kernel H has no backward, so the wrapper raises on every device where
    autograd would need one; under no_grad the same inputs pass."""
    x, w, b, r = _case(3)
    tensors = dict(x=x, weight=w, bias=b, residual=r)
    tensors[which] = tensors[which].clone().requires_grad_()
    args = (tensors["x"], tensors["weight"], tensors["bias"], "residual", tensors["residual"])
    with pytest.raises(RuntimeError):
        tg.tower_linear(*args)
    with torch.no_grad():
        assert torch.equal(tg.tower_linear(*args), r + F.linear(x, w, b))


def _tiny_clip(seed):
    model = tclip.CLIP(embed_dim=32, image_resolution=16, vision_patch_size=8, vision_width=64,
                       vision_layers=2, text_width=32, text_layers=2, text_heads=2,
                       context_length=8, vocab_size=64, device="cpu")
    return tclip.init_clip_parameters(model, torch.Generator().manual_seed(seed)).eval()


@pytest.mark.parametrize("tower", ["image", "text"])
def test_clip_towers_route_and_results(tower, monkeypatch):
    """The image tower's four linear layers a block go through `tower_linear`
    and the text tower's do not; on the CPU both towers give what their
    former ops (`helpers.linear`, `quick_gelu`, the residual adds) give, bit
    for bit."""
    model = _tiny_clip(4)
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.standard_normal((3, 16, 16, 3)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(1, 63, (3, 8)))
    run = (lambda: model.encode_image(images)) if tower == "image" else (
        lambda: model.encode_text(tokens))
    calls = []
    routed = tg.tower_linear

    def counting(*args, **kw):
        calls.append(args[3] if len(args) > 3 else kw.get("epilogue", "bias"))
        return routed(*args, **kw)

    monkeypatch.setattr(tclip, "tower_linear", counting)
    with torch.no_grad():
        got = run()
        for module in model.modules():
            if hasattr(module, "tower_gemm"):
                module.tower_gemm = False
        want = run()
    if tower == "image":
        assert calls == ["qkv", "residual", "gelu", "residual"] * 2
    else:
        assert calls == []
    assert torch.equal(got, want)
