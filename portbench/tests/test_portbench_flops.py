"""The yardstick's counters against hand counts and against PyTorch's own
FLOP counter on the reference at a small size."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops


def test_attention_cost_by_hand():
    # (B, H, Sq, Skv, D) = (2, 3, 5, 7, 4): QK and PV, 2 * 2*3*5*7*4 each
    f, b = flops.attention_cost(2, 3, 5, 7, 4)
    assert f == 2 * (2 * 2 * 3 * 5 * 7 * 4)
    assert b == 4 * 2 * 3 * (5 * 4 + 7 * 4 + 7 * 4 + 5 * 4)
    assert flops.least_seconds(f, b) == max(f / 495e12, b / 3.35e12)


def test_tower_by_hand():
    w = {"resolution": 32, "patch": 16, "width": 8, "layers": 1, "embed_dim": 4}
    s, d = 5, 8  # 4 patches and the class token
    attn = 2 * s * d * d * 4 + 4 * s * s * d  # q, k, v, out projections; QK and PV
    mlp = 2 * s * (d * 4 * d) * 2
    assert flops.tower_forward(w) == 2 * 4 * 3 * 256 * d + attn + mlp + 2 * d * 4


def _count(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_tower_against_counter():
    from portbench.reference.models.clip import VisionTransformer

    vit = VisionTransformer(input_resolution=64, patch_size=16, width=64, layers=2, heads=4,
                            output_dim=32)
    x = torch.randn(3, 64, 64, 3)
    counted = _count(lambda: vit(x))
    want = 3 * flops.tower_forward({"resolution": 64, "patch": 16, "width": 64, "layers": 2,
                                    "embed_dim": 32})
    assert want <= counted <= 1.001 * want


@pytest.mark.parametrize("text_head", [True, False])
def test_detector_against_counter(text_head):
    from portbench.reference.datasets.config import SunrgbdAnonymousConfig
    from portbench.reference.models.model_3detr import CoDA3DETR

    w = dict(preenc_npoints=64, nsample=64, in_channels=3, enc_dim=32, enc_nlayers=2,
             enc_ffn_dim=16, dec_dim=64, dec_nlayers=2, dec_ffn_dim=32, nqueries=16)
    cfg = SunrgbdAnonymousConfig()
    model = CoDA3DETR(cfg, enc_dim=32, dec_dim=64, enc_nlayers=2, enc_ffn_dim=16,
                      dec_nlayers=2, dec_ffn_dim=32, preenc_npoints=64, nqueries=16,
                      with_text_head=text_head, device="cpu").eval()
    pc = torch.rand(2, 1024, 3) * 4
    batch = {"point_clouds": pc, "point_cloud_dims_min": pc.amin(1),
             "point_cloud_dims_max": pc.amax(1)}
    counted = _count(lambda: model(batch))
    heads = [2, 3, 3, 12, 12] + ([512] if text_head else [])
    want = 2 * flops.detector_forward(dict(w, heads=heads))
    # the count leaves out the small products (position embeddings, box
    # corners' rotations), so it is a floor within a few per cent
    assert want <= counted <= 1.05 * want, (want, counted)
