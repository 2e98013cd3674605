"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: every test skips where torch sees no GPU.  On a machine with
one (and nvcc), run them with

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(`--noconftest` because tests/conftest.py sets up JAX, which this file does
not use).  The shapes here are the edge cases of each kernel (ragged tiles,
no-hit rows, fully masked rows, every template instance); chip_smoke.py
covers the eval forward's own shapes.  Indices and gathers must be bit-equal
to the plain versions and the numpy golden models; both attention kernels
agree within ATTN_TOL (fp32, summed in another order than cuBLAS).
"""

import numpy as np
import pytest
import torch

from coda_neurips2023_tpu_torch import _kernels
from coda_neurips2023_tpu_torch.ops.grouping import (
    ball_query,
    ball_query_plain,
    group_points,
    group_points_plain,
)
from coda_neurips2023_tpu_torch.ops.masked_attention import masked_attention, masked_attention_plain
from coda_neurips2023_tpu_torch.ops.sampling import furthest_point_sample, furthest_point_sample_plain
from coda_neurips2023_tpu_torch.ops.vit_attention import vit_attention, vit_attention_plain

from golden import ball_query_golden, fps_golden

pytestmark = pytest.mark.cuda

ATTN_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pc(seed, b, n, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((b, n, 3)) * scale).astype(np.float32)


@pytest.mark.parametrize("n,npoint", [(1, 4), (5, 8), (1000, 64), (1025, 100), (4100, 256),
                                      (9000, 128), (17000, 64), (20000, 64), (33000, 32),
                                      (40960, 16)])
def test_fps_kernel(dev, n, npoint):
    xyz = _pc(n, 2, n)
    xyz[0, 3:50] = 0.0  # invalid points
    xyz[1] = np.round(xyz[1] * 2) / 2  # exact ties
    t = torch.from_numpy(xyz).to(dev)
    got = furthest_point_sample(t, npoint)
    np.testing.assert_array_equal(got.cpu().numpy(), furthest_point_sample_plain(t, npoint).cpu().numpy())
    if n <= 1025:
        np.testing.assert_array_equal(got.cpu().numpy(), fps_golden(xyz, npoint))


@pytest.mark.parametrize("n,m,radius,k,scale", [(300, 33, 0.5, 8, 0.25), (300, 17, 0.15, 8, 1.0),
                                                (260, 19, 0.4, 64, 0.3), (33, 10, 2.0, 64, 1.0),
                                                (2048, 512, 0.4, 32, 1.0), (5000, 300, 0.2, 64, 0.5)])
def test_ball_query_kernel(dev, n, m, radius, k, scale):
    xyz = _pc(m, 2, n, scale)
    new_xyz = np.concatenate([xyz[:, : m - 2], np.full((2, 2, 3), 50.0, np.float32)], axis=1)
    a, b = torch.from_numpy(xyz).to(dev), torch.from_numpy(new_xyz).to(dev)
    got = ball_query(radius, k, a, b)
    np.testing.assert_array_equal(got.cpu().numpy(), ball_query_plain(radius, k, a, b).cpu().numpy())
    if n * m <= 20000:
        np.testing.assert_array_equal(got.cpu().numpy(), ball_query_golden(radius, k, xyz, new_xyz))


@pytest.mark.parametrize("c", [1, 3, 5])
def test_gather_kernel(dev, c):
    rng = np.random.default_rng(c)
    feats = torch.from_numpy(rng.standard_normal((3, 777, c)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 777, (3, 50, 7)).astype(np.int32)).to(dev)
    assert torch.equal(group_points(feats, idx), group_points_plain(feats, idx))


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,skv", [(64, 64), (70, 130), (5, 200)])
@pytest.mark.parametrize("radius", [0.0, 0.5])
def test_attention_kernel(dev, d, sq, skv, radius):
    g = torch.Generator(device=dev).manual_seed(d + sq + skv)
    q = torch.randn((2, 3, sq, d), device=dev, generator=g) / d ** 0.5
    k = torch.randn((2, 3, d, skv), device=dev, generator=g)
    v = torch.randn((2, 3, skv, d), device=dev, generator=g)
    kxyz = torch.rand((2, skv, 3), device=dev, generator=g) * 2 - 1
    qxyz = torch.rand((2, sq, 3), device=dev, generator=g) * 2 - 1
    qxyz[:, 0] = 100.0  # no allowed key when masked: a uniform row
    kxyz_t = kxyz.transpose(1, 2).contiguous()
    args = (q, k, v, qxyz, kxyz_t, radius)
    err = (masked_attention(*args) - masked_attention_plain(*args)).abs().max().item()
    assert err <= ATTN_TOL


def _qkv(dev, shape, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, device=dev, generator=g) for _ in range(3)]


@pytest.mark.parametrize("h", [1, 12])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", [1, 50, 197])
def test_vit_attention_kernel(dev, s, d, h):
    q, k, v = _qkv(dev, (3, h, s, d), s + d + h)
    got = vit_attention(q, k, v)
    assert got.shape == q.shape
    err = (got - vit_attention_plain(q, k, v)).abs().max().item()
    assert err <= ATTN_TOL
    if s == 1:  # one key: the output is v
        assert torch.equal(got, v)


@pytest.mark.parametrize("d,s_max", [(32, 388), (64, 256)])
def test_vit_attention_longest_sequence(dev, d, s_max):
    """The whole K and V of a head sit in shared memory: the longest S that
    fits runs, one more is refused before launch."""
    q, k, v = _qkv(dev, (2, 2, s_max, d), d)
    assert (vit_attention(q, k, v) - vit_attention_plain(q, k, v)).abs().max().item() <= ATTN_TOL
    q, k, v = _qkv(dev, (1, 1, s_max + 1, d), d)
    with pytest.raises(ValueError):
        vit_attention(q, k, v)


def test_vit_attention_refusals(dev):
    q, k, v = _qkv(dev, (2, 3, 197, 64), 0)
    with pytest.raises(ValueError):  # not contiguous
        vit_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError):  # not fp32
        vit_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):  # head width without a kernel instance
        vit_attention(*_qkv(dev, (2, 3, 197, 16), 1))
    flat = torch.randn(2 * 3 * 197 * 64 + 1, device=dev)
    with pytest.raises(ValueError):  # contiguous but not 16-byte aligned
        vit_attention(flat[1:].view(2, 3, 197, 64), k, v)
    with pytest.raises(RuntimeError):  # the kernels are forward only
        vit_attention(q.clone().requires_grad_(), k, v)


def test_launch_counts_and_refusals(dev):
    _kernels.reset_launches()
    xyz = torch.from_numpy(_pc(0, 2, 500)).to(dev)
    inds = furthest_point_sample(xyz, 32)
    idx = ball_query(0.5, 8, xyz, group_points(xyz, inds[:, None, :])[:, 0])
    q = torch.randn((1, 2, 16, 32), device=dev)
    masked_attention(q, torch.randn((1, 2, 32, 16), device=dev), torch.randn((1, 2, 16, 32), device=dev))
    vit_attention(q, torch.randn((1, 2, 16, 32), device=dev), torch.randn((1, 2, 16, 32), device=dev))
    assert idx.dtype == torch.int32
    assert _kernels.LAUNCHES == {"fps": 1, "ball_query": 1, "gather": 1, "attention": 1,
                                 "vit_attention": 1}
    with pytest.raises(RuntimeError):
        furthest_point_sample(xyz.clone().requires_grad_(), 4)
    with pytest.raises(ValueError):  # head width without a kernel instance
        masked_attention(*(torch.zeros((1, 1, 8, 8), device=dev),) * 3)
    with pytest.raises(ValueError):
        group_points(xyz[:, ::2], idx)  # not contiguous
