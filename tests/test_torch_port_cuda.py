"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: every test skips where torch sees no GPU.  On a machine with
one (and nvcc), run them with

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(`--noconftest` because tests/conftest.py sets up JAX, which this file does
not use).  The shapes here are the edge cases of each kernel (ragged tiles,
no-hit rows, fully masked rows, every template instance); chip_smoke.py
covers the eval and training paths' own shapes.  Indices and gathers must be
bit-equal to the plain versions and the numpy golden models (kernel F also
to kernel B followed by kernel C, kernel G also to kernel B; the grid build,
with G's centre order, also to its plain version); both attention kernels agree within
ATTN_TOL (fp32, summed in another order than cuBLAS), and so do D's
gradients through its autograd Function and the gather's scatter-add
backward with autograd of the plain versions.  The bf16 kernels D-bf16 and
E-bf16 agree with their plain bf16 versions within `bf16_bound`: both round
p to bf16 at the same place, so they differ only where a p lies at a
rounding boundary (their exp and sums differ in the last fp32 bits), by one
bf16 ulp of that p, at most 2^-7 of it: at most 2^-7 sum_j p_j |v_j| before
the output's rounding, which adds one bf16 ulp of the row's largest
magnitude.  The crop kernel sums as the plain crop does on the card (the
einsums in sequence, the normaliser and row sums in torch.sum's order), so
its integers equal the plain crop's; the test allows 1 apart where the plain
sum lies within 1e-3 of a half, where another order of the sums (another
PyTorch) would decide the rounding.  Where they agree, its normalised values
are bit-equal to the plain normalisation.  The plain path runs on the card:
there PyTorch divides by a Python number as a product with its reciprocal, as
the kernel does, and on the CPU truly.  Kernel H (the image tower's linear
layers) agrees with F.linear and the same epilogue within TOWER_TOL of the
output's largest value: its 3xTF32 products, promoted into fp32 sums once a
stage, are summed in another order than cuBLAS's, each within about 1e-6.
"""

import numpy as np
import pytest
import torch

from coda_neurips2023_tpu_torch import _kernels
from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset, make_batch
from coda_neurips2023_tpu_torch.models import distillation as dist
from coda_neurips2023_tpu_torch.models.clip import CLIP, init_clip_parameters
from coda_neurips2023_tpu_torch.ops.grouping import (
    GRID_LAUNCHES,
    GRID_MAX_SAMPLES,
    TILE_LAUNCHES,
    TILE_MAX_SAMPLES,
    TILE_SIZES,
    _cell_coord,
    ball_query,
    ball_query_group,
    ball_query_group_plain,
    ball_query_plain,
    ball_query_tile,
    grid_build,
    grid_cap,
    grid_params_plain,
    grid_query,
    grid_side,
    group_points,
    group_points_plain,
    query_and_group,
    tile_order_plain,
    tile_query,
)
from coda_neurips2023_tpu_torch.ops.masked_attention import (
    _bf16_scores,
    attention_splits,
    masked_attention,
    masked_attention_plain,
    masked_attention_split_plain,
)
from coda_neurips2023_tpu_torch.ops.sampling import (
    FPS_CLUSTER_SIZES,
    _fps_kernel,
    furthest_point_sample,
    furthest_point_sample_plain,
)
from coda_neurips2023_tpu_torch.ops.tower_gemm import tower_linear, tower_linear_plain
from coda_neurips2023_tpu_torch.ops.vit_attention import (
    max_sequence,
    vit_attention,
    vit_attention_plain,
)
from coda_neurips2023_tpu_torch.utils.device import multi_processor_count

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
@pytest.mark.parametrize("b", [2, 8, 32])
def test_fps_kernel(dev, b, n, npoint):
    """At the cluster size the policy picks for b scenes on this card."""
    xyz = _pc(n, b, n)
    xyz[0, 3:50] = 0.0  # invalid points
    xyz[1] = np.round(xyz[1] * 2) / 2  # exact ties
    t = torch.from_numpy(xyz).to(dev)
    got = furthest_point_sample(t, npoint)
    np.testing.assert_array_equal(got.cpu().numpy(), furthest_point_sample_plain(t, npoint).cpu().numpy())
    if n <= 1025:
        np.testing.assert_array_equal(got.cpu().numpy(), fps_golden(xyz, npoint))


# ScanNet's 40,000 points at every cluster size that holds them, and a
# cluster of one block at 20,000 (40 points a thread, the most it takes)
@pytest.mark.parametrize("n,cs", [(20000, 1), (40000, 2), (40000, 4), (40000, 8)])
@pytest.mark.parametrize("b", [8, 32])
def test_fps_kernel_every_cluster_size(dev, b, n, cs):
    """Every cluster size the policy can pick, with invalid points (index 0
    among them) and exact ties across the slices' boundaries."""
    assert cs in FPS_CLUSTER_SIZES
    xyz = _pc(cs, b, n)
    xyz[:, 0] = 0.0
    xyz[:, 4990:5010] = 0.0
    xyz[1] = np.round(xyz[1] * 2) / 2
    for src, dst in ((7, 5000), (11, 10000), (13, n - 4997)):
        xyz[:, dst] = xyz[:, src]
    t = torch.from_numpy(xyz).to(dev)
    _kernels.reset_launches()
    got = _fps_kernel(t, 300, cs)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["fps"] == 1
    assert torch.equal(got, furthest_point_sample_plain(t, 300))


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


# N < K, rows with no hit, K = 1, M not a multiple of the 8 centres a block
@pytest.mark.parametrize("n,m,radius,k,scale", [(5, 16, 2.0, 64, 1.0), (300, 17, 0.15, 8, 1.0),
                                                (300, 33, 0.5, 1, 0.25), (2048, 509, 0.4, 32, 1.0),
                                                (20000, 203, 0.2, 64, 1.0)])
def test_ball_query_group_kernel(dev, n, m, radius, k, scale):
    xyz = _pc(m + 1, 2, n, scale)
    new_xyz = np.concatenate([_pc(m + 2, 2, m - 2, scale), np.full((2, 2, 3), 50.0, np.float32)],
                             axis=1)
    a, b = torch.from_numpy(xyz).to(dev), torch.from_numpy(new_xyz).to(dev)
    idx, grouped = ball_query_group(radius, k, a, b)
    want_idx, want_grouped = ball_query_group_plain(radius, k, a, b)
    assert torch.equal(idx, want_idx) and torch.equal(grouped, want_grouped)
    via_b = ball_query(radius, k, a, b)
    assert torch.equal(idx, via_b) and torch.equal(grouped, group_points(a, via_b))
    assert torch.equal(idx[:, -2:], torch.zeros_like(idx[:, -2:]))  # no hit: point 0
    assert torch.equal(grouped[:, -2:], a[:, None, None, 0].expand(2, 2, k, 3))
    if n * m <= 20000:
        np.testing.assert_array_equal(idx.cpu().numpy(), ball_query_golden(radius, k, xyz, new_xyz))


def _degenerate(case, n, m):
    """A wall (a third of the points on one z) or a dense clump (every point
    within 1 cm of the origin, hits >> k), with two far centres."""
    xyz = _pc(n, 2, n, 1.0)
    if case == "plane":
        xyz[:, : n // 3, 2] = 0.25
    else:
        xyz *= 0.01
    ctr = np.concatenate([xyz[:, : m - 2], np.full((2, 2, 3), 50.0, np.float32)], axis=1)
    return xyz, np.ascontiguousarray(ctr)


@pytest.mark.parametrize("case,n,m,radius,k", [("plane", 5000, 300, 0.2, 64),
                                               ("plane", 20000, 256, 0.2, 64),
                                               ("clump", 300, 40, 0.2, 16),
                                               ("clump", 5000, 100, 0.2, 64),
                                               ("clump", 4000, 50, 0.5, 1000),
                                               ("clump", 9000, 6, 0.5, GRID_MAX_SAMPLES)])
def test_ball_query_grid_degenerate(dev, case, n, m, radius, k):
    """B and F on a wall and on a clump of thousands of hits a centre (the
    warp keeps its k smallest indices in passes): bit-equal to the plain
    versions, F also to B then C."""
    xyz, ctr = _degenerate(case, n, m)
    a, b = torch.from_numpy(xyz).to(dev), torch.from_numpy(ctr).to(dev)
    got = ball_query(radius, k, a, b)
    assert torch.equal(got, ball_query_plain(radius, k, a, b))
    idx, grouped = ball_query_group(radius, k, a, b)
    assert torch.equal(idx, got) and torch.equal(grouped, group_points_plain(a, got))
    assert torch.equal(got[:, -2:], torch.zeros_like(got[:, -2:]))


@pytest.mark.parametrize("side_factor", [1.0, 1.5, 2.0])
@pytest.mark.parametrize("case", ["scene", "plane", "outlier"])
def test_grid_build_matches_plain(dev, case, side_factor):
    """The build's side, corner and cells equal the plain version's, its
    points are ordered by (cell, original index), and each cell's first slot
    is right; the query at that side equals the plain ball query."""
    xyz = _pc(7, 3, 3000, 1.0)
    if case == "plane":
        xyz[:, :1000, 2] = 0.25
    elif case == "outlier":
        xyz[1, 17] = (1e4, -1e4, 3.0)
    t = torch.from_numpy(xyz).to(dev)
    pts, starts, fparams, iparams = grid_build(0.2, t, side_factor)
    lo, inv, dims = grid_params_plain(t, grid_side(0.2, side_factor), grid_cap(3000))
    assert torch.equal(fparams[:, :3], lo) and torch.equal(fparams[:, 3], inv)
    assert torch.equal(iparams[:, :3].long(), dims) and torch.equal(iparams[:, 3].long(), dims.prod(-1))
    cc = _cell_coord(t, lo[:, None], inv[:, None, None], dims[:, None])
    cells = (cc[..., 2] * dims[:, None, 1] + cc[..., 1]) * dims[:, None, 0] + cc[..., 0]
    scells, perm = torch.sort(cells, dim=1, stable=True)
    assert torch.equal(pts[..., 3].view(torch.int32).long(), perm)
    assert torch.equal(pts[..., :3], torch.gather(t, 1, perm[..., None].expand(-1, -1, 3)))
    for bi in range(3):
        nc = int(dims[bi].prod())
        want = torch.searchsorted(scells[bi], torch.arange(nc + 1, device=dev))
        assert torch.equal(starts[bi, : nc + 1].long(), want)
    ctr = t[:, ::10].contiguous()
    assert torch.equal(grid_query(0.2, 64, t, ctr, side_factor=side_factor),
                       ball_query_plain(0.2, 64, t, ctr))


def test_ball_query_never_scans(dev):
    """No size or data setting reaches a scan of the scene: every call of B
    at N from 1 to 40,000, k from 1 to 1000, sparse, dense and degenerate
    scenes launches the grid build and query (GRID_LAUNCHES) and nothing
    else, and the kernel library has no scan entry point left."""
    lib = _kernels.library()
    assert not hasattr(lib, "bq_scan") and not hasattr(lib, "coda_ball_query_scan")
    for n, k, scale in ((1, 8, 1.0), (300, 1, 0.25), (2048, 32, 1.0), (5000, 200, 0.05),
                        (20000, 64, 3.0), (40000, 64, 0.001), (4096, 1000, 1.0)):
        a = torch.from_numpy(_pc(n + 3, 1, n, scale)).to(dev)
        c = a[:, : min(n, 64)].contiguous()
        _kernels.reset_launches()
        got = ball_query(0.2, k, a, c)
        assert _kernels.LAUNCHES == dict.fromkeys(_kernels.LAUNCHES, 0) | {"ball_query": GRID_LAUNCHES}
        assert torch.equal(got, ball_query_plain(0.2, k, a, c))
    with pytest.raises(ValueError):  # beyond the query's buffer: refused, not scanned
        a = torch.zeros((1, GRID_MAX_SAMPLES + 40, 3), device=dev)
        ball_query(0.2, GRID_MAX_SAMPLES + 33, a, a[:, :4].contiguous())
    with pytest.raises(ValueError):
        ball_query(0.2, 8, torch.zeros((1, 0, 3), device=dev), torch.zeros((1, 4, 3), device=dev))


def _check_tile(a, b, radius, k):
    got = ball_query_tile(radius, k, a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, ball_query_plain(radius, k, a, b))
    assert torch.equal(got, _kernel_b(radius, k, a, b))
    return got


def _kernel_b(radius, k, a, b):
    from coda_neurips2023_tpu_torch.ops.grouping import _launch_ball_query

    return _launch_ball_query("coda_ball_query", radius, k, a, b)


# k below, at and above a warp, and the SA's 64; N = 1; N one past a stage
# of 512 and past the old G's chunk of 2048; M not a multiple of a tile
@pytest.mark.parametrize("n,m,radius,k,scale", [(300, 70, 0.5, 1, 0.25), (300, 70, 0.5, 31, 0.25),
                                                (300, 70, 0.5, 32, 0.25), (300, 70, 0.5, 33, 0.25),
                                                (2049, 129, 0.4, 64, 0.3), (1, 5, 1.0, 64, 1.0),
                                                (2049, 64, 0.2, 32, 1.0), (20000, 200, 0.2, 64, 1.0)])
def test_ball_query_tile_kernel(dev, n, m, radius, k, scale):
    xyz = _pc(n + 7, 2, n, scale)
    new_xyz = np.concatenate([xyz[:, : min(m, n)], _pc(m, 2, max(m - n, 0), scale)], axis=1)
    new_xyz[:, -1] = 50.0  # no hit
    a, b = torch.from_numpy(xyz).to(dev), torch.from_numpy(np.ascontiguousarray(new_xyz)).to(dev)
    got = _check_tile(a, b, radius, k)
    assert torch.equal(got[:, -1], torch.zeros_like(got[:, -1]))
    if n * m <= 40000:
        np.testing.assert_array_equal(got.cpu().numpy(), ball_query_golden(radius, k, xyz, new_xyz))


def test_ball_query_tile_all_miss_and_unfilled_centre(dev):
    """A scene where no centre has a hit (every row zeros), and a tile whose
    centres all fill from a dense clump but one, whose only hit is the last
    point of the scene, far from the clump: nothing stops a tile early."""
    n, m, k = 5000, 64, 16
    xyz = _pc(3, 1, n, 0.01)  # a dense clump at the origin
    far = np.full((1, m, 3), 50.0, np.float32)
    a = torch.from_numpy(xyz).to(dev)
    got = _check_tile(a, torch.from_numpy(far).to(dev), 0.1, k)
    assert not got.any()
    xyz[0, -1] = (9.0, 9.0, 9.0)
    ctr = np.zeros((1, m, 3), np.float32)
    ctr[0, 37] = (9.0, 9.0, 9.05)  # hits only the last point
    a = torch.from_numpy(xyz).to(dev)
    got = _check_tile(a, torch.from_numpy(ctr).to(dev), 0.1, k)
    assert torch.equal(got[0, 37], torch.full((k,), n - 1, dtype=torch.int32, device=dev))
    assert (got[0, :37] < 2048).all()


@pytest.mark.parametrize("case,n,m,k", [("clump", 9000, 40, 64), ("clump", 9000, 6, TILE_MAX_SAMPLES),
                                        ("clump", 4000, 50, 33), ("plane", 20000, 256, 64)])
def test_ball_query_tile_degenerate(dev, case, n, m, k):
    """G on a clump of thousands of hits a centre (more than twice k: the
    buffer keeps its k smallest indices in passes) and on a wall: bit-equal
    to the plain version and to kernel B."""
    xyz, ctr = _degenerate(case, n, m)
    a, b = torch.from_numpy(xyz).to(dev), torch.from_numpy(ctr).to(dev)
    got = _check_tile(a, b, 0.5 if case == "clump" else 0.2, k)
    assert torch.equal(got[:, -2:], torch.zeros_like(got[:, -2:]))


def _scenes(dev):
    """A synthetic-like scene (boxes of points in a room), a wall of a third
    of it, and a uniform cloud: (name, xyz (4, 6000, 3))."""
    rng = np.random.default_rng(41)
    room = rng.uniform((-4, -4, 0), (4, 4, 3), (4, 6000, 3)).astype(np.float32)
    room[:, :3000] = (rng.uniform(-3, 3, (4, 6, 1, 3)) + rng.uniform(-0.4, 0.4, (4, 6, 500, 3))
                      ).reshape(4, 3000, 3).astype(np.float32)
    plane = room.copy()
    plane[:, :2000, 2] = 1.0
    uniform = rng.uniform((-4, -4, 0), (4, 4, 3), (4, 6000, 3)).astype(np.float32)
    return [(name, torch.from_numpy(x).to(dev)) for name, x in
            (("scene", room), ("plane", plane), ("uniform", uniform))]


def test_ball_query_tile_fps_centres_every_tile(dev):
    """Centres in furthest-point order (far apart, not spatially sorted) on a
    scene, a wall and a uniform cloud: G at every tile size and at sides 1
    and 1.5 equals kernel B and the plain version; k = 32 and 64."""
    for name, x in _scenes(dev):
        c = group_points(x, furthest_point_sample(x, 700)[:, None, :])[:, 0]
        for k in (32, 64):
            want = ball_query_plain(0.2, k, x, c)
            assert torch.equal(_kernel_b(0.2, k, x, c), want), name
            for tile in TILE_SIZES:
                for side in (1.0, 1.5):
                    assert torch.equal(tile_query(0.2, k, x, c, tile, side), want), (name, tile, side)


def test_tile_build_order_matches_plain(dev):
    """The build with centres: the points' grid as without them, and each
    scene's centres, with their rows, in the plain version's order (Morton
    key, index)."""
    for _, x in _scenes(dev):
        c = x[:, ::9].contiguous()
        pts, starts, fparams, iparams, ctr = grid_build(0.2, x, 1.0, centres=c)
        grid = grid_build(0.2, x, 1.0)
        assert all(torch.equal(u, v) for u, v in zip((pts, fparams, iparams), grid[:1] + grid[2:]))
        for bi in range(x.shape[0]):  # a scene's starts past its cells are not written
            cells = int(iparams[bi, 3]) + 1
            assert torch.equal(starts[bi, :cells], grid[1][bi, :cells])
        b, m = c.shape[:2]
        order = tile_order_plain(0.2, x, c)
        rows = order + m * torch.arange(b, device=dev)[:, None]
        assert torch.equal(ctr[..., 3].view(torch.int32).long(), rows)
        assert torch.equal(ctr[..., :3], torch.gather(c, 1, order[..., None].expand(-1, -1, 3)))


def test_ball_query_tile_refusals(dev):
    """G refuses, and launches nothing for, k above its cap, N = 0, a tile
    it is not built for and inputs needing a gradient; nothing falls back."""
    a = torch.from_numpy(_pc(5, 1, TILE_MAX_SAMPLES + 40, 1.0)).to(dev)
    c = a[:, :4].contiguous()
    _kernels.reset_launches()
    for call in (lambda: ball_query_tile(0.2, TILE_MAX_SAMPLES + 1, a, c),
                 lambda: ball_query_tile(0.2, 8, a[:, :0].contiguous(), c),
                 lambda: tile_query(0.2, 8, a, c, tile=24)):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(RuntimeError):
        ball_query_tile(0.2, 8, a.clone().requires_grad_(), c)
    assert not any(_kernels.LAUNCHES.values())
    assert torch.equal(ball_query_tile(0.2, TILE_MAX_SAMPLES, a, c),
                       ball_query_plain(0.2, TILE_MAX_SAMPLES, a, c))


def test_ball_query_dispatch_launches(dev, monkeypatch):
    """Each setting of the environment launches the kernel the JAX package's
    choice maps to, and nothing else; a mistyped algorithm raises."""
    xyz = torch.from_numpy(_pc(1, 2, 5000, 1.0)).to(dev)
    centres = xyz[:, :100].contiguous()
    for var in ("CODA_BQ_ALGO", "CODA_BQ_MXU", "CODA_BQ_FUSED_GATHER"):
        monkeypatch.delenv(var, raising=False)
    cases = [({}, 64, "ball_query"), ({"CODA_BQ_ALGO": "window"}, 64, "ball_query"),
             ({"CODA_BQ_ALGO": "adaptive"}, 64, "ball_query_tile"),
             ({"CODA_BQ_MXU": "1"}, 64, "ball_query_tile"), ({"CODA_BQ_MXU": "1"}, 32, "ball_query")]
    for env, k, name in cases:
        with monkeypatch.context() as mp:
            for var, value in env.items():
                mp.setenv(var, value)
            _kernels.reset_launches()
            got = ball_query(0.2, k, xyz, centres)
            assert {n for n, c in _kernels.LAUNCHES.items() if c} == {name}, env
            assert torch.equal(got, ball_query_plain(0.2, k, xyz, centres))
    with monkeypatch.context() as mp:
        mp.setenv("CODA_BQ_FUSED_GATHER", "1")
        _kernels.reset_launches()
        query_and_group(0.2, 64, xyz, centres)
        assert _kernels.LAUNCHES["ball_query_group"] == GRID_LAUNCHES
        assert _kernels.LAUNCHES["ball_query"] == 0
        mp.setenv("CODA_BQ_ALGO", "adaptive")
        _kernels.reset_launches()
        query_and_group(0.2, 64, xyz, centres)
        assert (_kernels.LAUNCHES["ball_query_group"] == 0
                and _kernels.LAUNCHES["ball_query_tile"] == TILE_LAUNCHES)
        mp.setenv("CODA_BQ_ALGO", "sortd")
        with pytest.raises(ValueError):
            ball_query(0.2, 64, xyz, centres)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("c", [1, 3, 4, 5, 8, 64, 256, 259])
def test_gather_kernel(dev, c, offset):
    """Every branch of kernel C: the xyz branch (C = 3), the 16-byte tile
    branch (C % 4 == 0 on aligned features) and the single-float tile branch
    (any other C, and features that start `offset` elements into their
    storage); R = 350 rows a batch row, ragged against a warp's 32."""
    rng = np.random.default_rng(c)
    feats = torch.from_numpy(rng.standard_normal((3, 777, c)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 777, (3, 50, 7)).astype(np.int32)).to(dev)
    if offset:
        storage = torch.zeros(feats.numel() + offset, device=dev)
        storage[offset:] = feats.reshape(-1)
        feats = storage[offset:].view(3, 777, c)
    assert torch.equal(group_points(feats, idx), group_points_plain(feats, idx))


def test_gather_kernel_interim_features(dev):
    """C = 256: the masked encoder's interim set abstraction gathers its
    points' encoder features (32 centres of 32 neighbours over 2048 points
    here, a scene of the path's (1024, 32) x 256 per batch row), and its
    backward sums them back."""
    rng = np.random.default_rng(256)
    feats = torch.from_numpy(rng.standard_normal((2, 2048, 256)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 2048, (2, 1024, 32)).astype(np.int32)).to(dev)
    idx[:, :, 20:] = idx[:, :, :1]  # the ball query's padding: repeated first hits
    assert torch.equal(group_points(feats, idx), group_points_plain(feats, idx))
    leaf, ref = feats.clone().requires_grad_(True), feats.clone().requires_grad_(True)
    grad = torch.randn((2, 1024, 32, 256), device=dev)
    group_points(leaf, idx).backward(grad)
    group_points_plain(ref, idx).backward(grad)
    assert (leaf.grad - ref.grad).abs().max().item() <= ATTN_TOL * grad.abs().max().item()


@pytest.mark.parametrize("r,aligned", [(128, True), (130, True), (131, False)])
def test_gather_kernel_xyz_rows(dev, r, aligned):
    """C = 3, a warp per 128 rows: R = 128 (whole warps, 16-byte index
    loads), R = 130 (a ragged last warp; every batch row but the first
    starts off 16-byte alignment), and indices and features that start one
    element into their storage; also as gather_points' (B, 1, M) indices."""
    rng = np.random.default_rng(r)
    feats = torch.from_numpy(rng.standard_normal((5, 301, 3)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 301, (5, r, 1)).astype(np.int32)).to(dev)
    if not aligned:
        f_flat = torch.zeros(feats.numel() + 1, device=dev)
        f_flat[1:] = feats.reshape(-1)
        feats = f_flat[1:].view(5, 301, 3)
        i_flat = torch.zeros(idx.numel() + 1, dtype=torch.int32, device=dev)
        i_flat[1:] = idx.reshape(-1)
        idx = i_flat[1:].view(5, r, 1)
    assert torch.equal(group_points(feats, idx), group_points_plain(feats, idx))
    assert torch.equal(group_points(feats, idx.reshape(5, 1, r)).reshape(5, r, 3),
                       group_points_plain(feats, idx).reshape(5, r, 3))


def test_gather_kernel_large_batch(dev):
    """B * R * C above 2^31 (C = 1): the batch row's offset is 64-bit, the
    offsets inside it 32-bit; checked a batch row at a time."""
    b, r = 66, 2 ** 25 + 3
    feats = torch.randn((b, 1000, 1), device=dev)
    idx = torch.randint(0, 1000, (b, 1, r), device=dev, dtype=torch.int32)
    out = group_points(feats, idx)
    for i in (0, 1, b // 2, b - 1):
        assert torch.equal(out[i:i + 1], group_points_plain(feats[i:i + 1], idx[i:i + 1]))
    del out
    with pytest.raises(ValueError):  # a batch row of 2^31 outputs or more
        group_points(torch.zeros((1, 4, 64), device=dev),
                     torch.zeros((1, 1, 2 ** 25), dtype=torch.int32, device=dev))


@pytest.mark.parametrize("b,h,d,sq,skv,radius,dropout", [
    (32, 4, 128, 128, 2048, 0.0, 0.0),  # the decoder's cross-attention
    (32, 4, 128, 128, 2048, 0.0, 0.1),
    (8, 4, 128, 128, 2048, 0.0, 0.1),   # the training step's cross-attention
    (2, 3, 16, 33, 1001, 0.5, 0.0),     # Skv odd: 4-byte copies
    (2, 3, 32, 64, 777, 0.0, 0.1),
    (2, 3, 64, 70, 1000, 0.5, 0.1),     # Skv not a multiple of the chunk
    (2, 3, 128, 5, 600, 0.5, 0.3),
])
def test_attention_split_keys(dev, b, h, d, sq, skv, radius, dropout):
    """Kernel D with the keys split across blocks and merged by the combine
    launch: within ATTN_TOL of the plain version, with the same dropout mask,
    and a row whose every key is radius-masked comes out uniform (the mean
    of v, dropped as the plain version drops it)."""
    splits, chunk = attention_splits(b, h, sq, skv, d, multi_processor_count(dev))
    assert splits > 1
    g = torch.Generator(device=dev).manual_seed(d + sq + skv)
    q = torch.randn((b, h, sq, d), device=dev, generator=g) / d ** 0.5
    k = torch.randn((b, h, d, skv), device=dev, generator=g)
    v = torch.randn((b, h, skv, d), device=dev, generator=g)
    kxyz = torch.rand((b, skv, 3), device=dev, generator=g) * 2 - 1
    qxyz = torch.rand((b, sq, 3), device=dev, generator=g) * 2 - 1
    qxyz[:, 0] = 100.0
    kxyz_t = kxyz.transpose(1, 2).contiguous()
    seed = torch.randint(0, 2 ** 62, (), device=dev, generator=g)
    args = (q, k, v, qxyz, kxyz_t, radius, "float32", dropout, seed)
    _kernels.reset_launches()
    got = masked_attention(*args)
    assert _kernels.LAUNCHES["attention"] == 2  # the chunks, then the combine
    assert (got - masked_attention_plain(*args)).abs().max().item() <= ATTN_TOL
    if radius > 0 and dropout == 0:
        assert (got[:, :, 0] - v.mean(2)).abs().max().item() <= ATTN_TOL


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


@pytest.mark.parametrize("s,radius", [(2048, 0.16), (1024, 0.64), (1024, 1.44)])
def test_attention_kernel_masked_encoder_radii(dev, s, radius):
    """Kernel D's radius mode at the masked encoder's squared radii (0.4^2,
    0.8^2, 1.2^2) on points spread like a scene's (a 6 m room), at the
    layers' token counts, in eval and with D's attention-weight dropout."""
    g = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn((2, 4, s, 64), device=dev, generator=g) / 8.0
    k = torch.randn((2, 4, 64, s), device=dev, generator=g)
    v = torch.randn((2, 4, s, 64), device=dev, generator=g)
    xyz = torch.rand((2, s, 3), device=dev, generator=g) * torch.tensor([6.0, 6.0, 3.0], device=dev)
    args = (q, k, v, xyz, xyz.transpose(1, 2).contiguous(), radius)
    err = (masked_attention(*args) - masked_attention_plain(*args)).abs().max().item()
    assert err <= ATTN_TOL
    seed = torch.tensor(11, dtype=torch.int64, device=dev)
    err = (masked_attention(*args, dropout=0.1, seed=seed)
           - masked_attention_plain(*args, dropout=0.1, seed=seed)).abs().max().item()
    assert err <= ATTN_TOL


@pytest.mark.parametrize("d,sq,skv,radius,dropout", [(64, 70, 130, 0.0, 0.0), (128, 5, 200, 0.0, 0.1),
                                                     (32, 64, 64, 0.5, 0.0), (16, 33, 65, 0.0, 0.3),
                                                     (64, 130, 200, 0.5, 0.1)])
def test_attention_backward(dev, d, sq, skv, radius, dropout):
    """dq, dk, dv through the Function (kernel forward, plain recompute) vs
    autograd of the plain version, with and without attention-weight
    dropout (the same mask from the same seed); the gather's scatter-add vs
    autograd."""
    g = torch.Generator(device=dev).manual_seed(d + sq)
    leaves = [torch.randn(s, device=dev, generator=g) for s in
              ((2, 3, sq, d), (2, 3, d, skv), (2, 3, skv, d))]
    leaves[0] = leaves[0] / d ** 0.5
    kxyz = torch.rand((2, skv, 3), device=dev, generator=g) * 2 - 1
    qxyz = kxyz[:, :sq].contiguous()
    kxyz_t = kxyz.transpose(1, 2).contiguous()
    grad_out = torch.randn((2, 3, sq, d), device=dev, generator=g)
    seed = torch.randint(0, 2 ** 62, (), device=dev, generator=g)
    a = [t.clone().requires_grad_() for t in leaves]
    b = [t.clone().requires_grad_() for t in leaves]
    out_a = masked_attention(*a, qxyz, kxyz_t, radius, dropout=dropout, seed=seed)
    out_b = masked_attention_plain(*b, qxyz, kxyz_t, radius, dropout=dropout, seed=seed)
    assert (out_a - out_b).abs().max().item() <= ATTN_TOL
    got = torch.autograd.grad(out_a, a, grad_out)
    want = torch.autograd.grad(out_b, b, grad_out)
    for x, y in zip(got, want):
        assert (x - y).abs().max().item() <= ATTN_TOL
    feats = torch.randn((2, 300, 4), device=dev, generator=g, requires_grad=True)
    idx = torch.randint(0, 300, (2, 40, 8), device=dev, generator=g, dtype=torch.int32)
    gout = torch.randn((2, 40, 8, 4), device=dev, generator=g)
    (got,) = torch.autograd.grad(group_points(feats, idx), feats, gout)
    (want,) = torch.autograd.grad(group_points_plain(feats, idx), feats, gout)
    assert (got - want).abs().max().item() <= 1e-5


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
    if s == 1:  # one key: the output is v, but for the lowest bits of v
        # that the TF32 split drops (3xTF32 keeps about 22 of fp32's 24 bits)
        assert ((got - v).abs() <= v.abs() * 2.0 ** -20).all()


@pytest.mark.parametrize("d,s_max", [(32, 400), (64, 208)])
def test_vit_attention_longest_sequence(dev, d, s_max):
    """The whole K and V of a head sit in shared memory as TF32 hi and lo
    parts: the longest S that fits runs, one more is refused before launch."""
    assert max_sequence(d) == s_max
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
    centres = group_points(xyz, inds[:, None, :])[:, 0]
    idx = ball_query(0.5, 8, xyz, centres)
    ball_query_group(0.5, 8, xyz, centres)
    ball_query_tile(0.5, 8, xyz, centres)
    q = torch.randn((1, 2, 16, 32), device=dev)
    masked_attention(q, torch.randn((1, 2, 32, 16), device=dev), torch.randn((1, 2, 16, 32), device=dev))
    vit_attention(q, torch.randn((1, 2, 16, 32), device=dev), torch.randn((1, 2, 16, 32), device=dev))
    assert idx.dtype == torch.int32
    # B, F and G: the grid build's two launches and the query
    assert _kernels.LAUNCHES == {"fps": 1, "ball_query": GRID_LAUNCHES, "gather": 1, "attention": 1,
                                 "vit_attention": 1, "ball_query_group": GRID_LAUNCHES,
                                 "ball_query_tile": TILE_LAUNCHES, "attention_bf16": 0,
                                 "vit_attention_bf16": 0, "crop": 0, "tower_gemm": 0}
    # keys split across blocks: the combine is D's second launch
    q = torch.randn((1, 1, 16, 32), device=dev)
    assert attention_splits(1, 1, 16, 1000, 32, multi_processor_count(dev))[0] > 1
    masked_attention(q, torch.randn((1, 1, 32, 1000), device=dev), torch.randn((1, 1, 1000, 32), device=dev))
    assert _kernels.LAUNCHES["attention"] == 3
    # kernel A's barrier floor is a timing, not a launch of the path
    floor_out = torch.empty((2, 32), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    assert _kernels.library().coda_fps_barrier_floor(xyz.data_ptr(), floor_out.data_ptr(), 2, 500,
                                                     32, 4, stream) == 0
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["fps"] == 1
    with pytest.raises(RuntimeError):
        furthest_point_sample(xyz.clone().requires_grad_(), 4)
    with pytest.raises(RuntimeError):  # coordinates take no gradient
        ball_query_group(0.5, 8, xyz.clone().requires_grad_(), centres)
    with pytest.raises(RuntimeError):
        ball_query_tile(0.5, 8, xyz.clone().requires_grad_(), centres)
    with pytest.raises(ValueError):  # head width without a kernel instance
        masked_attention(*(torch.zeros((1, 1, 8, 8), device=dev),) * 3)
    with pytest.raises(ValueError):
        group_points(xyz[:, ::2], idx)  # not contiguous


# ------------------------------------------------------------ the crop kernel


def _crop_rects(h, w, seed):
    """Rects on an h x w image as tests/test_torch_port_clip.py's
    _rect_cases() makes them: zero width, the whole image, tiny (upscaled),
    touching each edge, a point, random ones, and each of them grown to a
    square (--if_expand_box)."""
    rng = np.random.default_rng(seed)
    x0, y0 = rng.integers(0, w - 1, 10), rng.integers(0, h - 1, 10)
    random = np.stack([x0, y0, np.minimum(x0 + rng.integers(0, w // 2, 10), w),
                       np.minimum(y0 + rng.integers(0, h // 2, 10), h)], 1)
    fixed = [[3, 4, 3, 20], [0, 0, w, h], [10, 10, 11, 12], [0, 5, 7, h // 2], [w - 9, 2, w, 11],
             [4, 0, w // 3, 3], [5, h - 6, 25, h], [0, 0, 1, h], [w - 1, 0, w, 1], [2, 2, 2, 2]]
    rects = np.concatenate([np.array(fixed), random]).astype(np.int32)
    return np.concatenate([rects, dist.expand_box(torch.from_numpy(rects), h, w).numpy()])


@pytest.mark.parametrize("out_size", [16, 224])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("h,w", [(64, 96), (531, 730), (968, 1296)])
def test_crop_kernel(dev, h, w, dtype, out_size):
    rng = np.random.default_rng(h)
    images = rng.integers(0, 256, (2, h, w, 3)).astype(np.uint8)
    images = torch.from_numpy(images).to(dev)
    if dtype == torch.float32:  # not only integral values
        images = images.to(torch.float32) + torch.rand(images.shape, device=dev)
        images = torch.clamp(images, 0.0, 255.0)
    rects = [_crop_rects(h, w, seed) for seed in (1, 2)]
    n = len(rects[0])
    # the two scenes' rects interleaved, each with its scene index
    flat = torch.from_numpy(np.stack(rects, 1).reshape(-1, 4)).to(dev)
    scene = torch.arange(2, dtype=torch.int32, device=dev).repeat(n)
    _kernels.reset_launches()
    got_int = dist._crop_kernel(images, flat, scene, out_size, normalize=False)
    got = dist._crop_kernel(images, flat, scene, out_size, normalize=True)
    batched = dist.clip_crops(images, torch.from_numpy(np.stack(rects)).to(dev), out_size)
    assert _kernels.LAUNCHES["crop"] == 3
    torch.cuda.synchronize()
    for i in range(2):
        image = images[i].to(torch.float32)
        r = torch.from_numpy(rects[i]).to(dev)
        raw = np.clip(dist._crop_unrounded(image, r, out_size).cpu().numpy(), 0.0, 255.0)
        want = dist.crop_square_resize_white_plain(image, r, out_size).cpu().numpy()
        mine = got_int[i::2].cpu().numpy()
        boundary = np.abs(raw - np.floor(raw) - 0.5) < 1e-3
        assert boundary.mean() < 0.01
        np.testing.assert_array_equal(mine[~boundary], want[~boundary])
        assert np.abs(mine - want).max() <= 1.0
        assert (mine[0] == 255).all()  # zero width: all white
        # normalised: the plain normalisation on the card of the kernel's own
        # integers, bit for bit, and of the plain integers where they agree
        normed = got[i::2].cpu().numpy()
        np.testing.assert_array_equal(normed, dist.preprocess_crops(got_int[i::2]).cpu().numpy())
        agree = mine == want
        plain = dist.preprocess_crops(torch.from_numpy(want).to(dev)).cpu().numpy()
        np.testing.assert_array_equal(normed[agree], plain[agree])
        np.testing.assert_array_equal(batched[i * n:(i + 1) * n].cpu().numpy(), normed)


def _crop_scene_batch(dev, b, hw):
    ds = SyntheticDetectionDataset(SunrgbdAnonymousConfig(), num_scenes=b, num_points=500, seed=3,
                                   with_images=True, image_hw=hw)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(ds, 0, b).items()}
    # the ground truth as the predictions, as --if_use_gt_box takes them
    outputs = {"box_corners_xyz": batch["gt_box_corners_xyz"],
               "size_unnormalized": batch["gt_box_sizes"]}
    return batch, outputs


def test_crop_launches_and_no_host_sync(dev):
    """A crop stage is one launch a call, and the CLIP-crop eval's crops and
    tower and stage 1's targets run with no host synchronisation."""
    b = 3
    batch, outputs = _crop_scene_batch(dev, b, (64, 96))
    nq = outputs["box_corners_xyz"].shape[1]
    clip = CLIP(embed_dim=512, image_resolution=16, vision_patch_size=8, vision_width=64,
                vision_layers=1, text_width=32, text_layers=1, text_heads=2, context_length=8,
                vocab_size=64).to(dev).eval()
    init_clip_parameters(clip, torch.Generator(device=dev).manual_seed(1))
    text = torch.nn.functional.normalize(torch.randn((5, 512), device=dev), dim=-1)

    def tower(crops):
        with torch.no_grad():
            return clip.encode_image(crops)

    gen = torch.Generator(device=dev).manual_seed(0)
    sel = dist.select_distillation_boxes(gen, b, nq, 4)

    def run():
        _kernels.reset_launches()
        with torch.inference_mode():
            probs = dist.clip_crop_scores(outputs, batch, tower, text, 100.0, crop_size=16)
        eval_launches = _kernels.LAUNCHES["crop"]
        targets = dist.build_clip_distillation_targets(outputs, batch, tower, sel, crop_size=16)
        return probs, targets, eval_launches, _kernels.LAUNCHES["crop"] - eval_launches

    want = run()  # builds and warms up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got[2:] == (1, 1) == want[2:]
    assert got[0].shape == (b, nq, 5) and got[0].isfinite().all()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for key, value in want[1].items():
        torch.testing.assert_close(got[1][key], value, rtol=0, atol=0)
    # one launch for a single image's rects too, unnormalised
    _kernels.reset_launches()
    crops = dist.crop_square_resize_white(batch["input_image"][0].to(torch.float32),
                                          torch.tensor([[0, 0, 96, 64], [3, 4, 9, 5]],
                                                       dtype=torch.int32, device=dev), 16)
    assert _kernels.LAUNCHES["crop"] == 1 and crops.shape == (2, 16, 16, 3)
    # a batch of one scene (its scene index is a broadcast view before the copy)
    rects = torch.tensor([[[0, 0, 96, 64], [3, 4, 9, 5]]] * b, dtype=torch.int32, device=dev)
    assert torch.equal(dist.clip_crops(batch["input_image"][:1], rects[:1], 16),
                       dist.clip_crops(batch["input_image"], rects, 16)[:2])
    with pytest.raises(ValueError):  # int64 rects
        dist._crop_kernel(batch["input_image"], torch.zeros((1, 4), dtype=torch.int64, device=dev),
                          torch.zeros((1,), dtype=torch.int32, device=dev), 16, True)
    with pytest.raises(ValueError):  # not contiguous
        dist._crop_kernel(batch["input_image"][:, ::2], torch.zeros((1, 4), dtype=torch.int32,
                                                                     device=dev),
                          torch.zeros((1,), dtype=torch.int32, device=dev), 16, True)


# ------------------------------------------------------------ kernel H

# 3xTF32 keeps about 22 of fp32's 24 bits: the error against the plain path
# (cuBLAS in fp32) relative to the output's largest value
TOWER_TOL = 1e-5
# the image tower's layers (name, K, N, epilogue) and the text tower's widths
TOWER_SHAPES = [("qkv", 768, 2304, "qkv"), ("qkv_rows", 768, 2304, "bias"),
                ("out_proj", 768, 768, "residual"), ("c_fc", 768, 3072, "gelu"),
                ("c_proj", 3072, 768, "residual"), ("text_c_fc", 512, 2048, "gelu"),
                ("text_c_proj", 2048, 512, "residual")]


def _tower_case(dev, crops, tokens, k, n, epi, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((crops, tokens, k), device=dev, generator=gen)
    w = torch.randn((n, k), device=dev, generator=gen) * k ** -0.5
    b = torch.randn((n,), device=dev, generator=gen) * 0.02
    kw = {}
    if epi == "residual":
        kw["residual"] = torch.randn((crops, tokens, n), device=dev, generator=gen)
    if epi == "qkv":
        kw["heads"] = n // 3 // 64
    return x, w, b, kw


@pytest.mark.parametrize("name,k,n,epi", TOWER_SHAPES)
@pytest.mark.parametrize("crops,tokens", [(128, 197), (1, 197), (5, 200), (2, 3)])
def test_tower_gemm_kernel(dev, crops, tokens, name, k, n, epi):
    """Kernel H against the plain path at the tower's shapes (M = 25,216, the
    eval's per-scene call) and ragged M (197, 1,000, 6), the same output from
    two runs, one launch a call."""
    x, w, b, kw = _tower_case(dev, crops, tokens, k, n, epi, crops + k + n)
    _kernels.reset_launches()
    with torch.no_grad():
        got = tower_linear(x, w, b, epi, **kw)
        again = tower_linear(x, w, b, epi, **kw)
        want = tower_linear_plain(x, w, b, epi, **kw)
    assert _kernels.LAUNCHES["tower_gemm"] == 2
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, again)
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err <= TOWER_TOL, err


def test_tower_gemm_weight_parts_follow_the_weight(dev):
    """The TF32 parts of a weight are kept between calls and made anew when
    the weight is written in place."""
    x, w, b, _ = _tower_case(dev, 2, 197, 768, 768, "bias", 0)
    with torch.no_grad():
        first = tower_linear(x, w, b)
        w.mul_(2.0)
        second = tower_linear(x, w, b)
        want = tower_linear_plain(x, w, b)
    assert (second - want).abs().max().item() <= TOWER_TOL * want.abs().max().item()
    assert not torch.allclose(first, second)


def test_tower_gemm_refusals(dev):
    x, w, b, _ = _tower_case(dev, 2, 197, 768, 768, "bias", 1)
    with pytest.raises(ValueError):  # K not a multiple of 4
        tower_linear(x[..., :766].contiguous(), w[:, :766].contiguous(), b)
    with pytest.raises(ValueError):  # N not a multiple of 8
        tower_linear(x, w[:764].contiguous(), b[:764].contiguous())
    flat = torch.randn(x.numel() + 1, device=dev)
    with pytest.raises(ValueError):  # contiguous but not 16-byte aligned
        tower_linear(flat[1:].view(x.shape), w, b)
    with pytest.raises(ValueError):  # not fp32
        tower_linear(x.bfloat16(), w.bfloat16(), b.bfloat16())
    with pytest.raises(RuntimeError):  # forward only: no fallback that would take a gradient
        tower_linear(x.clone().requires_grad_(), w, b)


def test_clip_image_tower_takes_kernel_h(dev):
    """The fp32 image tower launches H four times a block, the text tower
    never; both agree with the towers' plain linear layers."""
    clip = CLIP(embed_dim=512, image_resolution=32, vision_patch_size=16, vision_width=768,
                vision_layers=2, text_width=512, text_layers=1, text_heads=8, context_length=8,
                vocab_size=64).to(dev).eval().requires_grad_(False)
    init_clip_parameters(clip, torch.Generator(device=dev).manual_seed(2))
    images = torch.randn((6, 32, 32, 3), device=dev)
    tokens = torch.randint(1, 63, (4, 8), device=dev)
    _kernels.reset_launches()
    with torch.no_grad():
        img = clip.encode_image(images)
        txt = clip.encode_text(tokens)
        assert _kernels.LAUNCHES["tower_gemm"] == 4 * 2
        for module in clip.modules():
            if hasattr(module, "tower_gemm"):
                module.tower_gemm = False
        img_plain = clip.encode_image(images)
        txt_plain = clip.encode_text(tokens)
    assert _kernels.LAUNCHES["tower_gemm"] == 4 * 2
    assert (img - img_plain).abs().max().item() <= 1e-4 * img_plain.abs().max().item()
    assert torch.equal(txt, txt_plain)


# ------------------------------------------------------------ bf16 kernels


def bf16_bound(p, v, want):
    """2^-7 sum_j p_j |v_j| plus one bf16 ulp of each row's largest |want|."""
    mag = want.float().abs().amax(-1, keepdim=True)
    ulp = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7), 0.0)
    return 2.0 ** -7 * torch.matmul(p, v.float().abs()) + ulp


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,skv", [(64, 64), (70, 136), (5, 200), (130, 1001), (200, 2048)])
@pytest.mark.parametrize("radius", [0.0, 0.5])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_attention_bf16_kernel(dev, d, sq, skv, radius, out_dtype):
    """Every template instance; Sq not a multiple of the 64 rows of a
    warpgroup (70, 5, 130); Skv ending inside a TMA key tile (136, 200,
    1001), and not a multiple of 8 (1001: K^T and the key coordinates padded
    to 1008 keys a row); many tiles through the ring of stages (2048), split
    across blocks where the policy splits them (1001, 2048 at 2 x 3 heads);
    a fully masked row, under the allowed bits of pass 0; bf16 and fp32
    outputs (fp32 inputs are rounded to bf16 first).  Against the plain
    version of the kernel's own split."""
    g = torch.Generator(device=dev).manual_seed(d + sq + skv)
    q = (torch.randn((2, 3, sq, d), device=dev, generator=g) / d ** 0.5).to(out_dtype)
    k = torch.randn((2, 3, d, skv), device=dev, generator=g).to(out_dtype)
    v = torch.randn((2, 3, skv, d), device=dev, generator=g).to(out_dtype)
    kxyz = torch.rand((2, skv, 3), device=dev, generator=g) * 2 - 1
    qxyz = torch.rand((2, sq, 3), device=dev, generator=g) * 2 - 1
    qxyz[:, 0] = 100.0  # no allowed key when masked: a uniform row
    kxyz_t = kxyz.transpose(1, 2).contiguous()
    args = (q, k, v, qxyz, kxyz_t, radius, "bfloat16")
    _kernels.reset_launches()
    got = masked_attention(*args)
    splits, chunk = attention_splits(2, 3, sq, skv, d, multi_processor_count(dev), bf16=True)
    assert got.dtype == out_dtype and _kernels.LAUNCHES["attention_bf16"] == 1 + (splits > 1)
    assert _kernels.LAUNCHES["attention"] == 0
    want = (masked_attention_split_plain(*args[:6], chunk, "bfloat16") if splits > 1
            else masked_attention_plain(*args))
    p = torch.softmax(_bf16_scores(q, k, qxyz, kxyz_t, radius), dim=-1)
    assert ((got.float() - want.float()).abs() <= bf16_bound(p, v.to(torch.bfloat16), want)).all()


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_attention_bf16_split_keys(dev, out_dtype):
    """The decoder's shape cut to 2 scenes: the keys split across blocks,
    each chunk's partials, then the combine (counted under attention_bf16),
    against the plain version of the same split."""
    b, h, sq, skv, d = 2, 4, 128, 2000, 128
    splits, chunk = attention_splits(b, h, sq, skv, d, multi_processor_count(dev), bf16=True)
    assert splits > 1
    g = torch.Generator(device=dev).manual_seed(7)
    q = (torch.randn((b, h, sq, d), device=dev, generator=g) / d ** 0.5).to(out_dtype)
    k = torch.randn((b, h, d, skv), device=dev, generator=g).to(out_dtype)
    v = torch.randn((b, h, skv, d), device=dev, generator=g).to(out_dtype)
    _kernels.reset_launches()
    got = masked_attention(q, k, v, None, None, 0.0, "bfloat16")
    assert _kernels.LAUNCHES["attention_bf16"] == 2 and got.dtype == out_dtype
    want = masked_attention_split_plain(q, k, v, None, None, 0.0, chunk, "bfloat16")
    p = torch.softmax(_bf16_scores(q, k, None, None, 0.0), dim=-1)
    assert ((got.float() - want.float()).abs() <= bf16_bound(p, v.to(torch.bfloat16), want)).all()


@pytest.mark.parametrize("h", [1, 12])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", [1, 50, 197, 256, 300])
def test_vit_attention_bf16_kernel(dev, s, d, h):
    """The one-pass branch (S <= 208 and S <= 256, its two instances) and
    the two-pass one (S = 300)."""
    q, k, v = (t.to(torch.bfloat16) for t in _qkv(dev, (3, h, s, d), s + d + h))
    _kernels.reset_launches()
    got = vit_attention(q, k, v)
    assert got.dtype == torch.bfloat16 and _kernels.LAUNCHES["vit_attention_bf16"] == 1
    want = vit_attention_plain(q, k, v)
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) / d ** 0.5, dim=-1)
    assert ((got.float() - want.float()).abs() <= bf16_bound(p, v, want)).all()
    if s == 1:  # one key: p = 1 exactly and the output is v
        assert torch.equal(got, v)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", [1, 16, 33, 48, 100, 197])
def test_vit_attention_bf16_persistent_blocks(dev, s, d):
    """40 crops x 12 heads: more heads than persistent blocks, so each block
    walks over several heads (at least 3), two buffers in turn.  At S <= 112
    a head has fewer 16-row tiles than the block has warps, so a warp holds
    tiles of only some of the heads and still waits on every head's
    buffer."""
    q, k, v = (t.to(torch.bfloat16) for t in _qkv(dev, (40, 12, s, d), d + 40 + s))
    assert 40 * 12 > 2 * multi_processor_count(dev)
    got = vit_attention(q, k, v)
    want = vit_attention_plain(q, k, v)
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) / d ** 0.5, dim=-1)
    assert ((got.float() - want.float()).abs() <= bf16_bound(p, v, want)).all()
    if s == 1:  # one key: p = 1 exactly and the output is v
        assert torch.equal(got, v)


@pytest.mark.parametrize("d,s_max", [(32, 1440), (64, 800)])
def test_vit_attention_bf16_longest_sequence(dev, d, s_max):
    """K and V of a head sit in shared memory as bf16: the longest S that
    fits runs, one more is refused before launch."""
    assert max_sequence(d, torch.bfloat16) == s_max
    q, k, v = (t.to(torch.bfloat16) for t in _qkv(dev, (1, 2, s_max, d), d))
    want = vit_attention_plain(q, k, v)
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) / d ** 0.5, dim=-1)
    assert ((vit_attention(q, k, v).float() - want.float()).abs() <= bf16_bound(p, v, want)).all()
    q, k, v = (t.to(torch.bfloat16) for t in _qkv(dev, (1, 1, s_max + 1, d), d))
    with pytest.raises(ValueError):
        vit_attention(q, k, v)
