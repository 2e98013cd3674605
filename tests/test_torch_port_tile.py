"""Kernel G's algorithm in tensor ops against the JAX package, on the CPU.

`ball_query_tile_grid_plain` (ops/grouping.py) is what kernel G
(csrc/ball_query_tile.cu) does: B's cell grid, each scene's centres ordered
by the Morton key of their cell, tiles of consecutive centres that stage
the rows of cells they read, each centre testing its own cells among the
staged points, the k smallest indices among the hits, each result back at
its centre's row.  These tests hold it bit
for bit against the adaptive and MXU Pallas kernels it ports (interpret
mode), the numpy golden model and `ball_query_plain`, check the centre
order against an independent Morton key and the un-permute, and check that
G's wrapper refuses what the kernel does not take before it builds or
launches anything.  Integer outputs are compared exactly.  The kernel
itself runs on the card in tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from coda_neurips2023_tpu.ops import pallas_ball_query as jbq
from coda_neurips2023_tpu.ops import pallas_ball_query_mxu as jbqm

from coda_neurips2023_tpu_torch import _kernels
from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset, make_batch
from coda_neurips2023_tpu_torch.ops.grouping import (
    TILE_MAX_SAMPLES,
    TILE_SIZE,
    TILE_SIZES,
    _cell_coord,
    _r2,
    _sq_dist,
    ball_query_grid_candidates,
    ball_query_plain,
    ball_query_tile_candidates,
    ball_query_tile_grid_plain,
    grid_build,
    grid_cap,
    grid_params_plain,
    grid_side,
    tile_order_plain,
    tile_query,
)
from coda_neurips2023_tpu_torch.ops.sampling import furthest_point_sample, gather_points

from golden import ball_query_golden
from torch_one_thread import one_intra_op_thread  # noqa: F401

FAR = 50.0


def _pc(seed, b, n, scale):
    return (np.random.default_rng(seed).standard_normal((b, n, 3)) * scale).astype(np.float32)


def _case(name):
    """(radius, xyz (B, N, 3), centres (B, M, 3)), N <= 300 for interpret mode."""
    if name == "phase3":  # chip_smoke.py's synthetic scenes, cut to 300 points
        ds = SyntheticDetectionDataset(SunrgbdAnonymousConfig(), num_scenes=2, num_points=300,
                                       seed=0)
        xyz = torch.from_numpy(make_batch(ds, 0, 2)["point_clouds"][..., :3].copy())
        return 0.4, xyz.numpy(), gather_points(xyz, furthest_point_sample(xyz, 48)).numpy()
    if name == "lattice":  # 0.25 apart, r = 0.25: points on cell faces and on the radius
        g = np.arange(-3, 3, dtype=np.float32) * 0.25
        xyz = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(1, -1, 3)
        return 0.25, xyz, np.ascontiguousarray(xyz[:, ::5])
    if name == "ragged_m":  # M = 45: not a multiple of any tile, a partial last tile
        xyz = _pc(3, 2, 260, 0.4)
        return 0.3, xyz, np.ascontiguousarray(xyz[:, 7:52])
    if name == "fps_order":  # centres as FPS gives them, far apart in their order
        xyz = torch.from_numpy(_pc(4, 1, 300, 0.6))
        ctr = gather_points(xyz, furthest_point_sample(xyz, 70))
        return 0.35, xyz.numpy(), ctr.numpy()
    if name == "all_miss":  # every centre far from every point: zero rows
        return 0.2, _pc(5, 2, 200, 1.0), np.full((2, 40, 3), FAR, np.float32)
    if name == "clump":  # 300 points within 2 cm: over 2k hits at every centre
        xyz = _pc(6, 1, 300, 0.01)
        ctr = np.concatenate([xyz[:, :20], np.full((1, 2, 3), FAR, np.float32)], 1)
        return 0.2, xyz, ctr
    raise ValueError(name)


CASES = ["phase3", "lattice", "ragged_m", "fps_order", "all_miss", "clump"]


@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("case", CASES)
def test_tile_plain_matches_pallas_golden_and_plain(monkeypatch, case, k):
    """G's tiles at the default tile, at every tile the kernel is built
    for and at cell sides 1 and 1.5, against the plain version, the golden
    model and the adaptive and (k = 64) MXU Pallas kernels."""
    radius, xyz, ctr = _case(case)
    t, c = torch.from_numpy(xyz), torch.from_numpy(ctr)
    want = ball_query_golden(radius, k, xyz, ctr)
    got = ball_query_tile_grid_plain(radius, k, t, c)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ball_query_plain(radius, k, t, c).numpy(), want)
    for tile in TILE_SIZES:
        for side in (1.0, 1.5):
            assert torch.equal(ball_query_tile_grid_plain(radius, k, t, c, tile, side), got)
    if case == "all_miss":
        assert not want.any()
    if case == "clump":
        hits = (_sq_dist(c[:, :, None], t[:, None]) < _r2(radius)).sum(-1)
        assert (hits[:, :20] > 2 * k).all()
        assert (want[:, :20] == np.arange(k)).all()
    monkeypatch.setattr(jbq, "_NC", 128)  # chunks of 128 points: several, and a ragged last
    monkeypatch.setattr(jbqm, "_NC", 128)
    args = (radius, k, jnp.asarray(xyz), jnp.asarray(ctr))
    with pltpu.force_tpu_interpret_mode():
        np.testing.assert_array_equal(np.asarray(jbq.ball_query_pallas(*args)), want)
        if k == 64:  # the MXU kernel takes only k = 64
            np.testing.assert_array_equal(np.asarray(jbqm.ball_query_pallas_mxu(*args)), want)


def _morton_reference(cell, dims, stride):
    """An independent Morton key of one centre's cell: Python integers,
    bits given up by the longest axis (x before y before z) until they fit
    below `stride`, then interleaved from the lowest, x, y, z in turn."""
    full = [int(d - 1).bit_length() for d in dims]
    bits = list(full)
    while sum(bits) > stride.bit_length() - 1:
        bits[bits.index(max(bits))] -= 1
    q = [int(v) >> (f - nb) for v, f, nb in zip(cell, full, bits)]
    key, pos = 0, 0
    for j in range(max(bits)):
        for a in range(3):
            if j < bits[a]:
                key |= ((q[a] >> j) & 1) << pos
                pos += 1
    return key


@pytest.mark.parametrize("shape", ["room", "long"])
def test_tile_order_and_unpermute_exact(shape):
    """The centre order is each scene's stable sort by the reference Morton
    key (on a long thin scene the key gives up bits to fit its range); and
    any order of tiles puts every result back at its own centre's row: the
    result of permuted centres is the permuted result."""
    rng = np.random.default_rng(11)
    # long: about 300 x 3 x 3 cells of 0.2 m, 9 + 2 + 2 bits, over the 12 that fit
    hi = (1.6, 1.6, 1.6) if shape == "room" else (60.0, 0.5, 0.5)
    xyz = torch.from_numpy(rng.uniform((0, 0, 0), hi, (2, 280, 3)).astype(np.float32))
    ctr = xyz[:, ::3].contiguous()
    b, n, _ = xyz.shape
    radius = 0.2
    stride = grid_cap(n) + 1
    lo, inv, dims = grid_params_plain(xyz, grid_side(radius, 1.0), grid_cap(n))
    cells = _cell_coord(ctr, lo[:, None], inv[:, None, None], dims[:, None])
    order = tile_order_plain(radius, xyz, ctr)
    for bi in range(b):
        keys = [_morton_reference(cell.tolist(), dims[bi].tolist(), stride) for cell in cells[bi]]
        assert max(keys) < stride
        want = sorted(range(len(keys)), key=lambda j: (keys[j], j))
        assert order[bi].tolist() == want
    full = [sum(int(d - 1).bit_length() for d in dims[bi].tolist()) for bi in range(b)]
    if shape == "long":  # each scene's key gave up bits to fit below the stride
        assert min(full) > stride.bit_length() - 1
    want = ball_query_plain(radius, 16, xyz, ctr)
    shuffled = torch.stack([torch.from_numpy(rng.permutation(ctr.shape[1])) for _ in range(b)])
    for o in (order, shuffled, torch.arange(ctr.shape[1]).expand(b, -1)):
        assert torch.equal(ball_query_tile_grid_plain(radius, 16, xyz, ctr, order=o), want)
    perm = shuffled
    moved = torch.gather(ctr, 1, perm[..., None].expand(-1, -1, 3))
    got = ball_query_tile_grid_plain(radius, 16, xyz, moved)
    assert torch.equal(got, torch.gather(want, 1, perm[..., None].expand(-1, -1, 16)))


def test_tile_candidates():
    """A centre tests its own cells (B's count at the same side), all of
    them inside what its tile stages, which is the same for every centre of
    a tile and at most N; a tile of one centre stages its own cells."""
    radius, xyz, ctr = _case("phase3")
    t, c = torch.from_numpy(xyz), torch.from_numpy(ctr)
    tested, staged = ball_query_tile_candidates(radius, t, c)
    own = ball_query_grid_candidates(radius, t, c, side_factor=1.0)
    hits = (_sq_dist(c[:, :, None], t[:, None]) < _r2(radius)).sum(-1)
    assert (hits <= own).all() and torch.equal(tested, own) and (tested <= staged).all()
    assert (staged <= t.shape[1]).all()
    order = tile_order_plain(radius, t, c)
    in_order = torch.gather(staged, 1, order)
    for bi in range(t.shape[0]):
        for tile in in_order[bi].split(TILE_SIZE):
            assert (tile == tile[0]).all()
    for got in ball_query_tile_candidates(radius, t, c, tile=1):
        assert torch.equal(got, own)


@pytest.mark.parametrize("case", ["grad", "no_points", "k_above_cap", "tile", "side", "scenes",
                                  "keys"])
def test_tile_wrapper_refusals(case):
    """G's wrapper refuses what the kernel does not take before it builds
    or launches anything (on a CPU tensor nothing could launch): inputs
    needing a gradient, N = 0, min(k, N) above TILE_MAX_SAMPLES, a tile it
    is not built for, a cell side below the widened radius (a centre's rows
    would outnumber a warp's lanes), more than 65535 scenes, key ranges
    past 2^31."""
    xyz = torch.from_numpy(_pc(9, 1, TILE_MAX_SAMPLES + 40, 1.0))
    ctr = xyz[:, :8].contiguous()
    calls = {
        "grad": (RuntimeError, lambda: tile_query(0.2, 8, xyz.clone().requires_grad_(), ctr)),
        "no_points": (ValueError, lambda: tile_query(0.2, 8, xyz[:, :0], ctr)),
        "k_above_cap": (ValueError, lambda: tile_query(0.2, TILE_MAX_SAMPLES + 1, xyz, ctr)),
        "tile": (ValueError, lambda: tile_query(0.2, 8, xyz, ctr, tile=24)),
        "side": (ValueError, lambda: tile_query(0.2, 8, xyz, ctr, side_factor=0.75)),
        "scenes": (ValueError, lambda: tile_query(0.2, 8, torch.zeros((65536, 1, 3)),
                                                  torch.zeros((65536, 1, 3)))),
        "keys": (ValueError, lambda: grid_build(0.2, torch.zeros((262144, 1, 3)), 1.0,
                                                "ball_query_tile", torch.zeros((262144, 1, 3)))),
    }
    error, call = calls[case]
    _kernels.reset_launches()
    with pytest.raises(error):
        call()
    assert not any(_kernels.LAUNCHES.values())
