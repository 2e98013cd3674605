"""The PyTorch port's point and attention ops against the JAX package on the CPU.

On a CPU tensor every op of `coda_neurips2023_tpu_torch.ops` takes its plain
PyTorch version, so these tests hold those versions against the numpy golden
models (tests/golden.py), the JAX XLA paths and the Pallas kernels in
interpret mode.  Indices and gathers must match exactly; attention agrees
with the JAX `_reference` within 1e-5 (both fp32 on the CPU; the softmax and
the two products sum in different orders).  The CUDA kernels themselves are
tested on the card by tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from coda_neurips2023_tpu.ops import pallas_ball_query as jbq
from coda_neurips2023_tpu.ops import pallas_ball_query_mxu as jbqm
from coda_neurips2023_tpu.ops import pallas_ball_query_sorted as jbqs
from coda_neurips2023_tpu.ops import pallas_masked_attention as jattn
from coda_neurips2023_tpu.ops.grouping import group_points as jax_group_points
from coda_neurips2023_tpu.ops.pallas_fps import fps_pallas
from coda_neurips2023_tpu.ops.sampling import furthest_point_sample as jax_fps
from coda_neurips2023_tpu.ops.sampling import gather_points as jax_gather_points

from coda_neurips2023_tpu_torch import _kernels
from coda_neurips2023_tpu_torch.models.distillation import clip_crops, crop_square_resize_white
from coda_neurips2023_tpu_torch.ops.grouping import (
    GRID_DOUBLINGS,
    ball_query,
    ball_query_grid_candidates,
    ball_query_grid_plain,
    ball_query_group,
    ball_query_plain,
    _r2,
    _sq_dist,
    ball_query_tile,
    grid_cap,
    grid_params_plain,
    grid_radius,
    grid_side,
    group_points,
    group_points_plain,
    query_and_group,
)
from coda_neurips2023_tpu_torch.ops.masked_attention import masked_attention, masked_attention_plain
from coda_neurips2023_tpu_torch.ops.sampling import furthest_point_sample, gather_points
from coda_neurips2023_tpu_torch.ops.tower_gemm import tower_linear
from coda_neurips2023_tpu_torch.ops.vit_attention import vit_attention

from golden import ball_query_golden, fps_golden
from torch_one_thread import one_intra_op_thread  # noqa: F401

ATTN_TOL = 1e-5


def rand_pc(rng, b, n, scale=3.0):
    return (rng.standard_normal((b, n, 3)) * scale).astype(np.float32)


def _fps_case(case):
    rng = np.random.default_rng(20)
    xyz = rand_pc(rng, 3, 257)
    if case == "near_origin":
        xyz[:, 5:20] = 0.0  # |p|^2 <= 1e-3: never picked
    elif case == "invalid_seed":
        xyz[:, 0] = 0.0  # point 0 seeds the loop all the same
    elif case == "ties":
        xyz = np.round(xyz * 2) / 2  # a coarse grid: exact, tied distances
    return xyz


@pytest.mark.parametrize("case", ["random", "near_origin", "invalid_seed", "ties"])
def test_fps_matches_golden_and_jax(case):
    xyz = _fps_case(case)
    got = furthest_point_sample(torch.from_numpy(xyz), 33)
    assert got.dtype == torch.int32
    want = fps_golden(xyz, 33)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jax_fps(jnp.asarray(xyz), 33, use_pallas=False)), want)
    with pltpu.force_tpu_interpret_mode():
        np.testing.assert_array_equal(np.asarray(fps_pallas(jnp.asarray(xyz), 33)), want)
    if case == "near_origin":
        assert not np.any((want >= 5) & (want < 20))


# (B, N, M, radius, nsample, scale): dense (more than k hits), sparse (rows
# with no hit), k=64 as in the pre-encoder, k=32 as in the masked encoder's
# interim set abstraction
BQ_CASES = {
    "dense": (2, 300, 33, 0.5, 8, 0.25),
    "sparse": (1, 300, 17, 0.15, 8, 1.0),
    "k64": (1, 260, 19, 0.4, 64, 0.3),
    "k32": (2, 300, 25, 0.4, 32, 0.3),
}


def _bq_inputs(case):
    b, n, m, radius, nsample, scale = BQ_CASES[case]
    rng = np.random.default_rng(13)
    xyz = rand_pc(rng, b, n, scale=scale)
    # two far centres have no hit at all
    new_xyz = np.concatenate([xyz[:, : m - 2], np.full((b, 2, 3), 50.0, np.float32)], axis=1)
    return radius, nsample, xyz, new_xyz


def _grid_inputs(case):
    """The cases that stress kernel B's and F's cell grid, N <= 300 for
    interpret mode: (radius, nsample, xyz, new_xyz)."""
    rng = np.random.default_rng(29)
    far = np.full((1, 2, 3), 50.0, np.float32)
    if case == "lattice":  # 0.25 apart, r = 0.25: points on cell faces and on the radius
        g = np.arange(-3, 3, dtype=np.float32) * 0.25
        xyz = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(1, -1, 3)
        return 0.25, 16, xyz, np.ascontiguousarray(xyz[:, ::7])
    if case == "clump":  # every point in one cell, hits >> k
        xyz = rand_pc(rng, 1, 300, scale=0.01)
        return 0.2, 16, xyz, np.concatenate([xyz[:, :20], far], 1)
    if case == "plane":  # 300 points with one z: a wall
        xyz = rand_pc(rng, 1, 300, scale=1.0)
        xyz[..., 2] = 0.5
        return 0.3, 16, xyz, np.concatenate([xyz[:, :30], far], 1)
    if case == "far_centres":  # every centre outside the grid: border cells, no hit
        xyz = rand_pc(rng, 1, 200, scale=1.0)
        ctr = np.concatenate([np.full((1, 6, 3), 50.0, np.float32),
                              np.full((1, 5, 3), -50.0, np.float32)], 1)
        ctr[0, 3] = (50.0, 0.0, 0.0)
        return 0.3, 8, xyz, ctr
    if case == "outlier":  # one far point stretches the box past the cell cap
        xyz = rand_pc(rng, 1, 300, scale=0.3)
        xyz[0, 7] = (1e4, 1e4, 1e4)
        return 0.3, 16, xyz, np.ascontiguousarray(xyz[:, :30])
    if case == "n1":
        xyz = rand_pc(rng, 2, 1, scale=1.0)
        ctr = np.concatenate([xyz, xyz + 0.5, np.broadcast_to(far, (2, 2, 3))], 1)
        return 1.0, 8, xyz, np.ascontiguousarray(ctr)
    if case == "k_above_n":
        xyz = rand_pc(rng, 2, 40, scale=1.0)
        return 2.0, 64, xyz, np.concatenate([xyz[:, :15], np.broadcast_to(far, (2, 2, 3))], 1)
    return _bq_inputs(case)


GRID_CASES = sorted(BQ_CASES) + ["clump", "far_centres", "k_above_n", "lattice", "n1", "outlier",
                                 "plane"]


@pytest.mark.parametrize("case", GRID_CASES)
def test_ball_query_matches_golden_and_pallas(monkeypatch, case):
    """ball_query (the plain version on the CPU) and the grid scheme of
    kernels B and F at three cell sides, against the golden model and the
    JAX sorted and v3 Pallas kernels in interpret mode; the grid's grouped
    coordinates against the fused Pallas kernel's."""
    radius, nsample, xyz, new_xyz = _grid_inputs(case)
    t, c = torch.from_numpy(xyz), torch.from_numpy(new_xyz)
    got = ball_query(radius, nsample, t, c)
    assert got.dtype == torch.int32
    want = ball_query_golden(radius, nsample, xyz, new_xyz)
    np.testing.assert_array_equal(got.numpy(), want)
    if case in BQ_CASES:
        assert np.all(want[:, -2:] == 0)
    for side_factor in (1.0, 1.5, 2.0):
        grid = ball_query_grid_plain(radius, nsample, t, c, side_factor=side_factor)
        assert torch.equal(grid, got), side_factor
    # the Pallas kernels with their blocks shrunk so multi-block paths run
    monkeypatch.setattr(jbq, "_NC", 128)
    monkeypatch.setattr(jbqs, "_BLK", 128)
    monkeypatch.setattr(jbqs, "_WS", 128)
    monkeypatch.setattr(jbqs, "_TM", 8)
    monkeypatch.setattr(jbqs, "_LANE", 8)
    args = (radius, nsample, jnp.asarray(xyz), jnp.asarray(new_xyz))
    with pltpu.force_tpu_interpret_mode():
        np.testing.assert_array_equal(np.asarray(jbq.ball_query_pallas_v3(*args)), want)
        np.testing.assert_array_equal(np.asarray(jbqs.ball_query_pallas_sorted(*args)), want)
        idx, grouped = jbqs.ball_query_and_group_sorted(*args)
    np.testing.assert_array_equal(np.asarray(idx), want)
    np.testing.assert_array_equal(np.asarray(grouped), group_points_plain(t, grid).numpy())


@pytest.mark.parametrize("case", ["dense", "clump", "plane", "outlier", "n1"])
def test_grid_params_and_candidates(case):
    """The grid's side is the first of side0 * 2^j whose grid has at most
    grid_cap(N) cells, never below the widened radius; every centre tests at
    least its hits and at most all N points."""
    radius, nsample, xyz, new_xyz = _grid_inputs(case)
    t, c = torch.from_numpy(xyz), torch.from_numpy(new_xyz)
    b, n, _ = xyz.shape
    lo, inv, dims = grid_params_plain(t, grid_side(radius), grid_cap(n))
    side = 1.0 / inv.double()
    assert torch.equal(lo, t.amin(1))
    assert (dims.prod(-1) <= grid_cap(n)).all()
    assert (side >= grid_radius(radius) * (1 - 2 ** -23)).all()
    ext = (t.amax(1) - t.amin(1)).double()
    finer = side / 2  # the side before: too many cells, unless it was the first
    too_many = (torch.floor(ext / finer[:, None]) + 1).prod(-1) > grid_cap(n)
    assert ((side <= grid_side(radius) * (1 + 2 ** -23)) | too_many).all()
    if case == "outlier":
        assert (side > 1.0).all()  # the cap forced doublings
    cand = ball_query_grid_candidates(radius, t, c)
    hits = (_sq_dist(c[:, :, None], t[:, None]) < _r2(radius)).sum(-1)
    assert (cand <= n).all() and (cand >= hits).all()


def test_grid_one_cell_when_no_side_fits():
    """An infinite extent: no side of GRID_DOUBLINGS fits the cap, so the
    scene is one cell, every centre tests every point, and the result is
    still exact."""
    xyz = rand_pc(np.random.default_rng(3), 1, 50)
    xyz[0, 4] = (np.inf, 0.0, 0.0)
    t = torch.from_numpy(xyz)
    lo, inv, dims = grid_params_plain(t, grid_side(0.5), grid_cap(50))
    assert dims.tolist() == [[1, 1, 1]] and GRID_DOUBLINGS == 64
    c = t[:, :10].contiguous()
    assert (ball_query_grid_candidates(0.5, t, c) == 50).all()
    assert torch.equal(ball_query_grid_plain(0.5, 8, t, c), ball_query_plain(0.5, 8, t, c))


# kernel G's function (the adaptive and MXU Pallas kernels, rows 4 and 5 of
# PERF.md's table): (B, N, M, radius, nsample, scale, far centres).  With the
# Pallas chunk shrunk to 128 points, N = 300 and 257 end in a partial chunk.
G_CASES = {
    "dense": (2, 300, 33, 0.5, 64, 0.25, 2),
    "sparse": (1, 300, 17, 0.15, 8, 1.0, 2),
    "zero_hit": (1, 200, 9, 0.1, 64, 1.0, 9),
    "k64": (1, 260, 19, 0.4, 64, 0.3, 2),
    "ragged_n": (1, 257, 20, 0.4, 33, 0.3, 1),
}


@pytest.mark.parametrize("case", sorted(G_CASES))
def test_ball_query_plain_matches_adaptive_and_mxu_pallas(monkeypatch, case):
    """The plain version (kernel G's on the CPU) bit-equal to the adaptive
    Pallas kernel and, at k = 64 (the only k it takes), the MXU kernel, both
    in interpret mode, and to the golden model."""
    b, n, m, radius, nsample, scale, far = G_CASES[case]
    rng = np.random.default_rng(n + m)
    xyz = rand_pc(rng, b, n, scale=scale)
    new_xyz = np.concatenate([xyz[:, : m - far], np.full((b, far, 3), 50.0, np.float32)], axis=1)
    got = ball_query_tile(radius, nsample, torch.from_numpy(xyz), torch.from_numpy(new_xyz))
    want = ball_query_golden(radius, nsample, xyz, new_xyz)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ball_query_plain(radius, nsample, torch.from_numpy(xyz), torch.from_numpy(new_xyz)).numpy(),
        want)
    assert np.all(want[:, m - far:] == 0)
    monkeypatch.setattr(jbq, "_NC", 128)
    monkeypatch.setattr(jbqm, "_NC", 128)
    args = (radius, nsample, jnp.asarray(xyz), jnp.asarray(new_xyz))
    with pltpu.force_tpu_interpret_mode():
        np.testing.assert_array_equal(np.asarray(jbq.ball_query_pallas(*args)), want)
        if nsample == 64:
            np.testing.assert_array_equal(np.asarray(jbqm.ball_query_pallas_mxu(*args)), want)


def test_ball_query_exact_boundary():
    """Points exactly at the radius are misses (strict <), in every version."""
    g = np.arange(-4, 5, dtype=np.float32) * 0.25  # exact squares
    xyz = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(1, -1, 3)
    new_xyz = np.ascontiguousarray(xyz[:, ::37])
    got = ball_query(0.5, 16, torch.from_numpy(xyz), torch.from_numpy(new_xyz))
    np.testing.assert_array_equal(got.numpy(), ball_query_golden(0.5, 16, xyz, new_xyz))


def test_group_and_gather_bit_equal():
    rng = np.random.default_rng(6)
    feats = (rng.standard_normal((2, 500, 3)) * 4).astype(np.float32)
    idx = rng.integers(0, 500, (2, 40, 16)).astype(np.int32)
    got = group_points(torch.from_numpy(feats), torch.from_numpy(idx))
    flat = jnp.take_along_axis(jnp.asarray(feats), jnp.asarray(idx.reshape(2, -1, 1)), axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(flat).reshape(2, 40, 16, 3))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_group_points(jnp.asarray(feats), jnp.asarray(idx)))
    )
    sel = idx[:, :, 0]
    np.testing.assert_array_equal(
        gather_points(torch.from_numpy(feats), torch.from_numpy(np.ascontiguousarray(sel))).numpy(),
        np.asarray(jax_gather_points(jnp.asarray(feats), jnp.asarray(sel))),
    )


def test_query_and_group_recentres_and_normalizes():
    radius, nsample, xyz, new_xyz = _bq_inputs("dense")
    grouped, grouped_xyz = query_and_group(
        radius, nsample, torch.from_numpy(xyz), torch.from_numpy(new_xyz), normalize_xyz=True
    )
    idx = ball_query_golden(radius, nsample, xyz, new_xyz)
    want = (np.stack([xyz[b][idx[b]] for b in range(xyz.shape[0])]) - new_xyz[:, :, None]) / radius
    np.testing.assert_array_equal(grouped.numpy(), want.astype(np.float32))
    assert grouped is grouped_xyz


@pytest.mark.parametrize("radius", [0.0, 0.8])
@pytest.mark.parametrize("sq,skv,d", [(40, 40, 8), (16, 72, 16)])
def test_masked_attention_matches_jax_reference(radius, sq, skv, d):
    rng = np.random.default_rng(7)
    b, h = 2, 3
    q = (rng.standard_normal((b, h, sq, d)) / np.sqrt(d)).astype(np.float32)
    k = rng.standard_normal((b, h, d, skv)).astype(np.float32)
    v = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    kxyz = rng.uniform(-1, 1, (b, skv, 3)).astype(np.float32)
    qxyz = kxyz[:, :sq].copy()
    qxyz[:, 0] = 100.0  # with radius > 0, a row with no allowed key: uniform
    kxyz_t = np.ascontiguousarray(kxyz.transpose(0, 2, 1))
    arrays = (q, k, v, qxyz, kxyz_t)
    want = np.asarray(jattn._reference(*map(jnp.asarray, arrays), radius, jnp.float32))
    got = masked_attention(*map(torch.from_numpy, arrays), radius)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATTN_TOL)
    plain = masked_attention_plain(*map(torch.from_numpy, arrays), radius)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    if radius > 0:
        np.testing.assert_allclose(got.numpy()[:, :, 0], v.mean(axis=2), rtol=0, atol=ATTN_TOL)


def test_cpu_calls_launch_nothing():
    _kernels.reset_launches()
    rng = np.random.default_rng(8)
    xyz = torch.from_numpy(rand_pc(rng, 2, 100))
    inds = furthest_point_sample(xyz, 10)
    centres = gather_points(xyz, inds)
    query_and_group(0.5, 8, xyz, centres)
    ball_query_group(0.5, 8, xyz, centres)
    ball_query_tile(0.5, 8, xyz, centres)
    q = torch.randn(1, 2, 16, 8)
    masked_attention(q, torch.randn(1, 2, 8, 16), torch.randn(1, 2, 16, 8))
    masked_attention(q, torch.randn(1, 2, 8, 16), torch.randn(1, 2, 16, 8), compute_dtype="bfloat16")
    vit_attention(q, torch.randn(1, 2, 16, 8), torch.randn(1, 2, 16, 8))
    vit_attention(*(torch.randn(1, 2, 16, 8, dtype=torch.bfloat16) for _ in range(3)))
    images = torch.from_numpy(rng.integers(0, 256, (2, 20, 30, 3)).astype(np.uint8))
    rects = torch.tensor([[[0, 0, 30, 20], [3, 4, 9, 5]]] * 2, dtype=torch.int32)
    clip_crops(images, rects, 8)
    crop_square_resize_white(images[0].to(torch.float32), rects[0], 8)
    tower_linear(torch.randn(2, 3, 8), torch.randn(24, 8), torch.randn(24), "qkv", heads=2)
    assert _kernels.LAUNCHES == {"fps": 0, "ball_query": 0, "gather": 0, "attention": 0,
                                 "vit_attention": 0, "ball_query_group": 0, "ball_query_tile": 0,
                                 "attention_bf16": 0, "vit_attention_bf16": 0, "crop": 0,
                                 "tower_gemm": 0}


@pytest.mark.parametrize(
    "call",
    [
        lambda: furthest_point_sample(torch.zeros(2, 10, 3, dtype=torch.float64), 4),
        lambda: furthest_point_sample(torch.zeros(2, 10, 2), 4),
        lambda: ball_query(0.2, 8, torch.zeros(2, 10, 3), torch.zeros(2, 4, 2)),
        lambda: ball_query(0.2, 8, torch.zeros(2, 10, 3, dtype=torch.float16), torch.zeros(2, 4, 3)),
        lambda: group_points(torch.zeros(2, 10, 3), torch.zeros(2, 4, 8, dtype=torch.int64)),
        lambda: gather_points(torch.zeros(2, 10, 3), torch.zeros(2, 4, 8, dtype=torch.int32)),
        lambda: masked_attention(torch.zeros(1, 2, 16, 8), torch.zeros(1, 2, 16, 8), torch.zeros(1, 2, 16, 8)),
        lambda: masked_attention(torch.zeros(1, 2, 16, 8), torch.zeros(1, 2, 8, 16),
                                 torch.zeros(1, 2, 16, 8), radius=0.5),
        lambda: masked_attention(*(torch.zeros(1, 2, 16, 8, dtype=torch.float64),) * 3),
        lambda: vit_attention(*(torch.zeros(1, 2, 16, 8, dtype=torch.float64),) * 3),
        lambda: vit_attention(torch.zeros(1, 2, 16, 8), torch.zeros(1, 2, 8, 16),
                              torch.zeros(1, 2, 16, 8)),
        lambda: vit_attention(*(torch.zeros(2, 16, 8),) * 3),
    ],
    ids=["fps_dtype", "fps_shape", "bq_shape", "bq_dtype", "group_idx_dtype", "gather_idx_rank",
         "attn_k_layout", "attn_radius_without_xyz", "attn_dtype", "vit_attn_dtype",
         "vit_attn_k_transposed", "vit_attn_rank"],
)
def test_wrappers_reject_unsupported_inputs(call):
    with pytest.raises(ValueError):
        call()


def test_port_never_imports_jax():
    root = Path(__file__).resolve().parents[1]
    code = (
        "import importlib, pkgutil, sys\n"
        "import coda_neurips2023_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'coda_neurips2023_tpu'))\n"
        "assert not bad, bad\n"
        "new = {'models.clip', 'models.tokenizer', 'models.text_bank', 'models.distillation',\n"
        "       'ops.vit_attention', 'ops.projection', 'stages', 'criterion', 'optimizer',\n"
        "       'ops.giou', 'ops.hungarian', 'utils.device', 'parallel.dist', 'parallel.ddp',\n"
        "       'ops.interpolate', 'vis_color_pc'}\n"
        "assert {pkg.__name__ + '.' + n for n in new} <= set(names), names\n"
        "assert len(names) >= 30, names\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
