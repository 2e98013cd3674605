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
from coda_neurips2023_tpu.ops import pallas_ball_query_sorted as jbqs
from coda_neurips2023_tpu.ops import pallas_masked_attention as jattn
from coda_neurips2023_tpu.ops.grouping import group_points as jax_group_points
from coda_neurips2023_tpu.ops.pallas_fps import fps_pallas
from coda_neurips2023_tpu.ops.sampling import furthest_point_sample as jax_fps
from coda_neurips2023_tpu.ops.sampling import gather_points as jax_gather_points

from coda_neurips2023_tpu_torch import _kernels
from coda_neurips2023_tpu_torch.ops.grouping import ball_query, group_points, query_and_group
from coda_neurips2023_tpu_torch.ops.masked_attention import masked_attention, masked_attention_plain
from coda_neurips2023_tpu_torch.ops.sampling import furthest_point_sample, gather_points
from coda_neurips2023_tpu_torch.ops.vit_attention import vit_attention

from golden import ball_query_golden, fps_golden

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


@pytest.mark.parametrize("case", sorted(BQ_CASES))
def test_ball_query_matches_golden_and_pallas(monkeypatch, case):
    radius, nsample, xyz, new_xyz = _bq_inputs(case)
    got = ball_query(radius, nsample, torch.from_numpy(xyz), torch.from_numpy(new_xyz))
    assert got.dtype == torch.int32
    want = ball_query_golden(radius, nsample, xyz, new_xyz)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(want[:, -2:] == 0)
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
    q = torch.randn(1, 2, 16, 8)
    masked_attention(q, torch.randn(1, 2, 8, 16), torch.randn(1, 2, 16, 8))
    vit_attention(q, torch.randn(1, 2, 16, 8), torch.randn(1, 2, 16, 8))
    assert _kernels.LAUNCHES == {"fps": 0, "ball_query": 0, "gather": 0, "attention": 0,
                                 "vit_attention": 0}


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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'coda_neurips2023_tpu'))\n"
        "assert not bad, bad\n"
        "new = {'models.clip', 'models.tokenizer', 'models.text_bank', 'models.distillation',\n"
        "       'ops.vit_attention', 'ops.projection', 'stages'}\n"
        "assert {pkg.__name__ + '.' + n for n in new} <= set(names), names\n"
        "assert len(names) >= 26, names\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
