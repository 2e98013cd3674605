"""Kernel A's cluster scheme and launch policy on the CPU.

Kernel A (csrc/fps.cu) spreads each scene over a thread-block cluster: every
block takes the arg-max of a contiguous slice of ceil(N / CS) points, and the
slices' (value, index) pairs are merged across the cluster every step, the
larger value and then the lower index winning.  The kernel runs only on the
card; here `furthest_point_sample_cluster_plain` (that scheme written out in
PyTorch) is held against the plain version, the numpy golden model and the
JAX package's FPS, and `fps_cluster_size` against the sizes it must pick.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from coda_neurips2023_tpu.ops.pallas_fps import fps_pallas
from coda_neurips2023_tpu.ops.sampling import furthest_point_sample as jax_fps

from coda_neurips2023_tpu_torch.ops.sampling import (
    FPS_MAX_POINTS_PER_THREAD,
    FPS_THREADS,
    fps_cluster_size,
    furthest_point_sample,
    furthest_point_sample_cluster_plain,
    furthest_point_sample_plain,
)

from golden import fps_golden
from torch_one_thread import one_intra_op_thread  # noqa: F401

CLUSTER_SIZES = (1, 2, 4, 8, 16)


def _scene(case, n=257):
    rng = np.random.default_rng(7)
    xyz = (rng.standard_normal((2, n, 3)) * 3).astype(np.float32)
    if case == "ties":
        # a coarse grid, and copies of points placed in other slices at
        # every cluster size: exact ties across slice boundaries
        xyz = np.round(xyz * 2) / 2
        for src, dst in ((3, 130), (5, 70), (9, 250), (17, 34), (31, 200)):
            xyz[:, dst] = xyz[:, src]
    elif case == "invalid":
        xyz[:, 0] = 0.0  # index 0 seeds the loop all the same
        xyz[:, 40:60] = 0.0  # never picked, across slice boundaries
        xyz[1, 100:257:2] = 1e-2  # |p|^2 = 3e-4 <= 1e-3
    return xyz


@pytest.mark.parametrize("cs", CLUSTER_SIZES)
@pytest.mark.parametrize("case", ["random", "ties", "invalid"])
def test_cluster_merge_matches_plain_and_jax(case, cs):
    """N = 257, divisible by no cluster size: the slices' arg-maxes merged
    in rank order pick the same points as the plain version, the golden
    model and the JAX package's FPS (its XLA path and its Pallas kernel)."""
    xyz = _scene(case)
    t = torch.from_numpy(xyz)
    got = furthest_point_sample_cluster_plain(t, 40, cs)
    want = fps_golden(xyz, 40)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(furthest_point_sample_plain(t, 40).numpy(), want)
    np.testing.assert_array_equal(furthest_point_sample(t, 40).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jax_fps(jnp.asarray(xyz), 40, use_pallas=False)), want)
    if cs == 1:
        with pltpu.force_tpu_interpret_mode():
            np.testing.assert_array_equal(np.asarray(fps_pallas(jnp.asarray(xyz), 40)), want)
    if case == "invalid":
        assert not np.any((want[:, 1:] >= 40) & (want[:, 1:] < 60))


@pytest.mark.parametrize("cs", CLUSTER_SIZES)
def test_cluster_merge_with_empty_slices(cs):
    """N = 5 on up to 16 slices of one point (the last slices empty), more
    picks than points: as the plain version."""
    xyz = _scene("random", n=5)
    t = torch.from_numpy(xyz)
    np.testing.assert_array_equal(furthest_point_sample_cluster_plain(t, 9, cs).numpy(),
                                  furthest_point_sample_plain(t, 9).numpy())


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("n", [2048, 20000, 40000])
@pytest.mark.parametrize("b", [8, 32])
def test_fps_cluster_size(b, n, sm_count):
    """One wave at most (sm_count // CS clusters), slices of at least 4096
    points, and enough threads for the scene: 32 x 20000 takes 4 blocks on
    132 SMs and 2 on 114, 8 x 20000 takes 4, 8 x 40000 8, 2048 points 1."""
    want = {(8, 2048): 1, (8, 20000): 4, (8, 40000): 8,
            (32, 2048): 1, (32, 20000): 4 if sm_count == 132 else 2,
            (32, 40000): 4 if sm_count == 132 else 2}[b, n]
    cs = fps_cluster_size(b, n, sm_count)
    assert cs == want
    assert b * cs <= sm_count
    assert cs * FPS_THREADS * FPS_MAX_POINTS_PER_THREAD >= n


def test_fps_cluster_size_with_resident_clusters():
    """The card's own count of clusters it runs at once (an H100 SXM's, as
    the CUDA occupancy API gives it: a cluster's SMs share a GPC) overrides
    sm_count // CS: 32 clusters of 4 do not fit in one wave there."""
    resident = {1: 132, 2: 66, 4: 30, 8: 15}.get
    assert fps_cluster_size(32, 20000, 132) == 4
    assert fps_cluster_size(32, 20000, 132, resident) == 2
    assert fps_cluster_size(8, 40000, 132, resident) == 8
    assert fps_cluster_size(16, 40000, 132, resident) == 4


def test_fps_cluster_size_past_one_wave_and_refusal():
    """A scene too large for one block's threads takes the size it needs even
    past one wave; one too large for the largest cluster is refused."""
    assert fps_cluster_size(200, 50000, 132) == 4
    assert fps_cluster_size(1, 8 * FPS_THREADS * FPS_MAX_POINTS_PER_THREAD, 132) == 8
    with pytest.raises(ValueError):
        fps_cluster_size(1, 8 * FPS_THREADS * FPS_MAX_POINTS_PER_THREAD + 1, 132)
