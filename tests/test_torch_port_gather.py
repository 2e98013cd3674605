"""The port's gather (kernel C's plain version on the CPU) against the JAX package.

On a CPU tensor `group_points` and `gather_points` take `group_points_plain`,
so these tests hold it bit for bit against the JAX package's gather at the
widths kernel C serves on the card: XLA's `take_along_axis`
(`_group_points_xla`, which the JAX package takes at every width off the
TPU and at C > 8 on it) at C = 1, 5, 8, 64 and 256, and the Pallas one-hot
gather `group_points_pallas` in interpret mode at C = 3 and 6, the widths
the JAX package sends to it.  The indices carry the ball query's padding:
each row's first h slots drawn, the rest repeating the first.  A gather is a
copy, so every case must be bit-equal.  The kernel's branches themselves
(C = 3, 16-byte and single-float tiles) are held on the card by
tests/test_torch_port_cuda.py and chip_smoke.py's phase 3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from coda_neurips2023_tpu.ops.grouping import _group_points_xla
from coda_neurips2023_tpu.ops.grouping import group_points as jax_group_points
from coda_neurips2023_tpu.ops.pallas_group_gather import group_points_pallas
from coda_neurips2023_tpu.ops.sampling import gather_points as jax_gather_points

from coda_neurips2023_tpu_torch.ops.grouping import group_points
from coda_neurips2023_tpu_torch.ops.sampling import gather_points

from torch_one_thread import one_intra_op_thread  # noqa: F401


def padded_inputs(seed, b, n, m, k, c):
    """Seeded (B, N, C) features and (B, M, K) int32 indices padded as the
    ball query pads a row: its first h slots drawn (h in [1, K]), the rest
    the first hit."""
    rng = np.random.default_rng(seed)
    feats = (rng.standard_normal((b, n, c)) * 4).astype(np.float32)
    idx = rng.integers(0, n, (b, m, k)).astype(np.int32)
    hits = rng.integers(1, k + 1, (b, m, 1))
    idx = np.where(np.arange(k) < hits, idx, idx[..., :1]).astype(np.int32)
    return feats, idx


@pytest.mark.parametrize("c", [1, 5, 8, 64, 256])
def test_group_points_matches_jax_xla(c):
    feats, idx = padded_inputs(c, 2, 600, 64, 32, c)
    got = group_points(torch.from_numpy(feats), torch.from_numpy(idx)).numpy()
    want = np.asarray(_group_points_xla(jnp.asarray(feats), jnp.asarray(idx)))
    assert got.shape == (2, 64, 32, c)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jax_group_points(jnp.asarray(feats),
                                                                   jnp.asarray(idx))))


def test_gather_points_matches_jax_at_c256():
    feats, idx = padded_inputs(257, 2, 2048, 1, 1024, 256)
    sel = np.ascontiguousarray(idx[:, 0])
    got = gather_points(torch.from_numpy(feats), torch.from_numpy(sel)).numpy()
    want = np.asarray(jax_gather_points(jnp.asarray(feats), jnp.asarray(sel)))
    assert got.shape == (2, 1024, 256)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", [3, 6])
def test_group_points_matches_pallas_interpret(c):
    feats, idx = padded_inputs(30 + c, 2, 555, 32, 16, c)
    got = group_points(torch.from_numpy(feats), torch.from_numpy(idx)).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(group_points_pallas(jnp.asarray(feats), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want)
