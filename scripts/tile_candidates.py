#!/usr/bin/env python3
"""Count the points each centre tests in kernel G's tiles, on the CPU, for
choosing the tile size, the centres' order and the cell side.

    python3 scripts/tile_candidates.py [--scenes 32]

Counts only (plain PyTorch, `ops/grouping.py :: ball_query_tile_candidates`
and `ball_query_grid_candidates`); no time.  Scenes (r = 0.2, 2048 centres a
scene from furthest point sampling): chip_smoke.py's phase-3 scenes (the
synthetic SUN RGB-D-shaped scenes of 20,000 points, seed 0), the same with
5,000 points of each scene moved onto one plane, and clouds uniform in
8 m x 8 m x 3 m.  For each: kernel B's count a centre (its own cells) at
cell sides 1 and 1.5 widened radii, and G's at tiles of 8, 16, 32 and 64
centres, with the centres in Morton order of their cell, in row-major order
of their cell, and in FPS order as they come: the points a centre tests
(the runs of its own rows in its tile's union; mean, largest, and the
distance tests in all) and the points a tile stages (its union; a centre's
share, the mean and the largest a tile); and at a side of 1 in Morton order,
the runs a tile stages (one a row of its union) and their lengths, and the
hits a centre has.
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig  # noqa: E402
from coda_neurips2023_tpu_torch.datasets.synthetic import (  # noqa: E402
    SyntheticDetectionDataset,
    make_batch,
)
from coda_neurips2023_tpu_torch.ops import grouping, sampling  # noqa: E402

RADIUS, M = 0.2, 2048
PLANE_POINTS, PLANE_Z = 5000, 1.0  # chip_smoke.py's degenerate scene
TILES = (8, 16, 32, 64)
SIDES = (1.0, 1.5)


def row_major_order(x, c, side_factor):
    """Each scene's centres by the row-major id of their cell (z, y, x)."""
    lo, inv, dims = grouping.grid_params_plain(x, grouping.grid_side(RADIUS, side_factor),
                                               grouping.grid_cap(x.shape[1]))
    cells = grouping._cell_coord(c, lo[:, None], inv[:, None, None], dims[:, None])
    d = dims[:, None]
    ids = (cells[..., 2] * d[..., 1] + cells[..., 1]) * d[..., 0] + cells[..., 0]
    return torch.sort(ids, dim=1, stable=True).indices


def describe(v):
    v = v.float()
    q = torch.tensor([0.5, 0.9, 0.99])
    return (f"mean {v.mean().item():.1f} median/p90/p99 "
            f"{'/'.join(f'{x:.0f}' for x in v.quantile(q).tolist())} max {int(v.max())}")


def hits_of(x, c):
    r2 = grouping._r2(RADIUS)
    return torch.cat([(grouping._sq_dist(c[bi, :, None], x[bi, None]) < r2).sum(-1)
                      for bi in range(x.shape[0])])


def union_runs(x, c, tile):
    """(runs a tile, the lengths of all runs) of G's tiles at a side of 1."""
    lo, inv, dims, _, starts = grouping._grid_plain(RADIUS, x, 1.0)
    c0, c1 = grouping._centre_boxes(RADIUS, c, lo, inv, dims)
    order = grouping.tile_order_plain(RADIUS, x, c, 1.0)
    counts, lengths = [], []
    for bi in range(x.shape[0]):
        o = order[bi]
        length = grouping._tile_union_rows(c0[bi, o], c1[bi, o], dims[bi, 0], starts[bi],
                                           tile)[1]
        counts.append((length > 0).sum(-1))
        lengths.append(length[length > 0])
    return torch.cat(counts), torch.cat(lengths)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=32)
    b = ap.parse_args().scenes
    torch.manual_seed(0)
    ds = SyntheticDetectionDataset(SunrgbdAnonymousConfig(), num_scenes=b, num_points=20000, seed=0)
    phase3 = torch.from_numpy(make_batch(ds, 0, b)["point_clouds"][..., :3].copy())
    plane = phase3.clone()
    plane[:, :PLANE_POINTS, 2] = PLANE_Z
    g = torch.Generator().manual_seed(0)
    box = torch.tensor([8.0, 8.0, 3.0])
    uniform = torch.rand((b, 20000, 3), generator=g) * box - box * torch.tensor([0.5, 0.5, 0.0])
    for name, x in (("phase3", phase3), ("plane", plane), ("uniform", uniform)):
        c = sampling.gather_points(x, sampling.furthest_point_sample(x, M))
        for sf in SIDES:
            t = grouping.ball_query_grid_candidates(RADIUS, x, c, side_factor=sf).float()
            print(f"{name} B={b} side {sf}: B's cells mean {t.mean().item():.1f} max "
                  f"{int(t.max())} tests {int(t.sum())}")
            orders = {"morton": None, "row_major": row_major_order(x, c, sf),
                      "fps": torch.arange(M).expand(b, -1)}
            if sf == 1.0:
                print(f"{name} B={b} side 1.0 hits a centre: " + describe(hits_of(x, c)))
                for tile in TILES:
                    runs = union_runs(x, c, tile)
                    print(f"{name} B={b} side 1.0 tile {tile} Morton: runs a tile mean "
                          f"{runs[0].float().mean().item():.1f} max {int(runs[0].max())}; run "
                          "length " + describe(runs[1]))
            for tile in TILES:
                line = []
                for key, order in orders.items():
                    tested, staged = (v.float() for v in grouping.ball_query_tile_candidates(
                        RADIUS, x, c, tile, sf, order))
                    line.append(f"{key} tested mean {tested.mean().item():.1f} max "
                                f"{int(tested.max())} tests {int(tested.sum())}, staged a centre "
                                f"{(staged / tile).mean().item():.1f} a tile mean "
                                f"{staged.mean().item():.1f} max {int(staged.max())}")
                print(f"{name} B={b} side {sf} tile {tile}: " + "; ".join(line), flush=True)


if __name__ == "__main__":
    main()
