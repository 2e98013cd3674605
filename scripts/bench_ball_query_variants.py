#!/usr/bin/env python3
"""Time kernels B, F and G on their cell grid against the scan kernels they
replaced (scripts/ball_query_variants.cu), on the card, and sweep the cell
side and G's tile.

    python3 scripts/bench_ball_query_variants.py

Scenes (r = 0.2, k = 64, 2048 centres a scene from furthest point sampling):
  * phase3: chip_smoke.py's phase-3 scene, 32 synthetic SUN RGB-D-shaped
    scenes of 20,000 points (datasets/synthetic.py, seed 0);
  * plane: the same with 5,000 points of each scene moved onto z = 1.0;
  * uniform: 32 clouds of 20,000 points uniform in 8 m x 8 m x 3 m;
  * scannet: 8 synthetic scenes of ScanNet's 40,000 points.
On each: B (all scenes) and F (the first 8, the training step's batch) from
the scan kernel and from the grid at a first cell side of 1, 1.5 and 2 widened
radii, each checked bit for bit against the plain version, then timed in
turns twice (chip_smoke.py's timing: CUDA events around back-to-back calls
spanning 5 ms, median of 7, mean of the two turns); the grid build alone at
each side, and its steps alone (the cells kernel, its stable sort as one
array and as one sort a scene, the pack kernel) beside the query alone; the
host's time a call takes to return (at the package's side); the mean and
largest count of candidates a centre tests.  Then kernel G on each scene
(all scenes, k = 64): at tiles of 8, 16, 32 and 64 centres at a cell side of 1
widened radius and at the package's tile at 1.5, each bit for bit against the plain
version, timed in turns with kernel B and the old G (a scan); G's steps
alone (its cells kernel with the centres' keys, the sort of the points' and
centres' keys as one array and of the points' alone, the pack, the query
at each tile, and at its tile with 1 and 16 samples beside B's query at
1, 16 and 64), the host's time a call, and the points a centre
tests and a tile stages at each tile; and G's query in a build of the sources with
-DCODA_TILE_CLOCKS (csrc/ball_query_tile.cu's marks): the span of the
launch, the blocks' durations, how many ran at once, the mean of each part
of a block (its rows, its first chunk's copy, its tests, its outputs) and
the longest blocks beside the points their tile stages and each part's
cycles (tiles of 8, 16 and 32).  Prints the card's name and power limit first.  Needs a GPU and
nvcc; builds the scan kernels into build/.  Exits 1 if any output differs.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from coda_neurips2023_tpu_torch import _kernels  # noqa: E402
from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig  # noqa: E402
from coda_neurips2023_tpu_torch.datasets.synthetic import (  # noqa: E402
    SyntheticDetectionDataset,
    make_batch,
)
from coda_neurips2023_tpu_torch.ops import grouping, sampling  # noqa: E402

SIDES = (1.0, 1.5, 2.0)
RADIUS, K, M = 0.2, 64, 2048


def scenes():
    cfg = SunrgbdAnonymousConfig()

    def synthetic(b, n):
        ds = SyntheticDetectionDataset(cfg, num_scenes=b, num_points=n, seed=0)
        return torch.from_numpy(make_batch(ds, 0, b)["point_clouds"][..., :3].copy()).cuda()

    phase3 = synthetic(32, 20000)
    plane = phase3.clone()
    plane[:, :chip_smoke.PLANE_POINTS, 2] = chip_smoke.PLANE_Z
    g = torch.Generator(device="cuda").manual_seed(0)
    box = torch.tensor([8.0, 8.0, 3.0], device="cuda")
    uniform = torch.rand((32, 20000, 3), device="cuda", generator=g) * box - box * torch.tensor(
        [0.5, 0.5, 0.0], device="cuda")
    return {"phase3": phase3, "plane": plane, "uniform": uniform,
            "scannet": synthetic(8, chip_smoke.SCANNET_POINTS)}


def build_steps(x, side_factor):
    """The grid build's steps timed alone at one side: the cells kernel, the
    stable sort of the keys as one array (the build's) and one sort a scene
    (torch.sort along dim 1, the alternative), the pack kernel; and the
    query alone on the built grid at every side of the sweep."""
    b, n, _ = x.shape
    cap = grouping.grid_cap(n)
    f = torch.empty((b, 4), device="cuda")
    i = torch.empty((b, 4), dtype=torch.int32, device="cuda")
    keys = torch.empty((b * n,), dtype=torch.int32, device="cuda")
    cells = lambda: _kernels.launch("coda_bq_grid_cells", x, None, f, i, keys, b, n, 0,
                                    grouping.grid_side(RADIUS, side_factor), cap)
    cells()
    skeys, perm = torch.sort(keys, stable=True)
    per_scene = keys.view(b, n) - torch.arange(b, device="cuda", dtype=torch.int32)[:, None] * (cap + 1)
    pts = torch.empty((b, n, 4), device="cuda")
    starts = torch.empty((b, cap + 1), dtype=torch.int32, device="cuda")
    pack = lambda: _kernels.launch("coda_bq_grid_pack", x, None, skeys, perm, i, pts, starts, None,
                                   b, n, 0, cap + 1)
    c = sampling.gather_points(x, sampling.furthest_point_sample(x, M))
    idx = torch.empty((b, M, K), dtype=torch.int32, device="cuda")
    steps = {"cells": cells, "sort_flat": lambda: torch.sort(keys, stable=True),
             "sort_per_scene": lambda: torch.sort(per_scene, dim=1, stable=True),
             "pack": pack}
    for sf in SIDES:
        grid = grouping.grid_build(RADIUS, x, sf)
        steps[f"query{sf}"] = lambda grid=grid: _kernels.launch(
            "coda_ball_query", *grid, c, idx, b, n, M, K, cap + 1, float(grouping._r2(RADIUS)),
            grouping.grid_radius(RADIUS))
    return {name: chip_smoke.time_ms(torch, fn) for name, fn in steps.items()}


# (tile, cell side) of G
TILE_RUNS = ((8, 1.0), (16, 1.0), (32, 1.0), (64, 1.0), (grouping.TILE_SIZE, 1.5))


def tile_steps(x, c):
    """Kernel G's steps timed alone at its side: the cells kernel with the
    centres' keys, the sort of all keys and of the points' alone, the pack,
    and the query at each tile."""
    b, n, _ = x.shape
    m = c.shape[1]
    sf = grouping.TILE_SIDE_FACTOR
    cap = grouping.grid_cap(n)
    f = torch.empty((b, 4), device="cuda")
    i = torch.empty((b, 4), dtype=torch.int32, device="cuda")
    keys = torch.empty((b * (n + m),), dtype=torch.int32, device="cuda")
    cells = lambda: _kernels.launch("coda_bq_grid_cells", x, c, f, i, keys, b, n, m,
                                    grouping.grid_side(RADIUS, sf), cap)
    cells()
    skeys, perm = torch.sort(keys, stable=True)
    pts = torch.empty((b, n, 4), device="cuda")
    starts = torch.empty((b, cap + 1), dtype=torch.int32, device="cuda")
    ctr = torch.empty((b, m, 4), device="cuda")
    steps = {"cells": cells, "sort_all": lambda: torch.sort(keys, stable=True),
             "sort_points": lambda: torch.sort(keys[: b * n], stable=True),
             "pack": lambda: _kernels.launch("coda_bq_grid_pack", x, c, skeys, perm, i, pts, starts,
                                             ctr, b, n, m, cap + 1)}
    *grid, ctr = grouping.grid_build(RADIUS, x, sf, "ball_query_tile", centres=c)
    idx = torch.empty((b, m, K), dtype=torch.int32, device="cuda")
    for tile in grouping.TILE_SIZES:
        steps[f"query{tile}"] = lambda tile=tile: _kernels.launch(
            "coda_ball_query_tile", *grid, ctr, idx, b, n, m, K, cap + 1,
            float(grouping._r2(RADIUS)), grouping.grid_radius(RADIUS), tile)
    # the queries alone at fewer samples (fewer hits kept): G at its tile, B
    # on its own grid
    grid_b = grouping.grid_build(RADIUS, x)
    for k in (1, 16):
        out = torch.empty((b, m, k), dtype=torch.int32, device="cuda")
        steps[f"query{grouping.TILE_SIZE}_k{k}"] = lambda k=k, out=out: _kernels.launch(
            "coda_ball_query_tile", *grid, ctr, out, b, n, m, k, cap + 1,
            float(grouping._r2(RADIUS)), grouping.grid_radius(RADIUS), grouping.TILE_SIZE)
    for k in (1, 16, K):
        out = torch.empty((b, m, k), dtype=torch.int32, device="cuda")
        steps[f"queryB_k{k}"] = lambda k=k, out=out: _kernels.launch(
            "coda_ball_query", *grid_b, c, out, b, n, m, k, grid_b[1].shape[1],
            float(grouping._r2(RADIUS)), grouping.grid_radius(RADIUS))
    return {name: chip_smoke.time_ms(torch, fn) for name, fn in steps.items()}


def load_clock_library():
    """The kernels built with -DCODA_TILE_CLOCKS into build/, with G's marks
    (never the package's library, so never a launch of a path)."""
    import ctypes
    import glob

    so = os.path.join(ROOT, "build", "tile_clocks.so")
    srcs = sorted(glob.glob(os.path.join(ROOT, "coda_neurips2023_tpu_torch", "csrc", "*.cu")))
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-DCODA_TILE_CLOCKS", "-shared",
                    "-o", so, *srcs], check=True, stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(so)
    lib.coda_ball_query_tile.argtypes = _kernels._SIGNATURES["coda_ball_query_tile"][1]
    lib.coda_tile_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def tile_clocks(lib, name, x, c, tile):
    """G's query once at `tile` in the clock build: where a block's time goes."""
    b, n, _ = x.shape
    m = c.shape[1]
    *grid, ctr = grouping.grid_build(RADIUS, x, grouping.TILE_SIDE_FACTOR, "ball_query_tile",
                                     centres=c)
    idx = torch.empty((b, m, K), dtype=torch.int32, device="cuda")
    args = [*grid, ctr, idx]
    tail = (b, n, m, K, grid[1].shape[1], float(grouping._r2(RADIUS)),
            grouping.grid_radius(RADIUS), tile, torch.cuda.current_stream().cuda_stream)
    for _ in range(3):  # warm-up, then the launch read
        torch.cuda.synchronize()
        assert lib.coda_tile_clocks_reset() == 0
        assert lib.coda_ball_query_tile(*[a.data_ptr() for a in args], *tail) == 0
        torch.cuda.synchronize()
    assert torch.equal(idx, grouping.ball_query_plain(RADIUS, K, x, c))
    blocks = b * -(-m // tile)
    marks = torch.zeros((blocks, 8), dtype=torch.int64)
    assert lib.coda_tile_clocks(marks.data_ptr(), blocks) == 0
    start, end = marks[:, 0].double(), marks[:, 6].double()
    dur_us = (end - start) / 1e3
    events = torch.cat([start, end]).sort()
    at_once = torch.cat([torch.ones(blocks), -torch.ones(blocks)])[events.indices].cumsum(0).max()
    cyc = marks[:, 1:6].double()
    parts = {"rows": cyc[:, 1] - cyc[:, 0], "first_copy": cyc[:, 2] - cyc[:, 1],
             "tests": cyc[:, 3] - cyc[:, 2], "outputs": cyc[:, 4] - cyc[:, 3]}
    has_chunk = marks[:, 3] > 0
    cand = grouping.ball_query_tile_candidates(RADIUS, x, c, tile)[1].cpu()
    rows = ctr[..., 3].view(torch.int32).cpu().long()
    tile_cand = cand.flatten()[rows.flatten()].view(b, -1)[:, ::tile].flatten()[:blocks]
    q = torch.tensor([0.5, 0.9, 0.99, 1.0], dtype=torch.float64)
    longest = dur_us.argsort(descending=True)[:5]
    print(f"{name} G{tile} clocks: span_us={(end.max() - start.min()).item() / 1e3!r} "
          f"blocks={blocks} most_at_once={int(at_once)} block_us p50/p90/p99/max="
          f"{dur_us.quantile(q).tolist()!r} mean={dur_us.mean().item()!r} "
          + " ".join(f"{k}_cycles_mean={v[has_chunk].mean().item()!r}" for k, v in parts.items())
          + " longest (us, staged, then cycles: rows, first copy, tests, outputs): "
          + repr([(round(dur_us[i].item(), 2), int(tile_cand[i]),
                   *[int(v[i]) for v in parts.values()]) for i in longest])
          + f" staged vs duration corr={torch.corrcoef(torch.stack([dur_us, tile_cand.double()]))[0, 1].item()!r}")


def tile_rows(name, x, c, scan):
    """Kernel G at each (tile, side) of TILE_RUNS against the plain version,
    timed in turns with kernel B and the old G; returns False if any differs."""
    want = grouping.ball_query_plain(RADIUS, K, x, c)
    fns = {f"G{t}_side{sf}": (lambda t=t, sf=sf: grouping.tile_query(RADIUS, K, x, c, t, sf))
           for t, sf in TILE_RUNS}
    fns["B"] = lambda: grouping.grid_query(RADIUS, K, x, c)
    fns["oldG"] = lambda: scan("ball_query_tile", RADIUS, K, x, c)
    ok = True
    for fn_name, fn in fns.items():
        if not torch.equal(fn(), want):
            print(f"  {name} {fn_name}: differs from the plain version")
            ok = False
    times = chip_smoke.time_in_turns(torch, *fns.values())
    cand = {t: [v.float() for v in grouping.ball_query_tile_candidates(RADIUS, x, c, t)]
            for t in grouping.TILE_SIZES}
    print(f"{name} G B={x.shape[0]} N={x.shape[1]} M={M}: "
          + " ".join(f"{n}_ms={t!r}" for n, t in zip(fns, times))
          + " " + " ".join(f"{n}_ms={t!r}" for n, t in tile_steps(x, c).items())
          + f" host_us_a_call={chip_smoke.host_us(torch, fns[f'G{grouping.TILE_SIZE}_side1.0'])!r}"
          + " " + " ".join(f"tile{t}: tested mean {v[0].mean().item()!r} max {int(v[0].max())}"
                           f" staged a centre {(v[1] / t).mean().item()!r} a tile max {int(v[1].max())}"
                           for t, v in cand.items()))
    return ok


def main():
    if not torch.cuda.is_available():
        sys.exit("bench_ball_query_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    so = os.path.join(ROOT, "build", "ball_query_variants.so")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", so,
                    os.path.join(ROOT, "scripts", "ball_query_variants.cu")],
                   check=True, stdout=subprocess.DEVNULL)
    scan = chip_smoke.load_scan_kernels(so)
    _kernels.library()
    clocks = load_clock_library()
    ok = True
    for name, xyz in scenes().items():
        centres = sampling.gather_points(xyz, sampling.furthest_point_sample(xyz, M))
        for grouped, nb in ((False, xyz.shape[0]), (True, 8)):
            x, c = xyz[:nb].contiguous(), centres[:nb].contiguous()
            if grouped:
                want = grouping.ball_query_group_plain(RADIUS, K, x, c)
            else:
                want = (grouping.ball_query_plain(RADIUS, K, x, c),)
            kind = "ball_query_group" if grouped else "ball_query"
            fns = {"scan": lambda: scan(kind, RADIUS, K, x, c)}
            for sf in SIDES:
                fns[f"grid{sf}"] = (lambda sf=sf: grouping.grid_query(RADIUS, K, x, c, grouped, sf))
            for fn_name, fn in fns.items():
                got = fn()
                got = got if grouped else (got,)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    print(f"  {name} {'F' if grouped else 'B'} {fn_name}: differs from the plain version")
                    ok = False
            times = chip_smoke.time_in_turns(torch, *fns.values())
            host_us = chip_smoke.host_us(torch, fns[f"grid{grouping.GRID_SIDE_FACTOR}"])
            builds = [chip_smoke.time_ms(torch, lambda sf=sf: grouping.grid_build(RADIUS, x, sf))
                      for sf in SIDES]
            cand = [grouping.ball_query_grid_candidates(RADIUS, x, c, sf).float() for sf in SIDES]
            if not grouped:
                print(f"{name} build steps at side 1.0, B={nb}: "
                      + " ".join(f"{n}_ms={t!r}" for n, t in build_steps(x, 1.0).items()))
            print(f"{name} {'F' if grouped else 'B'} B={nb} N={x.shape[1]} M={M}: "
                  + " ".join(f"{n}_ms={t!r}" for n, t in zip(fns, times))
                  + " " + " ".join(f"build{sf}_ms={t!r}" for sf, t in zip(SIDES, builds))
                  + f" host_us_a_call={host_us!r}"
                  + " " + " ".join(f"candidates{sf}=mean {t.mean().item()!r} max {int(t.max())}"
                                   for sf, t in zip(SIDES, cand)))
        ok = tile_rows(name, xyz, centres, scan) and ok
        for tile in (8, 16, 32):
            tile_clocks(clocks, name, xyz, centres, tile)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
