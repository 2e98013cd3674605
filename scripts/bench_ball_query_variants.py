#!/usr/bin/env python3
"""Time kernels B and F on their cell grid against the scan kernels they
replaced (scripts/ball_query_variants.cu), on the card, and sweep the cell side.

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
largest count of candidates a centre tests.  Prints
the card's name and power limit first.  Needs a GPU and nvcc; builds the scan
kernels into build/.  Exits 1 if any output differs.
"""
import os
import subprocess
import sys
import time

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
    cells = lambda: _kernels.launch("coda_bq_grid_cells", x, f, i, keys, b, n,
                                    grouping.grid_side(RADIUS, side_factor), cap)
    cells()
    skeys, perm = torch.sort(keys, stable=True)
    per_scene = keys.view(b, n) - torch.arange(b, device="cuda", dtype=torch.int32)[:, None] * (cap + 1)
    pts = torch.empty((b, n, 4), device="cuda")
    starts = torch.empty((b, cap + 1), dtype=torch.int32, device="cuda")
    pack = lambda: _kernels.launch("coda_bq_grid_pack", x, skeys, perm, i, pts, starts, b, n, cap + 1)
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
    ok = True
    for name, xyz in scenes().items():
        centres = sampling.gather_points(xyz, sampling.furthest_point_sample(xyz, M))
        for grouped, nb in ((False, xyz.shape[0]), (True, 8)):
            x, c = xyz[:nb].contiguous(), centres[:nb].contiguous()
            if grouped:
                want = grouping.ball_query_group_plain(RADIUS, K, x, c)
            else:
                want = (grouping.ball_query_plain(RADIUS, K, x, c),)
            fns = {"scan": lambda: scan(grouped, RADIUS, K, x, c)}
            for sf in SIDES:
                fns[f"grid{sf}"] = (lambda sf=sf: grouping.grid_query(RADIUS, K, x, c, grouped, sf))
            for fn_name, fn in fns.items():
                got = fn()
                got = got if grouped else (got,)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    print(f"  {name} {'F' if grouped else 'B'} {fn_name}: differs from the plain version")
                    ok = False
            times = chip_smoke.time_in_turns(torch, *fns.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fns[f"grid{grouping.GRID_SIDE_FACTOR}"]()
            host_us = (time.perf_counter() - t0) / 20 * 1e6  # the calls' enqueue, no sync
            torch.cuda.synchronize()
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
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
