"""Time the host AP meter's parse_predictions on one eval batch.

    python -m coda_neurips2023_tpu_torch.utils.meter_bench [--scans 32] [--repeats 3]

One batch of the flagship eval's shape (32 synthetic SUN RGB-D scenes of
20,000 points, 128 proposals a scene: half of them jittered ground-truth
boxes, half random boxes) goes through `ap_calculator.parse_predictions`
serially (CODA_AP_WORKERS=0) and on pools of 4 and 8 workers, each pool
with its workers' BLAS capped at one thread (`_one_blas_thread`, the
default) and without the cap, in turns, after each pool has started and
run one batch.  Prints one JSON line a setting: wall ms a batch (median and
all repeats), and the in-hull and NMS ms summed over the processes that ran
them.  Needs numpy and scipy only; the numbers depend on the host's cores.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time


def _no_cap():
    """The pool's initializer for the uncapped runs."""


def make_batch(scans: int, proposals: int = 128, num_points: int = 20000, seed: int = 0):
    import numpy as np

    from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
    from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset

    ds = SyntheticDetectionDataset(SunrgbdAnonymousConfig(), num_scenes=scans,
                                   num_points=num_points, seed=seed)
    rng = np.random.default_rng(seed)
    pcs, corners = [], np.zeros((scans, proposals, 8, 3), np.float32)
    for i in range(scans):
        s = ds[i]
        pcs.append(s["point_clouds"])
        real = np.flatnonzero(s["gt_box_present"])
        for j in range(proposals):
            if j % 2 == 0:
                corners[i, j] = s["gt_box_corners"][real[j // 2 % len(real)]] + rng.normal(
                    0, 0.05, (1, 3))
            else:
                c = rng.uniform(-3, 3, 3)
                corners[i, j] = c + rng.uniform(0.1, 1.0, 3) * rng.choice([-1, 1], (8, 3))
    sem = rng.dirichlet(np.ones(46), (scans, proposals)).astype(np.float32)
    obj = rng.uniform(0, 1, (scans, proposals)).astype(np.float32)
    return corners, sem, obj, np.stack(pcs)


def main(argv=None):
    from coda_neurips2023_tpu_torch.datasets.config import SunrgbdImageConfig
    from coda_neurips2023_tpu_torch.utils import ap_calculator

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scans", type=int, default=32)
    p.add_argument("--repeats", type=int, default=3)
    a = p.parse_args(argv)
    batch = make_batch(a.scans)
    conf = ap_calculator.get_ap_config_dict(dataset_config=SunrgbdImageConfig())
    capped = ap_calculator._one_blas_thread
    settings = [(0, True), (4, True), (4, False), (8, True), (8, False)]
    for workers, cap in settings:
        os.environ["CODA_AP_WORKERS"] = str(workers)
        ap_calculator.close_pool()
        ap_calculator._one_blas_thread = capped if cap else _no_cap
        try:
            ap_calculator.parse_predictions(*batch, conf)  # start the pool's workers
            walls, hull, nms = [], [], []
            for _ in range(a.repeats):
                ap_calculator.reset_meter()
                t0 = time.perf_counter()
                ap_calculator.parse_predictions(*batch, conf)
                walls.append((time.perf_counter() - t0) * 1e3)
                hull.append(ap_calculator.METER["in_hull_s"] * 1e3)
                nms.append(ap_calculator.METER["nms_s"] * 1e3)
        finally:
            ap_calculator.close_pool()
            ap_calculator._one_blas_thread = capped
        print(json.dumps({
            "workers": workers, "blas_one_thread": cap if workers else None,
            "scans": a.scans, "ms": statistics.median(walls), "ms_all": walls,
            "in_hull_ms_summed": statistics.median(hull), "nms_ms_summed": statistics.median(nms),
            "cpu_count": os.cpu_count(),
        }))


if __name__ == "__main__":
    main()
