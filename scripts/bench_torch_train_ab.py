#!/usr/bin/env python3
"""Time chip_smoke.py's two training phases (8: the baseline step, 10: the
stage-1 step) for one or more checkouts of the repo, each in its own
process, in the order given, on one card.

    python3 scripts/bench_torch_train_ab.py PARENT_DIR . . PARENT_DIR

Each directory is the root of a checkout (e.g. a `git archive` of another
commit unpacked under build/); its own chip_smoke.py and package run, with
their own kernel build.  The steps are host-bound, so two versions are
compared only in turns within one call (parent, change, change, parent).
Prints each phase's median, min and max step ms and the matcher's host ms.
"""
import os
import subprocess
import sys

_PHASES = r'''
import os, sys
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke as cs
from coda_neurips2023_tpu_torch import _kernels
from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset, make_batch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_kernels.library()
print("tree", root, flush=True)
cfg = SunrgbdAnonymousConfig()


def batches(**kw):
    ds = SyntheticDetectionDataset(cfg, num_scenes=(cs.TRAIN_STEPS + 1) * cs.TRAIN_BATCH,
                                   num_points=cs.NUM_POINTS, seed=cs.SEED, **kw)
    return [{k: torch.from_numpy(v).cuda()
             for k, v in make_batch(ds, i * cs.TRAIN_BATCH, cs.TRAIN_BATCH).items()}
            for i in range(cs.TRAIN_STEPS + 1)]


with cs.bq_env(CODA_BQ_FUSED_GATHER="1"):
    cs.train_phase(torch, cfg, batches())
with cs.bq_env(CODA_BQ_ALGO="adaptive"):
    cs.stage1_phase(torch, cfg, batches(with_images=True, image_hw=cs.IMAGE_HW))
'''


def main():
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    rc = 0
    for tree in sys.argv[1:]:
        proc = subprocess.run([sys.executable, "-c", _PHASES, tree], capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("tree") or "step ms" in line or "matcher" in line:
                print(line, flush=True)
        if proc.returncode:
            print(proc.stderr[-2000:], file=sys.stderr)
            rc = proc.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
