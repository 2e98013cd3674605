"""iter_ms_p95.train: 95th percentile of the window's iteration periods, between the returns of successive steps."""

from portbench import readers

LAYER = "Loop: engine.train_one_epoch over datasets.loader"
SOURCE = "host_clock"
MOVES = "train_scenes_per_s"
UNIT = "ms"
BETTER = "lower"
WORKLOADS = ["coda-sunrgbd.stage1-train", "baseline-sunrgbd.train"]


def read(run):
    return readers.iter_ms_p95(run)
