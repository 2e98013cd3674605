"""loader_wait_share.train: Share of the window the loop spent in the loader's next()."""

from portbench import readers

LAYER = "Loop: engine.train_one_epoch over datasets.loader"
SOURCE = "host_clock"
MOVES = "train_scenes_per_s"
UNIT = "%"
BETTER = "lower"
WORKLOADS = ["coda-sunrgbd.stage1-train", "baseline-sunrgbd.train"]


def read(run):
    return readers.loader_wait_share(run)
