"""loader_busy_share.train: loader:build seconds overlapping the window over the window times the loader's worker count: how busy its workers are."""

from portbench import program_spans

LAYER = "Loop: engine.train_one_epoch over datasets.loader"
SOURCE = "program_span"
MOVES = "train_scenes_per_s"
UNIT = "%"
BETTER = "lower"
WORKLOADS = ["coda-sunrgbd.stage1-train", "baseline-sunrgbd.train"]


def read(run):
    return program_spans.loader_busy_share(run)
