"""load_wait_share.train: Share of the window in the program's train:load spans (the loop's next()), the in-program twin of loader_wait_share.train."""

from portbench import program_spans

LAYER = "Loop: engine.train_one_epoch over datasets.loader"
SOURCE = "program_span"
MOVES = "train_scenes_per_s"
UNIT = "%"
BETTER = "lower"
WORKLOADS = ["coda-sunrgbd.stage1-train", "baseline-sunrgbd.train"]


def read(run):
    return program_spans.share_of_window(run, "train", "train:load")
