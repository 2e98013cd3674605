"""matcher_solve_ms.train: matcher:solve ms a step over the window: scipy's assignments and their copy back up."""

from portbench import program_spans

LAYER = "Step parts: forward, targets, criterion, backward, optimizer"
SOURCE = "program_span"
MOVES = "train_scenes_per_s"
UNIT = "ms"
BETTER = "lower"
WORKLOADS = ["coda-sunrgbd.stage1-train", "baseline-sunrgbd.train"]


def read(run):
    return program_spans.ms_per_step(run, "train", "matcher:solve", "train:step")
