"""matcher_wait_ms.train: matcher:wait ms a step over the window: how far the card is behind the host at the step's one sync."""

from portbench import program_spans

LAYER = "Step parts: forward, targets, criterion, backward, optimizer"
SOURCE = "program_span"
MOVES = "train_scenes_per_s"
UNIT = "ms"
BETTER = "lower"
WORKLOADS = ["coda-sunrgbd.stage1-train", "baseline-sunrgbd.train"]


def read(run):
    return program_spans.ms_per_step(run, "train", "matcher:wait", "train:step")
