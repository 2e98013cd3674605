"""tower_ms.train: Device time a traced step of the operations launched inside the program's clip:tower spans (the frozen image tower)."""

from portbench import readers

LAYER = "Step parts: forward, targets, criterion, backward, optimizer"
SOURCE = "device_trace"
MOVES = "train_scenes_per_s"
UNIT = "ms"
BETTER = "lower"
WORKLOADS = ["coda-sunrgbd.stage1-train"]


def read(run):
    return readers.range_ms_per_step(run, "clip:tower", "train")
