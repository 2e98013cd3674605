"""idle_share.train: 1 - the union of device operations over the traced stretch."""

from portbench import readers

LAYER = "Device: the H100"
SOURCE = "device_trace"
MOVES = "train_scenes_per_s"
UNIT = "%"
BETTER = "lower"
WORKLOADS = ["coda-sunrgbd.stage1-train", "baseline-sunrgbd.train"]


def read(run):
    return readers.idle_share(run, "train")
