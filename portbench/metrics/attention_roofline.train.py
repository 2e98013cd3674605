"""attention_roofline.train: masked_attention's least time (flops.py) over its device time, at its entry in models.transformer."""

from portbench import readers

LAYER = "Kernels: ops and csrc through _kernels"
SOURCE = "device_trace"
MOVES = "train_scenes_per_s"
UNIT = "%"
BETTER = "higher"
WORKLOADS = ["coda-sunrgbd.stage1-train", "baseline-sunrgbd.train"]


def read(run):
    return readers.roofline(run, "attention", "train")
