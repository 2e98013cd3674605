"""mfu.train: Model FLOPs of the window's steps (flops.py) over its time, against 495 TFLOP/s."""

from portbench import readers

LAYER = "Step: make_train_step and the stage-1 fused step"
SOURCE = "host_clock"
MOVES = "train_scenes_per_s"
UNIT = "%"
BETTER = "higher"
WORKLOADS = ["coda-sunrgbd.stage1-train", "baseline-sunrgbd.train"]


def read(run):
    return readers.mfu(run, "train")
