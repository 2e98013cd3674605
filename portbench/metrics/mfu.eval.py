"""mfu.eval: Model FLOPs of the window's batches (flops.py) over its time, against 495 TFLOP/s."""

from portbench import readers

LAYER = "Step: make_clip_eval_step"
SOURCE = "host_clock"
MOVES = "eval_scenes_per_s"
UNIT = "%"
BETTER = "higher"
WORKLOADS = ["baseline-sunrgbd.clip-eval"]


def read(run):
    return readers.mfu(run, "eval")
