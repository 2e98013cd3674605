"""idle_share.eval: 1 - the union of device operations over the traced stretch."""

from portbench import readers

LAYER = "Device: the H100"
SOURCE = "device_trace"
MOVES = "eval_scenes_per_s"
UNIT = "%"
BETTER = "lower"
WORKLOADS = ["baseline-sunrgbd.clip-eval"]


def read(run):
    return readers.idle_share(run, "eval")
