"""vit_attention_roofline.eval: vit_attention's least time (flops.py) over its device time, at its entry in models.clip."""

from portbench import readers

LAYER = "Kernels: ops and csrc through _kernels"
SOURCE = "device_trace"
MOVES = "eval_scenes_per_s"
UNIT = "%"
BETTER = "higher"
WORKLOADS = ["baseline-sunrgbd.clip-eval"]


def read(run):
    return readers.roofline(run, "vit_attention", "eval")
