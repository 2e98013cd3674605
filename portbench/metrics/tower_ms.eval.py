"""tower_ms.eval: Device time a traced batch of the operations launched inside the program's clip:tower spans (the frozen image tower)."""

from portbench import readers

LAYER = "Step: make_clip_eval_step"
SOURCE = "device_trace"
MOVES = "eval_scenes_per_s"
UNIT = "ms"
BETTER = "lower"
WORKLOADS = ["baseline-sunrgbd.clip-eval"]


def read(run):
    return readers.range_ms_per_step(run, "clip:tower", "eval")
