"""step_host_ms.train: Mean host ms of the window's train:step spans less each one's matcher:wait: the main thread's time launching a step."""

from portbench import program_spans

LAYER = "Step: make_train_step and the stage-1 fused step"
SOURCE = "program_span"
MOVES = "train_scenes_per_s"
UNIT = "ms"
BETTER = "lower"
WORKLOADS = ["coda-sunrgbd.stage1-train", "baseline-sunrgbd.train"]


def read(run):
    return program_spans.step_host_ms(run)
