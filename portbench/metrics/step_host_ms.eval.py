"""step_host_ms.eval: Mean host ms of the window's eval:step spans: the detector, the crops and the tower launched."""

from portbench import program_spans

LAYER = "Step: make_clip_eval_step"
SOURCE = "program_span"
MOVES = "eval_scenes_per_s"
UNIT = "ms"
BETTER = "lower"
WORKLOADS = ["baseline-sunrgbd.clip-eval"]


def read(run):
    return program_spans.mean_ms(run, "eval", "eval:step")
