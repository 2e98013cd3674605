"""crops_host_ms.eval: Host ms a batch of the window's clip:crops spans inside eval:step (the crops cut and normalised, a span a scene)."""

from portbench import program_spans

LAYER = "Step: make_clip_eval_step"
SOURCE = "program_span"
MOVES = "eval_scenes_per_s"
UNIT = "ms"
BETTER = "lower"
WORKLOADS = ["baseline-sunrgbd.clip-eval"]


def read(run):
    return program_spans.ms_per_step(run, "eval", "clip:crops", "eval:step", parent="eval:step")
