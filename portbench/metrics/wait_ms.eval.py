"""wait_ms.eval: Mean host ms of the window's eval:wait spans: the host blocked on a batch's outputs, the card's lead over it."""

from portbench import program_spans

LAYER = "Loop: engine.evaluate and the AP meter"
SOURCE = "program_span"
MOVES = "eval_scenes_per_s"
UNIT = "ms"
BETTER = "lower"
WORKLOADS = ["baseline-sunrgbd.clip-eval"]


def read(run):
    return program_spans.mean_ms(run, "eval", "eval:wait")
