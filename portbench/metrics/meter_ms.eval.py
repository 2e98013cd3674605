"""meter_ms.eval: Mean host AP-meter time a batch over the window (engine.EVAL_STATS meter_s)."""

from portbench import readers

LAYER = "Loop: engine.evaluate and the AP meter"
SOURCE = "program_span"
MOVES = "eval_scenes_per_s"
UNIT = "ms"
BETTER = "lower"
WORKLOADS = ["baseline-sunrgbd.clip-eval"]


def read(run):
    return readers.meter_ms(run)
