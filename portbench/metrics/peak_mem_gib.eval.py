"""peak_mem_gib.eval: torch.cuda.max_memory_allocated over set-up and window."""

from portbench import readers

LAYER = "Device: the H100"
SOURCE = "program_counter"
MOVES = "eval_scenes_per_s"
UNIT = "GiB"
BETTER = "lower"
WORKLOADS = ["baseline-sunrgbd.clip-eval"]


def read(run):
    return readers.peak_gib(run, "eval")
