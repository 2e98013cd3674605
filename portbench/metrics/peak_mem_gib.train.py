"""peak_mem_gib.train: torch.cuda.max_memory_allocated over set-up and window."""

from portbench import readers

LAYER = "Device: the H100"
SOURCE = "program_counter"
MOVES = "train_scenes_per_s"
UNIT = "GiB"
BETTER = "lower"
WORKLOADS = ["coda-sunrgbd.stage1-train", "baseline-sunrgbd.train"]


def read(run):
    return readers.peak_gib(run, "train")
