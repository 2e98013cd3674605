"""interim_sa_ms.train: Device time a traced step of the operations launched inside the program's encoder:interim spans (the interim set abstraction's forward: FPS 2,048 -> 1,024, ball query, gathers, shared MLP, max; its backward is not counted)."""

from portbench import readers

LAYER = "Model: the masked encoder and its interim SA (models/transformer.py)"
SOURCE = "device_trace"
MOVES = "train_scenes_per_s"
UNIT = "ms"
BETTER = "lower"
WORKLOADS = ["3detr-m-sunrgbd.train"]


def read(run):
    return readers.range_ms_per_step(run, "encoder:interim", "train")
