"""masked_encoder_ms.train: Device time a traced step of the operations launched inside the program's encoder:masked spans (the masked encoder's forward; its backward runs on the autograd thread, where no host span labels it, and is not counted)."""

from portbench import readers

LAYER = "Model: the masked encoder and its interim SA (models/transformer.py)"
SOURCE = "device_trace"
MOVES = "train_scenes_per_s"
UNIT = "ms"
BETTER = "lower"
WORKLOADS = ["3detr-m-sunrgbd.train"]


def read(run):
    return readers.range_ms_per_step(run, "encoder:masked", "train")
