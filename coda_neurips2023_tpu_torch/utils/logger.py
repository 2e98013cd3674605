"""Scalar logging.

Counterpart of coda_neurips2023_tpu/utils/logger.py, copied: tensorboardX
scalars (when tensorboardX is installed) under the reference's Train/,
Train_details/ and Test/ prefixes, and a machine-readable metrics.jsonl in
the log directory.  Only the primary process writes."""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from coda_neurips2023_tpu_torch.utils.misc import is_primary


class Logger:
    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self.writer = None
        self.jsonl = None
        if log_dir is not None and is_primary():
            os.makedirs(log_dir, exist_ok=True)
            try:
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(log_dir)
            except Exception:
                self.writer = None
            self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log_scalars(self, scalar_dict: dict, step: int, prefix: Optional[str] = None):
        if self.jsonl is not None:
            rec = {"step": int(step), "time": time.time()}
            rec.update({(prefix or "") + k: float(v) for k, v in scalar_dict.items()})
            self.jsonl.write(json.dumps(rec) + "\n")
            self.jsonl.flush()
        if self.writer is None:
            return
        for k, v in scalar_dict.items():
            name = (prefix or "") + k
            self.writer.add_scalar(name, float(v), step)

    def close(self):
        if self.writer is not None:
            self.writer.close()
        if self.jsonl is not None:
            self.jsonl.close()
