"""Meters and process helpers.

Counterpart of coda_neurips2023_tpu/utils/misc.py, copied (SmoothedValue,
my_worker_init_fn); `is_primary` is in parallel/dist.py, as the JAX
package's is.
"""

from __future__ import annotations

from collections import deque

import numpy as np


class SmoothedValue:
    """Track a series of values and provide access to smoothed values over a
    window or the global series average."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(np.asarray(self.deque))) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(np.asarray(self.deque))) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median,
            avg=self.avg,
            global_avg=self.global_avg,
            max=self.max,
            value=self.value,
        )


def my_worker_init_fn(worker_id: int):
    """Deterministic per-worker numpy seeding (reference utils/misc.py)."""
    np.random.seed(np.random.get_state()[1][0] + worker_id)
