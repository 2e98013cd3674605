"""Host spans: where the program's threads spend their time, step by step.

`with span(name):` times a block on `time.perf_counter()` and appends the
`Span` to `RING`, a bounded in-memory deque that the newest spans push the
oldest out of; `record(...)` appends a span whose stamps were taken
elsewhere (a loader worker stamps its own build and the loop records it
when it hands the batch out).
`perf_counter` is CLOCK_MONOTONIC on Linux, one clock for every process of
the machine, so a worker's stamps and the loop's compare directly.

Each span keeps its `parent`, the innermost span open on the same thread
when it opened, and its `step`, the loop's iteration or batch index, which a
span without one takes from its parent: every span of one training step
shares the step's index.  `worker` is None on the main thread.

While torch.profiler runs, `span` also opens a `record_function` range of
the same name, so a trace shows each span on the profiler's clock beside
the kernels launched inside it; otherwise it costs about a microsecond.

Every name the program opens is in `NAMES`.  No two spans of one name
nest, and no name begins with another's as a prefix where a reader sums a
prefix's device time.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from typing import Optional

NAMES = (
    # engine.train_one_epoch: the loader's next(), the copy to the card, the
    # step (with stage 2's discovery), the losses' read-back
    "train:load", "train:to_device", "train:step", "train:drain",
    # engine.make_train_step's parts, inside train:step
    "train:forward", "train:targets", "train:criterion", "train:backward", "train:allreduce",
    "train:optimizer",
    # ops/hungarian.py, inside train:criterion: the cost's copy down (it
    # waits for the device) and scipy's solve with the copy back up
    "matcher:wait", "matcher:solve",
    # engine.evaluate: next(), the copy to the card, the eval step, the
    # outputs' pinned copies back, the wait for them, the AP meter
    "eval:load", "eval:to_device", "eval:step", "eval:copy", "eval:wait", "eval:meter",
    # the detector's forward inside eval:step
    "eval:detector",
    # the CLIP crops cut and normalised, and the frozen image tower
    "clip:crops", "clip:tower",
    # models/transformer.py, the masked encoder alone (--enc_type masked):
    # its forward, inside it the interim SA and each radius-masked attention
    # call (under --remat a layer's recompute opens encoder:radius again, on
    # the autograd thread)
    "encoder:masked", "encoder:interim", "encoder:radius",
    # datasets/loader.py: one batch built by a worker, recorded on receipt
    "loader:build",
)

RING_SIZE = 65536

_local = threading.local()
_MAIN = threading.main_thread().ident
_enabled = None  # torch's profiler-enabled check, once torch is imported


class Span:
    """One span: `name`; `parent`, the name of the innermost span open on
    the same thread when it opened (None for a recorded one); `t0` and `t1`
    on perf_counter; `step`; `worker` (None on the main thread); `workers`,
    on a loader:build, the count of the loader's workers.

    As a context manager (`span(name, step=None)`), it stamps the block and
    joins RING when the block ends, an exception included."""

    __slots__ = ("name", "parent", "t0", "t1", "step", "worker", "workers", "_range")

    def __init__(self, name: str, step: Optional[int] = None, parent: Optional[str] = None,
                 t0: float = 0.0, t1: float = 0.0, worker=None, workers: Optional[int] = None):
        self.name, self.step, self.parent = name, step, parent
        self.t0, self.t1, self.worker, self.workers = t0, t1, worker, workers

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, parent={self.parent!r}, t0={self.t0!r}, t1={self.t1!r}, "
                f"step={self.step!r}, worker={self.worker!r}, workers={self.workers!r})")

    def __enter__(self) -> "Span":
        global _enabled
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        if stack:
            top = stack[-1]
            self.parent = top.name
            if self.step is None:
                self.step = top.step
        stack.append(self)
        self._range = None
        if _enabled is None and "torch" in sys.modules:
            _enabled = sys.modules["torch"]._C._autograd._profiler_enabled
        if _enabled is not None and _enabled():
            import torch

            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _local.stack.pop()
        if threading.get_ident() != _MAIN:
            self.worker = threading.get_ident()
        RING.append(self)
        return False


span = Span

RING: collections.deque = collections.deque(maxlen=RING_SIZE)


def record(name: str, t0: float, t1: float, step: Optional[int] = None,
           worker=None, workers: Optional[int] = None) -> None:
    """A span stamped elsewhere (perf_counter's t0 and t1), with no parent."""
    RING.append(Span(name, step, None, t0, t1, worker, workers))


def between(t0: float, t1: float) -> list:
    """The spans in RING that end inside [t0, t1], in the ring's order."""
    return [s for s in list(RING) if t0 <= s.t1 <= t1]
