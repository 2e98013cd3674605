"""The traced part of a run: torch.profiler over the first steps of the
window, read back from its Chrome trace.

What the readers take from it (`Trace`):
  * `device_ops`: every operation on the device (kernels, copies, sets),
    as (name, start_us, end_us);
  * `ranges`: every host range (`record_function` and the program's
    `train:*` ranges, the harness's `portbench:*` ranges), as (name,
    start_us, end_us);
  * `launches`: the host time of each device operation's launch, by the
    profiler's correlation id, so that a device operation belongs to the host
    range its launch fell in (whatever thread launched it: autograd runs
    the backward on a thread of its own while the caller waits inside the
    range).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    device_ops: list = field(default_factory=list)  # (name, t0, t1, correlation)
    ranges: list = field(default_factory=list)  # (name, t0, t1)
    launches: dict = field(default_factory=dict)  # correlation -> host t
    window_s: float = 0.0  # the traced window's length, by the host's clock
    steps: int = 0  # steps or batches inside it

    @classmethod
    def from_chrome(cls, path: str, window_s: float, steps: int) -> "Trace":
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        t = cls(window_s=window_s, steps=steps)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            t0 = float(e.get("ts", 0.0))
            t1 = t0 + float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                t.device_ops.append((e.get("name", ""), t0, t1, corr))
            elif cat == "user_annotation":
                t.ranges.append((e.get("name", ""), t0, t1))
            elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                t.launches[corr] = t0
        t.device_ops.sort(key=lambda x: x[1])
        return t

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, merged, in us."""
        out = []
        for _, t0, t1, _ in self.device_ops:
            if out and t0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t1)
            else:
                out.append([t0, t1])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_s_in(self, prefix: str) -> float:
        """Seconds of device operations launched inside host ranges whose
        name starts with `prefix` (each operation counted once)."""
        spans = sorted((a, b) for n, a, b in self.ranges if n.startswith(prefix))
        if not spans:
            return 0.0
        starts = [a for a, _ in spans]
        import bisect

        total = 0.0
        for _, t0, t1, corr in self.device_ops:
            at = self.launches.get(corr)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            # spans of one prefix do not nest, so the last that starts before
            # the launch is the only one that can hold it
            if i >= 0 and spans[i][0] <= at <= spans[i][1]:
                total += t1 - t0
        return total * 1e-6

    def count_ranges(self, prefix: str) -> int:
        return sum(1 for n, _, _ in self.ranges if n.startswith(prefix))

    def top_device_ops(self, n: int = 10) -> list:
        by = {}
        for name, t0, t1, _ in self.device_ops:
            by[name[:200]] = by.get(name[:200], 0.0) + (t1 - t0) * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle time between its first and last operation, by the
        innermost host range open at each gap's middle (`host` where none
        is), summed by that range's name."""
        busy = self.busy_intervals()
        ranges = sorted(self.ranges, key=lambda r: r[1])
        by = {}
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = 0.5 * (a + b)
            label, width = "host", float("inf")
            for name, r0, r1 in ranges:
                if r0 > mid:
                    break
                if r1 >= mid and r1 - r0 < width:
                    label, width = name, r1 - r0
            by[label] = by.get(label, 0.0) + (b - a) * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


class Profiler:
    """torch.profiler over a stretch of the run, its trace written to
    `path` (inside the checkout) and read back once it stops."""

    def __init__(self, path: str, cuda: bool):
        import torch

        self.path = path
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def start(self):
        self.prof.start()

    def stop(self, window_s: float, steps: int) -> Trace:
        self.prof.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        try:
            return Trace.from_chrome(self.path, window_s, steps)
        finally:
            os.remove(self.path)
