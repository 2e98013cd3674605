"""What the readers of the program's own spans share.

The program keeps its host spans in an in-memory ring
(`coda_neurips2023_tpu_torch.utils.spans.RING`), which the readers read in
the run's own process once the run is over.  A program without that module
keeps no spans: every function here then returns None, and so does each
reader.  Host-clock numbers take only spans that end inside the untraced
window [run["t0"], run["untraced_end"]], so a profiler's slowdown stays out
of them; each span has `name`, `parent`, `t0`, `t1` (perf_counter, the
clock of the window's stamps) and `step`."""

from __future__ import annotations


def ring():
    """The program's spans, oldest first, or None where it keeps none."""
    try:
        from coda_neurips2023_tpu_torch.utils import spans
    except ImportError:
        return None
    return list(spans.RING)


def in_window(run, kind: str):
    """The spans that end inside the untraced window, or None where the
    program keeps none or the run is not of `kind`."""
    spans = ring()
    if spans is None or run["kind"] != kind or run["untraced_end"] is None:
        return None
    return [s for s in spans if run["t0"] <= s.t1 <= run["untraced_end"]]


def seconds(spans, name: str, parent=None) -> list:
    return [s.t1 - s.t0 for s in spans
            if s.name == name and (parent is None or s.parent == parent)]


def mean_ms(run, kind: str, name: str):
    """Mean host ms of the window's `name` spans."""
    spans = in_window(run, kind)
    durations = seconds(spans or [], name)
    if not durations:
        return None
    return 1e3 * sum(durations) / len(durations)


def ms_per_step(run, kind: str, name: str, step: str, parent=None):
    """Host ms of the window's `name` spans (under `parent` where given)
    over the count of its `step` spans."""
    spans = in_window(run, kind)
    steps = len(seconds(spans or [], step))
    durations = seconds(spans or [], name, parent)
    if not steps or not durations:
        return None
    return 1e3 * sum(durations) / steps


def step_host_ms(run):
    """Mean over the window's train:step spans of each one's host ms less
    its matcher:wait (the spans of one step share its `step`)."""
    spans = in_window(run, "train")
    steps = [s for s in spans or [] if s.name == "train:step"]
    if not steps:
        return None
    wait = {}
    for s in spans:
        if s.name == "matcher:wait":
            wait[s.step] = wait.get(s.step, 0.0) + s.t1 - s.t0
    return 1e3 * sum(s.t1 - s.t0 - wait.get(s.step, 0.0) for s in steps) / len(steps)


def share_of_window(run, kind: str, name: str):
    """The window's `name` seconds over its length, %."""
    spans = in_window(run, kind)
    durations = seconds(spans or [], name)
    if not durations or run["window_s"] <= 0:
        return None
    return 100.0 * sum(durations) / run["window_s"]


def loader_busy_share(run):
    """loader:build seconds overlapping the window over the window times
    the loader's worker count, %.  A build is recorded when its batch is
    handed out, so builds overlapping the window that were still queued
    when the run ended are not counted."""
    spans = ring()
    if spans is None or run["kind"] != "train" or run["untraced_end"] is None:
        return None
    a, b = run["t0"], run["untraced_end"]
    builds = [s for s in spans if s.name == "loader:build" and s.t1 > a and s.t0 < b]
    if not builds or b <= a:
        return None
    workers = max(s.workers or 1 for s in builds)
    busy = sum(min(s.t1, b) - max(s.t0, a) for s in builds)
    return 100.0 * busy / ((b - a) * workers)
