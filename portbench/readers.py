"""What the per-layer readers (`portbench/metrics/<name>.py`) share: the
window (which a traced stretch follows), the model FLOPs of a step, the device time inside a
host range, and an op's roofline share.  Each reader returns None where its
run has nothing to read."""

from __future__ import annotations

import numpy as np

from portbench import flops


def window_s(run) -> float:
    """The measured window, which the traced stretch follows, in seconds."""
    return run["window_s"]


def step_flops(run) -> float:
    spec = run["spec"]
    w = spec.config["widths"]
    widths = {"detector": dict(w["detector"], heads=w["heads_out"]), "clip": w["clip"]}
    b = run["batch"]
    return flops.step_flops(widths, b, b * int(spec.traffic["crops_per_scene"]),
                            train=run["kind"] == "train")


def mfu(run, kind: str):
    if run["kind"] != kind or run["steps"] < 1:
        return None
    return 100.0 * run["steps"] * step_flops(run) / window_s(run) / flops.PEAK_FLOPS


def range_ms_per_step(run, prefix: str, kind: str):
    tr = run["trace"]
    if (run["kind"] != kind or tr is None or tr.steps < 1 or not tr.device_ops
            or not tr.count_ranges(prefix)):
        return None
    return 1e3 * tr.device_s_in(prefix) / tr.steps


def roofline(run, op: str, kind: str):
    """Least time over device time of the op's calls in the traced stretch, %."""
    tr = run["trace"]
    calls = run["op_calls"].get(op) or []
    if run["kind"] != kind or tr is None or not calls:
        return None
    device_s = tr.device_s_in(f"portbench:{op}")
    if device_s <= 0:
        return None
    least = sum(flops.least_seconds(*flops.attention_cost(*shape)) for shape in calls)
    return 100.0 * least / device_s


def idle_share(run, kind: str):
    tr = run["trace"]
    if run["kind"] != kind or tr is None or tr.window_s <= 0 or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def peak_gib(run, kind: str):
    if run["kind"] != kind or not run["memory_peak_bytes"]:
        return None
    return run["memory_peak_bytes"] / 2 ** 30


def loader_wait_share(run):
    if run["kind"] != "train" or window_s(run) <= 0:
        return None
    return 100.0 * sum(w for _, w in run["loader_waits"]) / window_s(run)


def iter_ms_p95(run):
    """The 95th percentile of the window's iteration periods, with at least
    20 periods."""
    if run["kind"] != "train":
        return None
    periods = np.diff([run["t0"]] + list(run["ends"])) * 1e3
    if len(periods) < 20:
        return None
    return float(np.percentile(periods, 95))


def meter_ms(run):
    stats = run.get("eval_stats") or {}
    if run["kind"] != "eval" or not stats.get("meter_s"):
        return None
    return 1e3 * float(np.mean(stats["meter_s"]))
