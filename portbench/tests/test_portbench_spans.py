"""The readers of the program's spans (`portbench/program_spans.py` and the
ten readers on it or on the `clip:tower` range) against a synthetic ring
and run: the window's cut, each definition's arithmetic, and None wherever
there is nothing to read (a program that keeps no spans, a run of the
other kind, a ring without the span), never 0 for a share."""

import sys
from types import SimpleNamespace

import pytest

from portbench import program_spans
from portbench import run as R
from portbench.trace import Trace

TRAIN_READERS = ("step_host_ms.train", "matcher_wait_ms.train", "matcher_solve_ms.train",
                 "load_wait_share.train", "loader_busy_share.train")
EVAL_READERS = ("step_host_ms.eval", "crops_host_ms.eval", "wait_ms.eval")


def _span(name, t0, t1, step=None, parent=None, workers=None):
    return SimpleNamespace(name=name, t0=t0, t1=t1, step=step, parent=parent, worker=None,
                           workers=workers)


def _run(kind, trace=None):
    # the untraced window is [10, 20]; the traced stretch follows it
    return {"kind": kind, "t0": 10.0, "untraced_end": 20.0, "window_s": 10.0, "trace": trace}


TRAIN_RING = [
    _span("loader:build", 9.0, 10.5, step=0, workers=4),  # 0.5 s inside the window
    _span("train:step", 9.5, 9.9, step=-1),  # set-up: before the window
    _span("matcher:wait", 9.6, 9.7, step=-1, parent="train:criterion"),
    _span("train:load", 10.0, 10.1, step=0),
    _span("matcher:wait", 10.6, 10.65, step=0, parent="train:criterion"),
    _span("matcher:solve", 10.65, 10.66, step=0, parent="train:criterion"),
    _span("train:step", 10.5, 10.9, step=0),
    _span("train:load", 10.9, 11.0, step=1),
    _span("loader:build", 12.0, 13.0, step=1, workers=4),
    _span("matcher:wait", 11.1, 11.2, step=1, parent="train:criterion"),
    _span("matcher:solve", 11.2, 11.21, step=1, parent="train:criterion"),
    _span("train:step", 11.0, 11.4, step=1),
    _span("loader:build", 19.5, 21.0, step=2, workers=4),  # 0.5 s inside
    _span("train:load", 19.9, 20.2, step=2),  # ends in the traced stretch
    _span("matcher:wait", 20.3, 20.9, step=2, parent="train:criterion"),
    _span("train:step", 20.2, 21.0, step=2),
    _span("loader:build", 21.0, 22.0, step=3, workers=4),
]

EVAL_RING = [
    _span("eval:step", 10.0, 11.0, step=0),
    _span("clip:crops", 10.2, 10.3, step=0, parent="eval:step"),
    _span("clip:crops", 10.4, 10.5, step=0, parent="eval:step"),
    _span("eval:wait", 11.0, 11.05, step=0),
    _span("eval:step", 12.0, 14.0, step=1),
    _span("clip:crops", 12.2, 12.3, step=1, parent="eval:step"),
    _span("clip:crops", 12.4, 12.5, step=1, parent="eval:step"),
    _span("clip:crops", 13.0, 13.5, step=1, parent=None),  # not the eval step's
    _span("eval:wait", 14.0, 14.07, step=1),
    _span("eval:step", 15.0, 18.0, step=2),
    _span("clip:crops", 15.2, 15.3, step=2, parent="eval:step"),
    _span("clip:crops", 15.4, 15.5, step=2, parent="eval:step"),
    _span("eval:step", 19.5, 20.5, step=3),  # ends in the traced stretch
    _span("clip:crops", 20.1, 20.2, step=3, parent="eval:step"),
]


def _read(name, run):
    return R.load_reader(name).read(run)


def test_train_readers(monkeypatch):
    monkeypatch.setattr(program_spans, "ring", lambda: list(TRAIN_RING))
    run = _run("train")
    assert _read("step_host_ms.train", run) == pytest.approx(1e3 * (0.35 + 0.3) / 2)
    assert _read("matcher_wait_ms.train", run) == pytest.approx(1e3 * 0.15 / 2)
    assert _read("matcher_solve_ms.train", run) == pytest.approx(1e3 * 0.02 / 2)
    assert _read("load_wait_share.train", run) == pytest.approx(100 * 0.2 / 10)
    assert _read("loader_busy_share.train", run) == pytest.approx(100 * 2.0 / (10 * 4))
    for name in EVAL_READERS:
        assert _read(name, run) is None, name


def test_eval_readers(monkeypatch):
    monkeypatch.setattr(program_spans, "ring", lambda: list(EVAL_RING))
    run = _run("eval")
    assert _read("step_host_ms.eval", run) == pytest.approx(1e3 * 2.0)
    assert _read("crops_host_ms.eval", run) == pytest.approx(1e3 * 0.2)
    assert _read("wait_ms.eval", run) == pytest.approx(1e3 * 0.06)
    for name in TRAIN_READERS:
        assert _read(name, run) is None, name


@pytest.mark.parametrize("ring", [None, []], ids=["no-span-module", "empty-ring"])
def test_nothing_to_read_is_none(monkeypatch, ring):
    monkeypatch.setattr(program_spans, "ring", lambda: ring)
    for name in TRAIN_READERS:
        assert _read(name, _run("train")) is None, name
    for name in EVAL_READERS:
        assert _read(name, _run("eval")) is None, name


def test_a_share_without_its_span_is_none(monkeypatch):
    steps_only = [s for s in TRAIN_RING if s.name == "train:step"]
    monkeypatch.setattr(program_spans, "ring", lambda: steps_only)
    run = _run("train")
    for name in ("load_wait_share.train", "loader_busy_share.train", "matcher_wait_ms.train",
                 "matcher_solve_ms.train"):
        assert _read(name, run) is None, name
    assert _read("step_host_ms.train", run) == pytest.approx(400.0)


def test_a_program_without_spans_reads_none(monkeypatch):
    import coda_neurips2023_tpu_torch.utils as utils

    assert isinstance(program_spans.ring(), list)
    monkeypatch.delattr(utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "coda_neurips2023_tpu_torch.utils.spans", None)
    assert program_spans.ring() is None
    assert _read("step_host_ms.train", _run("train")) is None


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_tower_ms_reads_the_tower_range(kind):
    # two traced steps; device ops launched inside clip:tower count, the rest do not
    trace = Trace(device_ops=[("gemm", 10.0, 1010.0, 1), ("gemm", 1100.0, 3100.0, 2),
                              ("other", 3200.0, 9200.0, 3)],
                  ranges=[("clip:tower", 0.0, 100.0), ("clip:tower", 200.0, 300.0),
                          ("train:targets", 0.0, 400.0)],
                  launches={1: 50.0, 2: 250.0, 3: 350.0}, window_s=1.0, steps=2)
    other = "eval" if kind == "train" else "train"
    assert _read(f"tower_ms.{kind}", _run(kind, trace)) == pytest.approx(3.0 / 2)
    assert _read(f"tower_ms.{other}", _run(kind, trace)) is None
    trace.ranges = [r for r in trace.ranges if r[0] != "clip:tower"]
    assert _read(f"tower_ms.{kind}", _run(kind, trace)) is None
    assert _read(f"tower_ms.{kind}", _run(kind)) is None
