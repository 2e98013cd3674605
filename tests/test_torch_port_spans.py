"""The port's host spans (coda_neurips2023_tpu_torch/utils/spans.py), on the CPU.

  * nested spans keep their parent and share their step; the ring keeps the
    newest RING_SIZE spans;
  * a span whose block raises is closed and recorded all the same;
  * under torch.profiler each span is a `user_annotation` range of its
    name in the trace; with no profiler running no range is opened;
  * a tiny training epoch (`engine.train_one_epoch` over the baseline's
    step at the widths of tests/test_torch_port_model.py) records, each
    step, train:load, train:to_device and train:step, which holds
    train:forward, train:criterion (holding matcher:wait and
    matcher:solve), train:backward, train:allreduce and train:optimizer;
    the status line prints the synchronized iter_time and the host ms;
  * a tiny CLIP-crop `engine.evaluate` records its eval:* spans, with
    eval:detector, a clip:crops and a clip:tower a scene inside eval:step,
    and EVAL_STATS's load_s, wait_s and meter_s are those spans' durations;
  * the loader's thread and process workers stamp each batch's build on the
    parent's clock (loader:build, with the worker and the count of
    workers), and their batches are bit-equal to those built in the
    parent's thread.
"""

import functools
import json
import os
import time
import types

import numpy as np
import pytest
import torch

from coda_neurips2023_tpu_torch import engine
from coda_neurips2023_tpu_torch.criterion import build_criterion
from coda_neurips2023_tpu_torch.datasets import loader as tloader
from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset, make_batch
from coda_neurips2023_tpu_torch.models.distillation import clip_crop_scores
from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
from coda_neurips2023_tpu_torch.optimizer import build_optimizer
from coda_neurips2023_tpu_torch.stages import StageContext
from coda_neurips2023_tpu_torch.utils import spans
from coda_neurips2023_tpu_torch.utils.spans import RING, span

from test_torch_port_model import TINY
from test_torch_port_train import _args
from torch_one_thread import one_intra_op_thread  # noqa: F401

STEP_PARTS = ("train:forward", "train:criterion", "train:backward", "train:allreduce",
              "train:optimizer")


@pytest.fixture(autouse=True)
def empty_ring():
    RING.clear()
    yield
    RING.clear()


def _tiny_model(seed=0):
    model = CoDA3DETR(SunrgbdAnonymousConfig(), **TINY, device="cpu")
    with torch.no_grad():
        reset_parameters(model, torch.Generator().manual_seed(seed))
    return model


def _inside(child, parent):
    return parent.t0 <= child.t0 <= child.t1 <= parent.t1


# ---------------------------------------------------------------- the facility


def test_nested_spans_keep_parent_and_step_and_the_ring_is_bounded():
    with span("train:step", step=7) as outer:
        with span("train:criterion"):
            with span("matcher:wait") as inner:
                pass
        with span("train:optimizer", step=9):
            pass
    names = [(s.name, s.parent, s.step, s.worker) for s in RING]
    assert names == [("matcher:wait", "train:criterion", 7, None),
                     ("train:criterion", "train:step", 7, None),
                     ("train:optimizer", "train:step", 9, None),
                     ("train:step", None, 7, None)]
    assert _inside(inner, outer) and inner.t0 < inner.t1
    assert spans.between(inner.t0, inner.t1) == [inner]
    assert spans.between(outer.t0, outer.t1) == list(RING)

    assert RING.maxlen == spans.RING_SIZE == 65536
    for i in range(spans.RING_SIZE + 5):
        spans.record("loader:build", i, i + 0.5, step=i, worker=3, workers=4)
    assert len(RING) == spans.RING_SIZE
    assert RING[0].step == 5 and RING[-1].step == spans.RING_SIZE + 4
    assert (RING[-1].parent, RING[-1].worker, RING[-1].workers) == (None, 3, 4)


def test_a_span_that_raises_is_closed_and_recorded():
    with pytest.raises(ValueError):
        with span("train:step", step=1):
            with span("train:forward"):
                raise ValueError("in the forward")
    assert [(s.name, s.parent) for s in RING] == [("train:forward", "train:step"),
                                                  ("train:step", None)]
    with span("train:load"):
        pass
    assert RING[-1].parent is None  # the stack was unwound
    assert all(s.t0 <= s.t1 for s in RING)


def test_ranges_under_the_profiler_and_none_without(monkeypatch, tmp_path):
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with span("train:step"), span("train:forward"):
        torch.ones(4).sum()
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("train:step"), span("train:forward"):
            torch.ones(4).sum()
    assert opened == ["train:step", "train:forward"]
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(ranges) == ["train:forward", "train:step"]
    assert len(RING) == 4


# ---------------------------------------------------------------- the training loop


def test_train_one_epoch_records_each_step():
    args = _args()
    model = _tiny_model()
    optimizer, schedule = build_optimizer(args, model, 600)
    step = engine.make_train_step(model, build_criterion(args, SunrgbdAnonymousConfig()),
                                  optimizer, schedule)
    ds = SyntheticDetectionDataset(SunrgbdAnonymousConfig(), num_scenes=4, num_points=1024)
    batches = [make_batch(ds, 0, 2), make_batch(ds, 2, 2)]
    lines = []
    engine.train_one_epoch(step, batches, log_every=1, log=lines.append, device="cpu",
                           optimizer=optimizer, seed=0)
    assert all(n in spans.NAMES for n in {s.name for s in RING})
    for it in range(2):
        own = [s for s in RING if s.step == it and s.name != "train:drain"]
        assert [s.name for s in own] == [
            "train:load", "train:to_device", "train:forward", "matcher:wait", "matcher:solve",
            "train:criterion", "train:backward", "train:allreduce", "train:optimizer",
            "train:step"]
        by = {s.name: s for s in own}
        outer = by["train:step"]
        assert by["train:load"].t1 <= by["train:to_device"].t0 <= by["train:to_device"].t1 <= \
            outer.t0
        for name in STEP_PARTS:
            assert by[name].parent == "train:step" and _inside(by[name], outer), name
        for name in ("matcher:wait", "matcher:solve"):
            assert by[name].parent == "train:criterion", name
            assert _inside(by[name], by["train:criterion"]), name
        assert by["matcher:wait"].t1 <= by["matcher:solve"].t0
    # the loop's last next() finds the end of the batches
    assert [s.name for s in RING if s.step == 2] == ["train:load"]
    assert sum(s.name == "train:drain" for s in RING) == 3  # two lines and the epoch's tail
    assert len(lines) == 2 and all("iter_time" in line and " host " in line for line in lines)


# ---------------------------------------------------------------- the eval loop


def test_evaluate_records_its_spans_and_eval_stats_are_theirs(monkeypatch):
    monkeypatch.setenv("CODA_AP_WORKERS", "0")
    model = _tiny_model(1)
    text = torch.nn.functional.normalize(torch.randn(3, 8, generator=torch.Generator()
                                                     .manual_seed(2)), dim=-1)
    tower = types.SimpleNamespace(encode_image=lambda x: x.flatten(1)[:, :8])
    clip_image_fn = functools.partial(StageContext.clip_image_fn,
                                      types.SimpleNamespace(clip_model=tower))

    def crop_fn(last, batch):
        return clip_crop_scores(last, batch, clip_image_fn, text, 100.0, crop_size=16)

    eval_step = engine.make_eval_step(model, clip_crop_fn=crop_fn)
    ds = SyntheticDetectionDataset(SunrgbdAnonymousConfig(), num_scenes=5, num_points=1024,
                                   with_images=True)
    batches = tloader.make_loader(ds, 2, drop_last=False, pad_last=True, num_workers=1)
    engine.evaluate(eval_step, batches, SunrgbdAnonymousConfig(), device="cpu")

    stats = engine.EVAL_STATS
    assert stats["batches"] == 3 and stats["scans"] == 5

    def durations(name):
        return [s.t1 - s.t0 for s in RING if s.name == name]

    assert stats["load_s"] == durations("eval:load")[:-1]  # the last next() finds the end
    assert stats["wait_s"] == durations("eval:wait")
    assert stats["meter_s"] == durations("eval:meter")
    for i in range(3):
        own = {s.name: [x for x in RING if x.name == s.name and x.step == i] for s in RING}
        outer, = own["eval:step"]
        for name, count in (("eval:detector", 1), ("clip:crops", 1), ("clip:tower", 2)):
            assert len(own[name]) == count, name
            assert all(s.parent == "eval:step" and _inside(s, outer) for s in own[name]), name
        assert own["eval:to_device"][0].t1 <= outer.t0
        for name in ("eval:load", "eval:wait", "eval:meter"):
            assert len(own[name]) == 1 and own[name][0].parent is None, name
    assert not [s for s in RING if s.name == "eval:copy"]  # no pinned copies on the CPU


# ---------------------------------------------------------------- the loader


@pytest.mark.parametrize("use_processes", [False, True], ids=["threads", "processes"])
def test_loader_workers_stamp_their_builds(use_processes):
    ds = SyntheticDetectionDataset(SunrgbdAnonymousConfig(), num_scenes=12, num_points=256,
                                   with_images=True)
    kw = dict(shuffle=True, seed=3, drop_last=True)
    want = list(tloader.make_loader(ds, 3, num_workers=1, **kw))  # built in this thread
    assert [s.worker for s in RING] == [None] * 4 and RING[0].workers == 1
    RING.clear()
    t0 = time.perf_counter()
    got = list(tloader.make_loader(ds, 3, num_workers=2, use_processes=use_processes, **kw))
    t1 = time.perf_counter()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], list):
                assert g[k] == w[k], k
            else:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    builds = list(RING)
    assert [s.name for s in builds] == ["loader:build"] * 4
    assert [s.step for s in builds] == [0, 1, 2, 3]
    assert all(s.workers == 2 and s.parent is None for s in builds)
    assert all(t0 <= s.t0 < s.t1 <= t1 for s in builds)  # one clock across processes
    workers = {s.worker for s in builds}
    assert None not in workers and 1 <= len(workers) <= 2
    if use_processes:
        assert os.getpid() not in workers
