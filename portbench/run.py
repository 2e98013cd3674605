"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
The cell (`portbench/cells/<name>.json`) names a configuration
(`portbench/configs/`: main's flags, as the scripts run them) and a traffic
mix (`portbench/traffic/`: the scenes, the batch and the loop).  The run
builds the program's objects as `main` does for those flags, fills every
weight from the seed (`weights.py`), makes the scenes from the seed
(`scenes.py`), and drives the program's own loop, `engine.train_one_epoch`
or `engine.evaluate`, over the program's loader:

  * set-up: imports, the models, the kernels (built once a checkout, into
    build/torch_kernels/), the text banks, the loader's pool and, for an
    eval, the AP pool; then the first steps (the check steps of a training
    cell, the warm-up batches of an eval) through the same loop and feed;
  * the window: from a synchronized point, steps until the first one that
    ends after --seconds, then a synchronize;
  * with --trace 1 a stretch of steps after the window runs under torch.profiler
    and the per-layer readers (`portbench/metrics/`) read the trace and the
    host's clocks; with --trace 0 the end-to-end metrics are printed;
  * the check: the program's state is freed and the reference
    (`portbench/reference/`, plain PyTorch) computes the same steps or
    batches; `check.py` compares them, each number beside its limit.

The last line of standard output is one JSON object; the numbers compared
are the last lines of standard error too.  The run exits 2 without a card
(or with fewer than the cell asks for) and 3 if a JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "coda_neurips2023_tpu")
PROGRAM = "coda_neurips2023_tpu_torch"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    flax's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"portbench: no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_cell(name: str) -> SimpleNamespace:
    cell = load_json("cells", name)
    return SimpleNamespace(name=name, cell=cell, config=load_json("configs", cell["config"]),
                           traffic=load_json("traffic", cell["traffic"]))


def program():
    """The modules of the program the benchmark drives."""
    names = ("main", "engine", "stages", "datasets", "datasets.loader", "models",
             "models.clip", "models.transformer", "criterion", "optimizer",
             "utils.ap_calculator")
    return SimpleNamespace(**{n.replace(".", "_"): importlib.import_module(f"{PROGRAM}.{n}")
                              for n in names})


def main_args(P, spec: SimpleNamespace, seed: int):
    flags = list(spec.config["flags"]) + list(spec.traffic.get("flags", []))
    return P.main.make_args_parser().parse_args(flags + ["--seed", str(seed)])


# ---------------------------------------------------------------- the feed


class Feed:
    """The loader's batches, one iterator for the whole run (so the loader's
    pool starts once), with the host's clock around each `next()`."""

    def __init__(self, loader, record_function, keep):
        self.it = iter(loader)
        self.record = record_function
        self.keep = keep  # keep(i): whether the check needs host batch i
        self.waits = []  # (t_end, seconds waited)
        self.host = []  # the host batches given out, in order (None where not kept)
        self.deadline = None
        self.traced = None  # (steps, start) of a traced stretch after the window

    def _next(self):
        t0 = time.perf_counter()
        with self.record("portbench:loader"):
            batch = next(self.it, None)
        if batch is None:
            raise RuntimeError("portbench: the split ended inside the run; the traffic's "
                               "`scenes` must outlast set-up, window and traced stretch")
        t1 = time.perf_counter()
        self.waits.append((t1, t1 - t0))
        self.host.append(batch if self.keep(len(self.host)) else None)
        return batch

    def take(self, n: int):
        for _ in range(n):
            yield self._next()

    def window(self):
        """Batches until the deadline (at least one), then the traced
        stretch's."""
        given = 0
        while given == 0 or time.perf_counter() < self.deadline:
            yield self._next()
            given += 1
        if self.traced is not None:
            steps, start = self.traced
            start()
            for _ in range(steps):
                yield self._next()

    def close(self):
        close = getattr(self.it, "close", None)
        if close is not None:
            close()


# ---------------------------------------------------------------- builders


def build_program(P, args, traffic, seed: int, device):
    """The program's objects for these flags, as main's build_everything and
    do_train make them, every weight from the seed."""
    from portbench import weights

    _, train_cfg, eval_cfg, _ = P.datasets.build_dataset(args)
    model, _ = P.models.build_model(args, train_cfg, device=device)
    weights.load_seeded(model, seed, weights.DETECTOR)
    ns = SimpleNamespace(model=model, train_config=train_cfg, eval_config=eval_cfg,
                         stage_ctx=None)
    if args.model_name == "3detr_predictedbox_distillation" or args.if_with_clip:
        clip = P.models_clip.CLIP(device=device)
        weights.load_seeded(clip, seed, weights.CLIP)
        ns.stage_ctx = P.stages.StageContext(args, eval_cfg, clip_model=clip, device=device)
    if traffic["kind"] == "train":
        ns.iters_per_epoch = traffic["scenes"] // traffic["batch"]
        ns.optimizer, ns.schedule = P.optimizer.build_optimizer(args, model, ns.iters_per_epoch)
        ns.criterion = P.criterion.build_criterion(args, train_cfg, num_replicas=1)
    return ns


def scenes(traffic, config, seed: int):
    from portbench.scenes import SceneDataset

    return SceneDataset(traffic["scenes"], traffic["points"], traffic["max_boxes"],
                        traffic["image_hw"], config["max_num_obj"], config["num_angle_bin"], seed)


# ---------------------------------------------------------------- instrumentation


class OpRanges:
    """A `portbench:<op>` range around each call of an op the program's
    modules imported by name, with the shapes of each call kept for its
    operations and bytes.  Set only for the traced stretch."""

    def __init__(self, torch, targets: dict):
        self.torch = torch
        self.targets = targets  # op name -> (module, attribute, shape fn)
        self.calls = {name: [] for name in targets}
        self.saved = {}

    def install(self):
        for name, (module, attr, shapes) in self.targets.items():
            original = getattr(module, attr)
            self.saved[name] = original

            def wrapped(*a, _name=name, _orig=original, _shapes=shapes, **k):
                self.calls[_name].append(_shapes(*a, **k))
                with self.torch.profiler.record_function(f"portbench:{_name}"):
                    return _orig(*a, **k)

            setattr(module, attr, wrapped)

    def remove(self):
        for name, (module, attr, _) in self.targets.items():
            if name in self.saved:
                setattr(module, attr, self.saved.pop(name))


def op_targets(P_transformer, P_clip):
    def attention_shape(q, k, v, *a, **kw):
        b, h, sq, d = q.shape
        return (b, h, sq, v.shape[2], d)

    def vit_shape(q, k, v):
        b, h, s, d = q.shape
        return (b, h, s, s, d)

    return {"attention": (P_transformer, "masked_attention", attention_shape),
            "vit_attention": (P_clip, "vit_attention", vit_shape)}


# ---------------------------------------------------------------- cells


def run_train(P, spec, seed, seconds, trace, device, fault=None):
    import torch

    from portbench import check

    t, c = spec.traffic, spec.config
    args = main_args(P, spec, seed)
    prog = build_program(P, args, t, seed, device)
    model, optimizer = prog.model, prog.optimizer
    if prog.stage_ctx is not None and prog.stage_ctx.needs_distillation():
        step = prog.stage_ctx.make_fused_train_step(model, prog.criterion, optimizer,
                                                    lr_schedule=prog.schedule)
    else:
        step = P.engine.make_train_step(model, prog.criterion, optimizer,
                                        lr_schedule=prog.schedule)
    loader = P.datasets_loader.make_loader(
        scenes(t, c, seed), t["batch"], shuffle=True, seed=seed, drop_last=True,
        num_workers=max(args.dataset_num_workers, 1), use_processes=args.dataset_num_workers > 1)
    epoch = int(t["epoch"])
    loader.epoch = epoch + 1  # as main.do_train, at this epoch
    host_schedule = P.optimizer.make_lr_schedule(args, prog.iters_per_epoch, host=True)
    n_check = int(t["check_steps"])
    feed = Feed(loader, torch.profiler.record_function, lambda i: i < n_check)
    rec = check.TrainRecorder(step, optimizer, n_check, fault, prog.stage_ctx)
    cuda = torch.device(device).type == "cuda"

    def loop(batches, first_it):
        return P.engine.train_one_epoch(
            rec, batches, curr_epoch=epoch, log_every=args.log_every,
            lr_fn=lambda it: host_schedule(epoch * prog.iters_per_epoch + first_it + it),
            device=device, optimizer=optimizer, seed=seed, all_epoch=epoch,
            log=lambda *a, **k: print(*a, file=sys.stderr, **k))

    try:
        loop(rec.feed(feed.take(n_check)), 0)
        sync(torch, cuda)
        window = Window(torch, cuda, seconds, trace, feed, rec.ends,
                        op_targets(P.models_transformer, P.models_clip), int(t["trace_steps"]))
        loop(rec.feed(feed.window()), n_check)
        window.close()
    finally:
        feed.close()
    lrs = [host_schedule(epoch * prog.iters_per_epoch + i) for i in range(n_check)]
    readings = rec.readings()
    run = window.summary(feed, t["batch"], spec)
    run.update(kind="train", memory_peak_bytes=peak_memory(torch, cuda))
    checked = SimpleNamespace(batches=feed.host[:n_check], lrs=lrs, epoch=epoch,
                              program=readings)
    del prog, model, optimizer, step, rec, loader, feed
    free(torch, cuda)
    numbers, run["check_readings"] = check.train_numbers(spec, args, checked, seed, device,
                                                         fault == "control")
    return run, numbers


def run_eval(P, spec, seed, seconds, trace, device, fault=None):
    import torch

    from portbench import check

    t, c = spec.traffic, spec.config
    args = main_args(P, spec, seed)
    prog = build_program(P, args, t, seed, device)
    eval_step = prog.stage_ctx.make_clip_eval_step(prog.model, bank="test")
    rec = check.EvalRecorder(eval_step, fault)
    rec.watch_crops(P.stages, "clip_crop_scores")
    loader = P.datasets_loader.make_loader(
        scenes(t, c, seed), t["batch"], shuffle=False, drop_last=False, pad_last=True,
        num_workers=max(args.dataset_num_workers_test, 1))
    warm = int(t["warmup_batches"])
    # the check draws its batches from the window's first KEPT_BATCHES
    feed = Feed(loader, torch.profiler.record_function,
                lambda i: warm <= i < warm + check.KEPT_BATCHES)
    cuda = torch.device(device).type == "cuda"

    def loop(batches):
        return P.engine.evaluate(rec, batches, prog.eval_config, device=device,
                                 dataset_name=args.dataset_name)

    try:
        loop(feed.take(warm))
        sync(torch, cuda)
        first = len(feed.host)
        rec.keep_from(first)
        window = Window(torch, cuda, seconds, trace, feed, rec.ends,
                        op_targets(P.models_transformer, P.models_clip), int(t["trace_steps"]))
        ap = loop(feed.window())
        window.close()
        stats = dict(P.engine.EVAL_STATS)
    finally:
        feed.close()
        P.utils_ap_calculator.close_pool()
    run = window.summary(feed, t["batch"], spec)
    run.update(kind="eval", scenes_metered=int(ap.scan_cnt), eval_stats=stats,
               memory_peak_bytes=peak_memory(torch, cuda))
    done = list(range(first, len(feed.host)))
    checked = SimpleNamespace(batches=feed.host, outputs=rec.outputs, crops=rec.crops, done=done)
    del prog, eval_step, rec, loader, feed
    free(torch, cuda)
    numbers, run["check_readings"] = check.eval_numbers(spec, args, checked, seed, device,
                                                        fault == "control")
    return run, numbers


class Window:
    """The measured window and, with --trace 1, a traced stretch of
    `trace_steps` more steps after it (a profiler once started slows the
    host for the rest of the process, so nothing the host's clock reads
    follows it): its clocks and what the readers need."""

    def __init__(self, torch, cuda, seconds, trace, feed, ends, targets, trace_steps):
        from coda_neurips2023_tpu_torch import _kernels

        self.torch, self.cuda, self.feed, self.ends = torch, cuda, feed, ends
        self.trace = self.profiler = self.ops = None
        self.n_ends0 = len(ends)
        if trace:
            from portbench.trace import Profiler

            self.profiler = Profiler(str(ROOT / "build" / "portbench" / "trace.json"), cuda)
            self.ops = OpRanges(torch, targets)
            feed.traced = (trace_steps, self._start_trace)
        self.kernels = _kernels
        self.launches0 = dict(_kernels.LAUNCHES)
        self.t0 = time.perf_counter()
        feed.deadline = self.t0 + seconds
        self.setup_s = self.t0 - T_START
        self.untraced_end = None

    def _start_trace(self):
        sync(self.torch, self.cuda)
        self.untraced_end = time.perf_counter()
        self.n_ends_untraced = len(self.ends)
        self.ops.install()
        self.profiler.start()
        self.trace_t0 = time.perf_counter()  # the profiler's own start-up is not traced time

    def close(self):
        sync(self.torch, self.cuda)
        self.t1 = time.perf_counter()
        self.launches = {k: v - self.launches0.get(k, 0)
                         for k, v in self.kernels.LAUNCHES.items()}
        if self.untraced_end is None:
            self.untraced_end, self.n_ends_untraced = self.t1, len(self.ends)
        elif self.profiler is not None:
            self.ops.remove()
            self.trace = self.profiler.stop(self.t1 - self.trace_t0,
                                            len(self.ends) - self.n_ends_untraced)

    def summary(self, feed, batch, spec) -> dict:
        ends = self.ends[self.n_ends0:self.n_ends_untraced]
        return {"setup_s": self.setup_s, "window_s": self.untraced_end - self.t0,
                "steps": len(ends), "batch": batch, "t0": self.t0,
                "untraced_end": self.untraced_end, "ends": ends,
                "loader_waits": [(t, w) for t, w in feed.waits
                                 if self.t0 <= t <= self.untraced_end],
                "trace": self.trace, "launches": self.launches,
                "op_calls": self.ops.calls if self.ops is not None else {}, "spec": spec}


def sync(torch, cuda):
    if cuda:
        torch.cuda.synchronize()


def peak_memory(torch, cuda) -> int:
    return int(torch.cuda.max_memory_allocated()) if cuda else 0


def free(torch, cuda):
    import gc

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- the result


def end_to_end(spec, run) -> dict:
    out = {"setup_s": {"value": run["setup_s"], "unit": "s"}}
    rate = run["steps"] * run["batch"] / run["window_s"]
    if run["kind"] == "eval":
        rate = run["scenes_metered"] / run["window_s"]
    out[spec.traffic["rate_metric"]] = {"value": rate, "unit": "scenes/s"}
    return out


def per_layer(spec, run) -> dict:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and spec.name not in m["workloads"]:
            continue
        value = load_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def load_reader(name: str):
    """The reader of per-layer metric `name`: portbench/metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    module_spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def run_cell(name, seed, seconds, trace, device, fault=None, overrides=None):
    """(result dict, run) of one run of cell `name` on `device`.  `overrides`
    ({"traffic": {...}, "config": {...}}) changes the cell's files' entries,
    for tests at a small size; `fault` plants a fault for the check's tests."""
    import torch

    from portbench import check

    spec = load_cell(name)
    for key, values in (overrides or {}).items():
        getattr(spec, key).update(values)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    P = program()
    fn = run_train if spec.traffic["kind"] == "train" else run_eval
    run, numbers = fn(P, spec, seed, seconds, trace, device, fault)
    correct, compared = check.judge(numbers, spec.cell["limits"])
    device_info = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if torch.device(device).type == "cuda"
                            else "cpu"),
                   "count": int(spec.cell["chips"]),
                   "memory_peak_bytes": run["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": run["steps"], "failed": 0 if correct else 1}
    if trace:
        result["metrics"] = per_layer(spec, run)
        tr = run["trace"]
        device_info.update(busy_s=tr.busy_s() if tr else 0.0, window_s=tr.window_s if tr else 0.0)
        if tr is not None:
            result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        result["metrics"] = end_to_end(spec, run)
    result["device"] = device_info
    # the hand-written kernels the window launched, by name (_kernels.LAUNCHES)
    result["kernel_launches"] = {k: v for k, v in run["launches"].items() if v}
    result["checks"] = compared
    return result, run


def steady_host():
    """One thread a process for OpenMP and the BLAS libraries, in this
    process and the loader's and AP meter's workers (which inherit the
    environment): the loop is bound by its main thread's launches, and
    thread pools on every process of an 8-core host spread its runs."""
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[key] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    spec = load_cell(a.workload)
    steady_host()
    import torch

    need = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: cell {a.workload} needs {need} CUDA device(s); torch sees {have}",
              file=sys.stderr)
        return 2
    result, _ = run_cell(a.workload, a.seed, a.seconds, a.trace, torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"portbench: JAX modules loaded: {found}", file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
