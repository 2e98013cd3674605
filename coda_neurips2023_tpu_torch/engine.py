"""Train and eval steps (PyTorch).

Counterpart of coda_neurips2023_tpu/engine.py:
  * `make_train_step` (:90-173): forward in training mode, targets computed
    from that forward (stage 1's distillation targets, `extra_targets_fn`),
    the criterion, backward, the optimizer update with a runtime learning
    rate, and the BatchNorm statistics (updated by the forward itself); over
    several ranks the gradients are summed over them between the backward
    and the optimizer (the JAX package's sharded jit does it in XLA);
  * `train_one_epoch` (:247-347): the epoch loop, each host batch copied to
    the device with its epochs and learning rate, dropout drawn from a
    generator seeded by the run's seed and the step count, the losses kept
    on the device and checked for finiteness every `log_every` steps,
    aborting as the reference does, and stage 2's discovery after a step;
  * `make_eval_step` (:176-225): the detector's eval forward, the chosen
    decoder layer's outputs, and class scores either from the distillation
    head against a text bank or, with `clip_crop_fn`, from CLIP crops of the
    predicted boxes;
  * `evaluate` (:350-449): the eval loop, each batch copied to the device,
    stepped, its outputs copied back and metered into the host AP
    calculator, one batch deep (below); over several ranks each rank steps
    its rows and rank 0 meters the global batch (the JAX package's
    multi-host gather, :385-424).
Checkpoints are saved by the caller (main.do_train, utils/io.py).
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from coda_neurips2023_tpu_torch.datasets.loader import to_device
from coda_neurips2023_tpu_torch.models.model_3detr import get_class_scores
from coda_neurips2023_tpu_torch.parallel import ddp
from coda_neurips2023_tpu_torch.parallel import dist as pdist
from coda_neurips2023_tpu_torch.utils import ap_calculator
from coda_neurips2023_tpu_torch.utils.device import resolve_device
from coda_neurips2023_tpu_torch.utils.misc import SmoothedValue

# keys of the batch the criterion reads as targets
TARGET_KEYS = (
    "gt_box_corners", "gt_box_centers_normalized", "gt_box_sizes_normalized",
    "gt_box_angles", "gt_angle_class_label", "gt_angle_residual_label",
    "gt_box_sem_cls_label", "gt_box_present", "gt_box_seen_sem_cls_label",
    "gt_box_seen_sem_cls_confi",
)

# the last layer's box quantities the stage-2 discovery pass reads
DISCOVERY_OUTPUT_KEYS = (
    "box_corners", "box_corners_xyz", "center_unnormalized", "size_unnormalized",
    "angle_continuous", "objectness_prob",
)

EVAL_KEYS = (
    "box_corners", "sem_cls_prob", "objectness_prob", "center_unnormalized",
    "size_unnormalized", "angle_continuous",
)

# the keys of the host batch the AP calculator reads beside the outputs
METER_KEYS = ("point_clouds", "gt_box_corners", "gt_box_sem_cls_label", "gt_box_present")

# what the last `evaluate` measured: "batches", "scans"; "wall_s", its loop from the
# first batch to the last meter; per batch, "load_s" (the loop waiting for
# the loader), "device_ms" (CUDA events from
# before the batch's copy to the card to after its outputs' copy back: the
# device's span for the batch, idle gaps inside it included), "meter_s"
# (the host's AP metering) and "wait_s" (the host blocked on the outputs'
# copy).  Empty lists for device_ms on the CPU.
EVAL_STATS: dict = {}


def last_layer(outputs: dict, layer_id: int = -1) -> dict:
    """One decoder layer's outputs of the forward's per-layer stacks."""
    return {
        k: v[layer_id] for k, v in outputs.items() if k not in ("query_xyz", "enc_xyz", "enc_inds")
    }


def make_eval_step(
    model,
    eval_text_features: Optional[torch.Tensor] = None,
    eval_logit_scale: float = 100.0,
    clip_crop_fn: Optional[Callable] = None,
    eval_layer_id: int = -1,
):
    """Returns eval_step(batch) -> the six outputs the AP calculator reads.

    `batch` holds point_clouds (B, N, 3+) and point_cloud_dims_min/max (B, 3)
    on the model's device.  With `eval_text_features` (ncls, 512), row
    normalized, `sem_cls_prob` is the softmax over the text bank
    (get_class_scores); with `clip_crop_fn(outputs_last, batch)` instead, it
    is what that returns (CLIP zero-shot scores of the boxes' image crops,
    `models.distillation.clip_crop_scores`); with neither, the sem head's
    foreground softmax.  `eval_layer_id` picks the decoder layer (-1: the
    last).
    """

    @torch.inference_mode()
    def eval_step(batch: dict) -> dict:
        model.eval()  # each call: a training loop puts the model back in training mode
        last = last_layer(model(batch), eval_layer_id)
        if clip_crop_fn is not None:
            last["sem_cls_prob"] = clip_crop_fn(last, batch)
        elif eval_text_features is not None:
            last["sem_cls_prob"] = get_class_scores(
                last["text_correlation_embedding"], eval_text_features, eval_logit_scale
            )
        return {k: last[k] for k in EVAL_KEYS}

    return eval_step


def make_train_step(model, criterion, optimizer, lr_schedule: Optional[Callable] = None,
                    extra_targets_fn: Optional[Callable] = None,
                    criterion_consts: Optional[dict] = None,
                    return_last_outputs: bool = False):
    """Returns train_step(batch, generator) -> metrics, or (metrics,
    last_outputs) with `return_last_outputs`.

    `batch` holds the forward's inputs and the TARGET_KEYS on the model's
    device; `generator` feeds dropout.  The learning rate is a runtime
    input: `batch["lr"]` when present (a float or 0-d tensor), else
    lr_schedule(steps taken so far).  `criterion_consts` (a dict of
    tensors, e.g. the text bank and logit scale) join the targets, and
    `extra_targets_fn(outputs, batch, generator)` adds targets computed from
    this step's training forward (stage 1's CLIP distillation targets), under
    no_grad, before the criterion.  With `return_last_outputs` the step also
    returns the last decoder layer's DISCOVERY_OUTPUT_KEYS, detached.

    The step leaves each parameter's gradient in `.grad`; `metrics` holds
    the total loss, the lr and every loss term, as 0-d tensors on the device
    (nothing syncs but the matcher's one host round trip).  The phases run
    inside `torch.profiler.record_function` ranges ("train:forward",
    "train:targets", "train:criterion", "train:backward", "train:allreduce",
    "train:optimizer").

    Over several ranks (parallel/ddp.py) the batch is this rank's rows, the
    criterion gives this rank's share of the global loss, the gradients are
    summed over the ranks in one flat all-reduce before the optimizer (whose
    clip by global norm so sees the global gradient), and the loss and its
    terms in `metrics` are summed over the ranks: the global loss, alike on
    every rank.
    """
    record = torch.profiler.record_function

    def train_step(batch: dict, generator: Optional[torch.Generator] = None):
        model.train()
        lr = batch.get("lr")
        if lr is None:
            if lr_schedule is None:
                raise ValueError("no learning rate: pass batch['lr'] or lr_schedule=")
            lr = lr_schedule(optimizer.count)
        optimizer.zero_grad()
        with record("train:forward"):
            outputs = model(batch, generator=generator)
        targets = {k: batch[k] for k in TARGET_KEYS if k in batch}
        targets.update(criterion_consts or {})
        if extra_targets_fn is not None:
            with record("train:targets"), torch.no_grad():
                targets.update(extra_targets_fn(outputs, batch, generator))
        with record("train:criterion"):
            loss, loss_dict = criterion(outputs, targets)
        with record("train:backward"):
            loss.backward()
        with record("train:allreduce"):
            ddp.all_reduce_gradients(optimizer.params)
        with record("train:optimizer"):
            optimizer.step(lr)
        lr = torch.as_tensor(lr, dtype=torch.float32)
        losses = pdist.reduce_dict({"loss": loss.detach(),
                                    **{k: v.detach() for k, v in loss_dict.items()}},
                                   average=False)
        metrics = {"loss": losses.pop("loss"), "lr": lr, **losses}
        if return_last_outputs:
            return metrics, {k: outputs[k][-1].detach() for k in DISCOVERY_OUTPUT_KEYS}
        return metrics

    return train_step


def step_generator(seed: int, step: int, device, rank: int = 0) -> torch.Generator:
    """The generator of training step `step` of a run seeded `seed`: a
    function of the two alone, as the JAX step folds its step count into its
    key (engine.py:154), so a resumed run draws what an uninterrupted one
    draws.  Rank r > 0 of a data-parallel run folds r in too, so each rank's
    rows draw their own dropout masks and crops (the JAX package draws one
    mask over the global batch from its key; R ranks draw other masks than
    one rank does)."""
    entropy = [int(seed), int(step)] + ([int(rank)] if rank else [])
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def train_one_epoch(train_step, batches, curr_epoch: int = 0, log_every: int = 10,
                    lr_fn: Optional[Callable] = None, log=print, *,
                    device=None, optimizer=None, seed: Optional[int] = None,
                    all_epoch: Optional[int] = None, logger=None,
                    discovery_fn: Optional[Callable] = None,
                    profile_dir: Optional[str] = None):
    """The epoch loop (the JAX package's train_one_epoch, engine.py:247-347):
    `train_step` over `batches`; returns the last step's metrics.

    Each host batch (numpy arrays, as datasets.loader gives them) goes to
    `device` through `loader.to_device` (None: the batches are used as
    given); its list fields and gt_ori_box_num stay on the host, for the
    pseudo-label writer.  Each batch carries `curr_epoch` (the epoch as reset
    by stage 2's periodic reset, which the crop selection's gate reads) and
    `all_epoch` (the monotone epoch, which the keep-box gate reads; curr_epoch
    when None), and, with `lr_fn(it)`, the iteration's learning rate (else
    the step's own schedule).  With `seed` and `optimizer`, each step's
    dropout and crop draws come from step_generator(seed, optimizer.count,
    rank) (else the step gets no generator).  With `discovery_fn`, the step returns the last
    decoder layer's outputs too and discovery_fn(last_outputs, batch) mines
    and writes pseudo labels.  With `profile_dir`, iterations 2-5 are traced
    with torch.profiler into <profile_dir>/train_trace.json.

    Losses stay on the device; every `log_every` iterations, and at the end,
    they are read back, a non-finite one stops the run with exit code 1 (the
    reference's per-step abort, at most log_every - 1 steps late), and the
    status line and, with `logger`, the Train_details/ scalars (at the
    optimizer's step count) are written.  Nothing else waits for the device.
    Over several ranks the losses read back are the all-reduced ones, so
    every rank aborts at the same step, and only rank 0 prints.
    """
    iter_time = SmoothedValue(window_size=10)
    loss_avg = SmoothedValue(window_size=10)
    rank = pdist.get_rank()
    if rank:
        log = lambda *a, **k: None  # noqa: E731
    pending = []
    metrics = {}
    profiler = None

    def drain():
        values = [float(x) for x in pending]
        pending.clear()
        for v in values:
            if not math.isfinite(v):
                log("Loss in not finite. Training will be stopped.")
                sys.exit(1)
            loss_avg.update(v)

    cuda = device is not None and torch.device(device).type == "cuda"
    for it, host_batch in enumerate(batches):
        if profile_dir is not None and it == 2:
            profiler = _start_profile(cuda)
        if profiler is not None and it == 6:
            _stop_profile(profiler, profile_dir)
            profiler = None
        t0 = time.perf_counter()
        batch = dict(host_batch)
        if device is not None:
            host_only = {k: batch.pop(k) for k in ("gt_ori_box_num",) if k in batch}
            batch = dict(to_device(batch, device), **host_only)
        batch["curr_epoch"] = curr_epoch
        batch["all_epoch"] = curr_epoch if all_epoch is None else all_epoch
        if lr_fn is not None:
            batch["lr"] = float(lr_fn(it))
        gen = None
        if seed is not None and optimizer is not None:
            gen = step_generator(seed, optimizer.count, device if device is not None else "cpu",
                                 rank)
        result = train_step(batch, gen)
        if isinstance(result, tuple):
            metrics, last_outputs = result
            if discovery_fn is not None:
                discovery_fn(last_outputs, batch)
        else:
            metrics = result
        pending.append(metrics["loss"])
        iter_time.update(time.perf_counter() - t0)
        if it % log_every == 0:
            drain()
            mem = ""
            if cuda:
                mem = f"; mem {torch.cuda.memory_allocated(device) / 2**30:.2f}GiB"
            log(f"Epoch [{curr_epoch}] iter [{it}] loss {loss_avg.avg:.4f} "
                f"iter_time {iter_time.avg * 1000:.0f}ms{mem}")
            if logger is not None:
                logger.log_scalars({k: float(v) for k, v in metrics.items()},
                                   optimizer.count if optimizer is not None else it,
                                   prefix="Train_details/")
    if profiler is not None:
        _stop_profile(profiler, profile_dir)
    drain()  # the epoch's tail: the abort covers every step
    return metrics


def _start_profile(cuda: bool):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profile(profiler, profile_dir: str) -> None:
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(profile_dir, "train_trace.json"))


def evaluate(eval_step, batches, dataset_config, device="cuda", class2type_map=None,
             exact_eval: bool = True,
             dataset_name: str = "sunrgbd") -> ap_calculator.APCalculator:
    """The eval loop: every batch of `batches` (host dicts of numpy arrays, as
    datasets.loader gives them) through `eval_step` on `device` and into a
    host APCalculator, which the caller computes metrics from.

    One batch deep, as the JAX package: step i + 1 is launched before the
    host meters step i, so the card computes while the host runs the AP
    stack.  Right after a step is launched its EVAL_KEYS outputs are copied
    into pinned host tensors with non_blocking=True and a CUDA event is
    recorded behind them; the host meters that step only once that event has
    completed, and never synchronizes the whole device.  The AP calculator
    reads the ground truth (METER_KEYS) from the host batch, so nothing comes
    back from the card but the outputs.  A batch's "pad_mask" (the loader's
    padded tail) drops the repeated rows before metering.  The AP pool's
    workers are started first, so their start-up overlaps the first batch.
    Fills EVAL_STATS.

    Over several ranks `batches` gives this rank's rows (datasets.loader
    .RankLoader): each rank steps its rows, and each batch's outputs, meter
    keys and pad_mask are all-gathered in rank order over the host group
    (parallel.dist.all_gather_dict); rank 0 keeps the real rows by the
    boolean mask (each rank's padding sits inside the concatenation, as in
    the JAX package's multi-host gather) and meters them.  Returns the APCalculator on rank 0
    and None on the others, which wait at a barrier for rank 0's last meter.
    """
    device = resolve_device(device)
    cuda = device.type == "cuda"
    primary = pdist.is_primary()
    ap = ap_calculator.APCalculator(
        dataset_config=dataset_config,
        ap_iou_thresh=[0.25, 0.5],
        class2type_map=class2type_map,
        exact_eval=exact_eval,
        dataset_name=dataset_name,
    )
    events, load_s, meter_s, wait_s = [], [], [], []

    def launch(batch):
        start = torch.cuda.Event(enable_timing=True) if cuda else None
        if cuda:
            start.record()
        outputs = eval_step(to_device(batch, device))
        if not cuda:
            return {k: outputs[k].numpy() for k in EVAL_KEYS}, None
        host = {}
        for k in EVAL_KEYS:
            v = outputs[k]
            host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[k].copy_(v, non_blocking=True)
        done = torch.cuda.Event(enable_timing=True)
        done.record()
        events.append((start, done))
        return host, done

    def meter(host, done, targets, pad_mask):
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
            host = {k: v.numpy() for k, v in host.items()}
        t1 = time.perf_counter()
        if pdist.is_distributed():
            n = len(host[EVAL_KEYS[0]])
            rows = pdist.all_gather_dict({
                **host, **targets,
                "pad_mask": np.ones(n, bool) if pad_mask is None else np.asarray(pad_mask, bool)})
            if not primary:
                wait_s.append(t1 - t0)
                meter_s.append(time.perf_counter() - t1)
                return
            host = {k: rows[k] for k in host}
            targets = {k: rows[k] for k in targets}
            pad_mask = rows["pad_mask"]
        if pad_mask is not None and not np.all(pad_mask):
            mask = np.asarray(pad_mask, bool)
            host = {k: v[mask] for k, v in host.items()}
            targets = {k: v[mask] for k, v in targets.items()}
        ap.step_meter({"outputs": host}, targets)
        wait_s.append(t1 - t0)
        meter_s.append(time.perf_counter() - t1)

    t_start = time.perf_counter()
    if primary:
        ap_calculator.start_pool()
    pending = None
    batches = iter(batches)
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            break
        load_s.append(time.perf_counter() - t0)
        device_batch = {k: v for k, v in batch.items()
                        if not isinstance(v, list) and k != "pad_mask"}
        host, done = launch(device_batch)
        if pending is not None:
            meter(*pending)
        pending = (host, done, {k: batch[k] for k in METER_KEYS if k in batch},
                   batch.get("pad_mask"))
    if pending is not None:
        meter(*pending)
    pdist.barrier()
    EVAL_STATS.clear()
    EVAL_STATS.update(
        batches=len(meter_s), scans=ap.scan_cnt, wall_s=time.perf_counter() - t_start,
        load_s=load_s, device_ms=[start.elapsed_time(done) for start, done in events],
        meter_s=meter_s, wait_s=wait_s,
    )
    if not primary:
        return None
    print(f"evaluated {ap.scan_cnt} scans")
    return ap
