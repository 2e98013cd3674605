"""What decides `correct`: the program's own steps and batches held against
the reference (`portbench/reference/`, plain PyTorch) on the same inputs
and the same weights, each number beside the limit the cell's file gives.

Training cells.  The run's first `check_steps` steps go through the
program's loop and feed during set-up; the recorder keeps each step's loss,
the per-leaf norms of AdamW's first moment after step 1 (the first
gradient as the optimizer takes it, clipped, times 1 - beta1) and the
per-leaf norms of the parameters' change after the last check step, before
the next step moves them.  After the window the reference runs the same
steps from the same seeded weights, batches, learning rates and step
generators.  The numbers:
  * loss_gap: |loss - reference| / |reference| of step 1;
  * grad_gap: over the leaves, the largest gap between the two sides' first
    gradient norms, over the larger of the reference leaf's norm and the
    median leaf's;
  * update_gap: the same gap of the parameters' change after the check
    steps, of the median leaf;
  * targets_gap (stage 1): step 1's crop embeddings, the program's against
    the reference's cut from the program's own boxes with the same
    selection, over the largest reference element.  The reference's step 1
    takes those crops too: a crop's rect is rounded to pixels, and a box
    within rounding of a pixel's edge (about one seed in forty) would move
    one crop by a pixel on one side alone.
  Leaves whose reference first gradient is under a thousandth of the median
  leaf's are left out of both (AdamW's decay moves them whatever their
  gradient).  Step 1's loss and the median leaf's change are compared, not
  the later steps' losses and the worst leaf's change: AdamW's first update
  is lr times the sign of each gradient element, so the elements whose
  gradient is rounding noise move by +-lr on either side, and from step 2
  on the two trajectories part by far more than rounding (PERF.md gives
  the readings of both).

The eval cell.  Of the first KEPT_BATCHES batches the window metered,
`check_batches` drawn from the seed: the reference's eval forward on the
same batch, and CLIP's crop scores of the program's own boxes (the reference computes the crops
and the tower again; the boxes are what it judges).  The numbers:
  * box_gap: the largest |difference| of the box centres, sizes and
    corners (metres) and angles (radians), leaving out the queries whose
    reference angle logits have their two largest within ANGLE_TIE (their
    angle bin is a coin toss at any precision);
  * prob_gap: the largest |difference| of objectness_prob and sem_cls_prob.
"""

from __future__ import annotations

import math
import time

import numpy as np

ANGLE_TIE = 1e-3
KEPT_BATCHES = 6  # the eval's check draws from the window's first six batches
TARGET_EMBEDDING = ("gt_text_correlation_embedding", "gt_text_correlation_embedding_mask")


class TrainRecorder:
    """The training step the loop calls, with what the check needs taken
    around the first `n_check` calls, and each call's end on the host's
    clock.  `fault` plants a fault (for the tests that show the check fails):
    "frozen_state" (the optimizer takes no step), "half_batch" (the step
    sees the first half of each batch)."""

    def __init__(self, step, optimizer, n_check: int, fault=None, stage_ctx=None):
        self.step, self.optimizer = step, optimizer
        self.step1 = None  # stage 1's first crops: boxes, selection, targets
        if stage_ctx is not None and stage_ctx.needs_distillation():
            self._watch_targets(stage_ctx)
        self.n_check, self.fault = n_check, fault
        self.calls = 0
        self.ends = []
        self.losses = []
        self.grad_norms = None
        self.change_norms = None
        self.theta0 = None
        self.names = list(optimizer.names)
        if fault == "frozen_state":
            optimizer.step = lambda lr: None

    def _watch_targets(self, stage_ctx):
        """Keep what step 1's distillation call took and gave: the crops'
        rects are rounded to pixels, so the reference cuts its step-1 crops
        from these boxes (a box within rounding of a pixel's edge would
        otherwise move a crop by a pixel on one side alone)."""
        call = stage_ctx._distillation_call

        def watched(last, batch, sel, text_bank):
            targets = call(last, batch, sel, text_bank)
            if self.step1 is None:
                self.step1 = {"boxes": {k: last[k].detach().clone() for k in
                                        ("box_corners_xyz", "size_unnormalized")},
                              "sel": sel.clone(),
                              **{k: targets[k].clone() for k in TARGET_EMBEDDING}}
            return targets

        stage_ctx._distillation_call = watched

    def feed(self, batches):
        for batch in batches:
            if self.fault == "half_batch":
                n = len(batch["point_clouds"]) // 2
                batch = {k: v[:n] for k, v in batch.items()}
            yield batch

    def __call__(self, batch, generator=None):
        import torch

        i = self.calls
        if i == 0:
            self.theta0 = [p.detach().clone() for p in self.optimizer.params]
        metrics = self.step(batch, generator)
        if i < self.n_check:
            self.losses.append(metrics["loss"].detach().clone())
        if i == 0:
            self.grad_norms = torch.stack([torch.linalg.vector_norm(m) for m in self.optimizer.mu])
        if i == self.n_check - 1:
            self.change_norms = torch.stack([
                torch.linalg.vector_norm(p.detach() - p0)
                for p, p0 in zip(self.optimizer.params, self.theta0)])
            self.theta0 = None
        self.calls += 1
        self.ends.append(time.perf_counter())
        return metrics

    def readings(self) -> dict:
        return {"losses": [float(x) for x in self.losses], "names": self.names,
                "step1": self.step1,
                "grad_norms": self.grad_norms.double().cpu().numpy(),
                "change_norms": self.change_norms.double().cpu().numpy()}


class EvalRecorder:
    """The eval step `engine.evaluate` calls, keeping the outputs of every
    batch from `keep_from(i)` on, and each call's end on the host's clock.
    Faults: "altered_answer" (one query's objectness raised by 0.5 where
    the step produces it), "half_batch" (the step sees the first half of
    each batch and repeats its answers for the rest)."""

    def __init__(self, step, fault=None):
        self.step, self.fault = step, fault
        self.calls = 0
        self.first = None
        self.outputs = {}
        self.crops = {}  # call -> the boxes its crops were cut from
        self.ends = []

    def watch_crops(self, module, name: str):
        """Keep the boxes each call's crops are cut from (`module.name`, the
        crop scorer the step calls): the reference scores the crops of these
        very boxes, as rects rounded to pixels would otherwise move a crop
        by a pixel where a box lies within rounding of a pixel's edge."""
        score = getattr(module, name)

        def watched(outputs_last, batch, *a, **k):
            if self.first is not None and self.calls >= self.first:
                self.crops[self.calls] = {key: outputs_last[key].clone() for key in
                                          ("box_corners_xyz", "size_unnormalized")}
            return score(outputs_last, batch, *a, **k)

        setattr(module, name, watched)

    def keep_from(self, i: int):
        self.first = i

    def __call__(self, batch):
        import torch

        if self.fault == "half_batch":
            n = len(batch["point_clouds"]) // 2
            out = self.step({k: (v[:n] if isinstance(v, torch.Tensor) else v)
                             for k, v in batch.items()})
            out = {k: torch.cat([v, v])[: 2 * n] for k, v in out.items()}
        else:
            out = self.step(batch)
        if self.fault == "altered_answer":
            out = dict(out)
            out["objectness_prob"] = out["objectness_prob"].clone()
            out["objectness_prob"][0, 0] += 0.5
        if self.first is not None and self.calls >= self.first:
            self.outputs[self.calls] = out
        self.calls += 1
        self.ends.append(time.perf_counter())
        return out


def _to_device(batch: dict, device) -> dict:
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()
            if not isinstance(v, list) and k != "pad_mask"}


def _leaf_gaps(prog: np.ndarray, ref: np.ndarray, counted: np.ndarray) -> np.ndarray:
    """Each counted leaf's |prog - ref| over the larger of its reference norm
    and the median counted leaf's."""
    scale = np.maximum(ref, np.median(ref[counted]))
    gaps = np.abs(prog - ref) / scale
    return np.where(np.isfinite(prog), gaps, np.inf)[counted]


class tf32:
    """TF32 on for every matmul and convolution inside the block: the
    control's precision, the nearest below the configuration's."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        import torch

        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def _reference(args, seed: int, device):
    from portbench import weights
    from portbench.reference import build as R

    ref = R.build(args, device, with_clip=args.model_name == "3detr_predictedbox_distillation"
                  or args.if_with_clip)
    weights.load_seeded(ref.model, seed, weights.DETECTOR)
    banks = None
    if ref.clip is not None:
        weights.load_seeded(ref.clip, seed, weights.CLIP)
        banks = R.text_banks(args, ref.eval_config, ref.clip)
    return ref, banks


def reference_train(args, checked, seed: int, device, use_tf32: bool = False,
                    step1=None) -> dict:
    """The reference's readings of the check steps: the TrainRecorder's.
    With `step1` (a side's first crops), step 1's crops are cut from its
    boxes."""
    import torch

    from portbench.reference import build as R

    with tf32(use_tf32):
        ref, banks = _reference(args, seed, device)
        theta0 = [p.detach().clone() for p in ref.optimizer.params]
        losses, seen = [], {}
        for i, (host, lr) in enumerate(zip(checked.batches, checked.lrs)):
            batch = dict(_to_device(host, device), curr_epoch=checked.epoch,
                         all_epoch=checked.epoch)
            gen = R.step_generator(seed, i, device)
            boxes = None
            if i == 0 and step1:  # not the other side's boxes where its batch differs
                own = step1["boxes"]["box_corners_xyz"].shape[0] == len(host["point_clouds"])
                boxes = step1["boxes"] if own else None
            losses.append(float(R.train_step(ref, args, banks, batch, lr, gen, boxes,
                                             seen if i == 0 else None)))
            if i == 0:
                grad = np.array([float(torch.linalg.vector_norm(m)) for m in ref.optimizer.mu])
        change = np.array([float(torch.linalg.vector_norm(p.detach() - p0))
                           for p, p0 in zip(ref.optimizer.params, theta0)])
    return {"losses": losses, "grad_norms": grad, "change_norms": change,
            "names": [n for n, _ in ref.model.named_parameters()], "step1": seen or None}


def train_numbers(spec, args, checked, seed: int, device, control: bool = False):
    """(numbers, readings) of the program's check steps (with `control`, of
    the reference in TF32 put in the program's place): loss_gap (step 1's),
    grad_gap (the worst leaf's) and update_gap (the median leaf's), and
    beside them every step's loss gap and the worst and median leaf of
    both norms."""
    prog = reference_train(args, checked, seed, device, True) if control else checked.program
    ref = reference_train(args, checked, seed, device, step1=prog["step1"])
    if prog["names"] != ref["names"]:
        raise RuntimeError("the reference's parameters are not the program's")
    grad = ref["grad_norms"]
    counted = grad >= 1e-3 * np.median(grad)
    losses = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
              for a, b in zip(prog["losses"], ref["losses"])]
    g = _leaf_gaps(prog["grad_norms"], grad, counted)
    u = _leaf_gaps(prog["change_norms"], ref["change_norms"], counted)
    readings = {"loss_gaps": losses, "grad_worst": float(g.max()),
                "grad_median": float(np.median(g)), "update_worst": float(u.max()),
                "update_median": float(np.median(u)), "leaves": int(counted.size),
                "leaves_left_out": int((~counted).sum())}
    numbers = {"loss_gap": losses[0], "grad_gap": float(g.max()),
               "update_gap": float(np.median(u))}
    if prog["step1"] is not None:
        numbers["targets_gap"] = _targets_gap(prog["step1"], ref["step1"])
    return numbers, readings


def _targets_gap(prog: dict, ref: dict) -> float:
    """Step 1's crop embeddings, the program's against the reference's from
    the same boxes and selection: the largest |difference| over the
    largest |reference| element; inf where the selections or the crops'
    validity differ."""
    import torch

    if not torch.equal(prog["sel"], ref["sel"]):
        return math.inf
    emb, mask = TARGET_EMBEDDING
    if not torch.equal(prog[mask], ref[mask]):
        return math.inf
    d = (prog[emb].double() - ref[emb].double()).abs().max()
    return float(d / ref[emb].double().abs().max().clamp_min(1e-30))


def eval_numbers(spec, args, checked, seed: int, device, control: bool = False) -> dict:
    """box_gap and prob_gap of a sample of the window's batches (with
    `control`, of the reference in TF32 put in the program's place)."""
    import torch

    from portbench.reference import build as R

    n = int(spec.traffic["check_batches"])
    rng = np.random.default_rng([int(seed), 7])
    done = [i for i in checked.done if i in checked.outputs and checked.batches[i] is not None]
    pick = sorted(rng.choice(done, size=min(n, len(done)), replace=False).tolist())
    ref, banks = _reference(args, seed, device)
    box_gap = prob_gap = 0.0
    ties = 0
    for i in pick:
        batch = _to_device(checked.batches[i], device)
        outputs = checked.outputs[i]
        if control:
            with tf32(True):
                outputs = R.eval_outputs(ref, batch)
                outputs["sem_cls_prob"] = R.clip_eval_scores(ref, banks, outputs, batch)
        prog = {k: outputs[k].to(device).double() for k in R.EVAL_KEYS}
        out = R.eval_outputs(ref, batch)
        logits = torch.sort(out["angle_logits"], dim=-1, descending=True).values
        sure = (logits[..., 0] - logits[..., 1]) >= ANGLE_TIE
        ties += int((~sure).sum())
        for key in ("center_unnormalized", "size_unnormalized", "box_corners",
                    "angle_continuous"):
            d = (prog[key] - out[key].double()).abs()
            d = d.reshape(*d.shape[:2], -1).amax(-1)
            box_gap = max(box_gap, float(torch.where(sure, d, 0.0).amax()))
        boxes = checked.crops.get(i) if not control else {
            "box_corners_xyz": outputs["box_corners_xyz"], "size_unnormalized":
            outputs["size_unnormalized"]}
        if boxes is None or len(boxes["box_corners_xyz"]) != len(batch["point_clouds"]):
            return {"box_gap": math.inf, "prob_gap": math.inf}, {"batches": pick}
        sem = R.clip_eval_scores(ref, banks, {k: v.to(device) for k, v in boxes.items()},
                                 batch).double()
        prob_gap = max(prob_gap,
                       float((prog["objectness_prob"] - out["objectness_prob"].double())
                             .abs().amax()),
                       float((prog["sem_cls_prob"] - sem).abs().amax()))
    readings = {"batches": pick, "angle_ties_left_out": ties}
    return {"box_gap": box_gap, "prob_gap": prob_gap}, readings


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): correct when every number is
    finite and at most its limit."""
    compared = {}
    ok = True
    for name, value in numbers.items():
        limit = limits[name]
        compared[name] = {"value": value, "limit": limit}
        if not (math.isfinite(value) and value <= limit):
            ok = False
    return ok, compared
