"""Rank functions of the port's data- and tensor-parallel tests
(tests/test_torch_port_ddp*.py, tests/test_torch_port_tp.py).

`parallel.ddp.launch` starts each rank in a fresh process, which imports the
module of the function it runs; this module imports the port and nothing of
JAX, so a rank starts in a few seconds.  Every function writes what its rank
saw to <out_dir>/rank<r>.pkl for the test to read.
"""

import os
import pickle
import types

import numpy as np
import torch

from coda_neurips2023_tpu_torch.parallel import dist as pdist


def _dump(out_dir, obj):
    with open(os.path.join(out_dir, f"rank{pdist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def load_ranks(out_dir, world):
    """[what rank 0 wrote, what rank 1 wrote, ...]."""
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rows(x, axis=0):
    """This rank's contiguous rows of a global-batch array along `axis`."""
    world, rank = pdist.get_world_size(), pdist.get_rank()
    b = x.shape[axis] // world
    return np.take(x, np.arange(rank * b, (rank + 1) * b), axis=axis)


def primitives(out_dir, loader_cases, bn_case, criterion_case, step_case):
    """The loader's rows, BatchNorm, the criterion's shares and one training
    step, on this rank (one launch for all four)."""
    from coda_neurips2023_tpu_torch.criterion import build_criterion
    from coda_neurips2023_tpu_torch.datasets import config
    from coda_neurips2023_tpu_torch.datasets.loader import make_loader, shard
    from coda_neurips2023_tpu_torch.datasets.sunrgbd import SunrgbdDetectionDataset
    from coda_neurips2023_tpu_torch.engine import make_train_step
    from coda_neurips2023_tpu_torch.models.helpers import BatchNorm
    from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
    from coda_neurips2023_tpu_torch.optimizer import build_optimizer
    from coda_neurips2023_tpu_torch.utils.weights import to_torch

    world, rank = pdist.get_world_size(), pdist.get_rank()
    result = {}

    # the collectives of parallel/dist.py on rank-dependent values
    pdist.barrier()
    result["dist"] = dict(
        average=float(pdist.all_reduce_average(torch.tensor(float(rank)))),
        reduced={k: float(v) for k, v in pdist.reduce_dict(
            {"b": torch.tensor(2.0), "a": torch.tensor(float(rank))}, average=False).items()},
        gathered=pdist.all_gather_dict({"x": np.full((2, 3), rank, np.float32),
                                        "names": [f"r{rank}"]}),
        primary=pdist.is_primary(),
        summed=pdist.sum_over_ranks(np.arange(3) * (rank + 1)))

    # the loader: every epoch's batches of this rank's RankLoader
    loaders = {}
    for name, case in loader_cases.items():
        ds = SunrgbdDetectionDataset(getattr(config, case["config"])(), case["split"],
                                     **case["dataset"])
        loader = shard(make_loader(ds, case["per_rank"] * world, num_workers=2, **case["loader"]))
        loader.epoch = case["first_epoch"]
        loaders[name] = [list(loader) for _ in range(case["epochs"])]
    result["loader"] = loaders

    # BatchNorm in training mode on this rank's rows; the loss is sum(y * gout)
    bn = BatchNorm(bn_case["x"].shape[-1])
    bn.load_state_dict(to_torch(bn_case["state"]))
    x = torch.from_numpy(_rows(bn_case["x"])).requires_grad_()
    y = bn.train()(x)
    (y * torch.from_numpy(_rows(bn_case["gout"]))).sum().backward()
    result["bn"] = dict(y=y.detach().numpy(), dx=x.grad.numpy(), dw=bn.weight.grad.numpy(),
                        db=bn.bias.grad.numpy(), mean=bn.running_mean.numpy(),
                        var=bn.running_var.numpy())

    # the criterion: this rank's share of every loss, per normalizer flag
    shares = {}
    for name, flags in criterion_case["variants"].items():
        crit = build_criterion(types.SimpleNamespace(**flags), config.SunrgbdAnonymousConfig(),
                               num_replicas=world)
        outs = {k: torch.from_numpy(_rows(v, 1)) for k, v in criterion_case["outputs"].items()}
        targets = {k: torch.from_numpy(_rows(v)) for k, v in criterion_case["targets"].items()}
        targets.update({k: torch.as_tensor(v) for k, v in criterion_case["consts"].items()})
        total, losses = crit(outs, targets)
        shares[name] = dict(total=float(total), **{k: float(v) for k, v in losses.items()})
    result["criterion"] = shares

    # one training step of the tiny baseline detector on this rank's rows
    args = types.SimpleNamespace(**step_case["args"])
    model = CoDA3DETR(config.SunrgbdAnonymousConfig(), with_text_head=False,
                      **step_case["model"])
    model.load_state_dict(to_torch(step_case["state"]), strict=True)
    optimizer, schedule = build_optimizer(args, model, 600)
    step = make_train_step(model, build_criterion(args, config.SunrgbdAnonymousConfig(),
                                                  num_replicas=world), optimizer, schedule)
    batch = {k: torch.from_numpy(_rows(v)) for k, v in step_case["batch"].items()}
    batch["lr"] = step_case["lr"]
    metrics = step(batch, torch.Generator().manual_seed(0))
    result["step"] = dict(
        loss=float(metrics["loss"]),
        state={k: v.detach().numpy().copy() for k, v in model.state_dict().items()})
    _dump(out_dir, result)


def abort_on_a_non_finite_loss(out_dir, step_case, nan_rank, nan_step):
    """engine.train_one_epoch over 4 steps of the tiny detector on this
    rank's rows, the criterion's loss made NaN on rank `nan_rank` at step
    `nan_step`; each step is recorded in <out_dir>/rank<r>.steps before the
    loop reads the losses back (every step, log_every=1), and what the loop
    logs (rank 0 alone logs) in <out_dir>/rank<r>.log."""
    from coda_neurips2023_tpu_torch.criterion import build_criterion
    from coda_neurips2023_tpu_torch.datasets import config
    from coda_neurips2023_tpu_torch.engine import make_train_step, train_one_epoch
    from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
    from coda_neurips2023_tpu_torch.optimizer import build_optimizer
    from coda_neurips2023_tpu_torch.utils.weights import to_torch

    rank = pdist.get_rank()
    args = types.SimpleNamespace(**step_case["args"])
    model = CoDA3DETR(config.SunrgbdAnonymousConfig(), with_text_head=False,
                      **step_case["model"])
    model.load_state_dict(to_torch(step_case["state"]), strict=True)
    optimizer, schedule = build_optimizer(args, model, 600)
    criterion = build_criterion(args, config.SunrgbdAnonymousConfig(),
                                num_replicas=pdist.get_world_size())
    steps = []

    def poisoned(outputs, targets):
        loss, losses = criterion(outputs, targets)
        if rank == nan_rank and len(steps) == nan_step:
            loss = loss * float("nan")
        steps.append(len(steps))
        with open(os.path.join(out_dir, f"rank{rank}.steps"), "a") as f:
            f.write(f"{len(steps) - 1}\n")
        return loss, losses

    step = make_train_step(model, poisoned, optimizer, schedule)
    batch = {k: torch.from_numpy(_rows(v)) for k, v in step_case["batch"].items()}
    def log(message):
        with open(os.path.join(out_dir, f"rank{rank}.log"), "a") as f:
            f.write(message + "\n")

    train_one_epoch(step, [batch] * 4, log_every=1, log=log)


def run_main(out_dir, argv, clip_config, clip_params, pinned=None):
    """tmain.main(argv) on this rank, with the tiny CLIP of `clip_params`
    (and, with `pinned`, the pinned tower and crop selection of the stage-2
    test), recording each training step's scans, learning rate and loss, each
    eval step's outputs (of engine.make_eval_step's steps) and the scans the
    last eval metered."""
    from coda_neurips2023_tpu_torch import engine, stages
    from coda_neurips2023_tpu_torch import main as tmain

    stages.StageContext = tiny_clip_context(stages.StageContext, clip_config, clip_params, pinned)
    steps, evals = [], []
    make_train, make_eval = engine.make_train_step, engine.make_eval_step

    def recorded_train(*a, **kw):
        step = make_train(*a, **kw)

        def run(batch, generator=None):
            out = step(batch, generator)
            metrics = out[0] if isinstance(out, tuple) else out
            steps.append(dict(scans=batch["scan_idx"].tolist(), lr=np.float32(metrics["lr"]),
                              loss=float(metrics["loss"])))
            return out

        return run

    def recorded_eval(*a, **kw):
        step = make_eval(*a, **kw)

        def run(batch):
            out = step(batch)
            evals.append({k: v.numpy().copy() for k, v in out.items()})
            return out

        return run

    engine.make_train_step, engine.make_eval_step = recorded_train, recorded_eval
    result = tmain.main(argv, device="cpu")
    if isinstance(result, torch.nn.Module):
        result = {k: v.detach().numpy().copy() for k, v in result.state_dict().items()}
    _dump(out_dir, dict(result=result, steps=steps, evals=evals, scans=engine.EVAL_STATS.get("scans")))


def tiny_clip_context(cls, clip_config, clip_params, pinned=None):
    """A StageContext factory over `cls` with the tiny CLIP of `clip_params`
    and 16-px crops.  `pinned` (a dict): a seeded random superset bank whose
    row pinned["row"] the image tower returns for every crop, and each
    scene's crops its first distillation_box_num proposals, so that runs over
    any number of ranks crop the same boxes and CLIP passes them alike."""
    from coda_neurips2023_tpu_torch.models.clip import CLIP
    from coda_neurips2023_tpu_torch.utils.weights import clip_state_dict_from_flax, to_torch

    def ctx(args, cfg, device="cuda"):
        clip = CLIP(**clip_config)
        clip.load_state_dict(to_torch(clip_state_dict_from_flax(clip_params)), strict=True)
        c = cls(args, cfg, clip_model=clip.eval(), crop_size=16, device=device)
        if pinned:
            rng = np.random.default_rng(0)
            bank = rng.standard_normal(tuple(c.text_banks["superset"].shape)).astype(np.float32)
            bank /= np.linalg.norm(bank, axis=1, keepdims=True)
            c.text_banks["superset"] = torch.from_numpy(bank)
            c.clip_image_fn = lambda images: c.text_banks["superset"][pinned["row"]].expand(
                images.shape[0], -1)
            n_sel = args.distillation_box_num
            c.select_boxes = lambda last, batch, generator=None: torch.arange(n_sel).expand(
                last["objectness_prob"].shape[0], n_sel)
        return c

    return ctx


def tp_steps(case, grid=None, checkpoint_dir=None):
    """The training steps of `case` in this process, on `grid` (parallel/tp.py)
    or, without one, in one process: the tiny detector of case["model"]
    (loaded from case["state"], or drawn by reset_parameters from
    case["init_seed"], its biases then drawn at case["bias_scale"] where
    given), its AdamW and criterion from case["args"], with
    case["clip"] (a config and flax-free state dict) the fused stage-1 step
    with that frozen CLIP, sharded too; case["steps"] steps on this dp
    block's rows of case["batch"], each with step_generator(case["seed"],
    count, rank) when case["seed"] is given.  Returns the losses, each
    step's global gradient norm and mp all-reduce counts, the sharded
    parameters' and moments' slices before the first step, the whole
    gradients of the last step and the whole state after it.  With
    `checkpoint_dir`, on the grid, then also: the trained state saved there
    by every process (utils/io.py; process 0 writes), a fresh model and
    optimizer (drawn from init seed 100 + the dp rank) sharded,
    broadcast_state's slices of it and, resumed from the checkpoint, its
    slices, moments and step count."""
    from coda_neurips2023_tpu_torch.criterion import build_criterion
    from coda_neurips2023_tpu_torch.datasets import config
    from coda_neurips2023_tpu_torch.engine import make_train_step, step_generator
    from coda_neurips2023_tpu_torch.models.clip import CLIP
    from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
    from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
    from coda_neurips2023_tpu_torch.optimizer import build_optimizer
    from coda_neurips2023_tpu_torch.parallel import tp
    from coda_neurips2023_tpu_torch.stages import StageContext
    from coda_neurips2023_tpu_torch.utils.weights import to_torch

    args = types.SimpleNamespace(**case["args"])
    cfg = config.SunrgbdAnonymousConfig()
    model = CoDA3DETR(cfg, **case["model"])
    if "state" in case:
        model.load_state_dict(to_torch(case["state"]), strict=True)
    else:
        gen = torch.Generator().manual_seed(case["init_seed"])
        reset_parameters(model, gen)
        if case.get("bias_scale"):  # flax draws zero biases: give them values
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if name.endswith("bias"):
                        p.add_(case["bias_scale"] * torch.randn(p.shape, generator=gen))
    optimizer, schedule = build_optimizer(args, model, 600)
    criterion = build_criterion(args, cfg, num_replicas=pdist.get_world_size())
    ctx = None
    if "clip" in case:
        clip = CLIP(**case["clip"]["config"])
        clip.load_state_dict(to_torch(case["clip"]["state"]), strict=True)
        ctx = StageContext(args, cfg, clip_model=clip, crop_size=16, device="cpu")
    out = {}
    if grid is not None:
        tp.shard_state_tp(grid, model, optimizer)
        if ctx is not None:
            tp.shard_state_tp(grid, ctx.clip_model)
        out["optimizer_holds_the_slices"] = all(
            p is q for p, q in zip(optimizer.params, model.parameters()))
        out["slices"] = {n: p.detach().numpy().copy() for n, p in model.named_parameters()
                         if hasattr(p, "tp_grid")}
        out["moment_shapes"] = {n: (tuple(m.shape), tuple(v.shape)) for n, m, v in zip(
            optimizer.names, optimizer.mu, optimizer.nu)}
    if ctx is not None:
        step = ctx.make_fused_train_step(model, criterion, optimizer, lr_schedule=schedule)
    else:
        step = make_train_step(model, criterion, optimizer, schedule)
    norms = []
    update = optimizer.step

    def recorded(lr):
        norm = update(lr)
        norms.append(float(norm))
        return norm

    optimizer.step = recorded
    dp, d = pdist.get_world_size(), pdist.get_rank()
    b = len(case["batch"]["point_clouds"]) // dp
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[d * b:(d + 1) * b]))
             for k, v in case["batch"].items()}
    out.update(losses=[], counts=[], norms=norms)
    for _ in range(case.get("steps", 1)):
        tp.reset_counts()
        gen = None
        if case.get("seed") is not None:
            gen = step_generator(case["seed"], optimizer.count, "cpu", d)
        out["losses"].append(float(step(dict(batch), gen)["loss"]))
        out["counts"].append(dict(tp.COUNTS))
    params = dict(model.named_parameters())
    out["grads"] = {n: (tp.gather_shard(grid, p.grad, p) if hasattr(p, "tp_grid") else
                        p.grad.detach()).numpy().copy() for n, p in params.items()}
    state = tp.gather_state_tp(grid, model) if grid is not None else model.state_dict()
    out["state"] = {k: v.detach().numpy().copy() for k, v in state.items()}
    out["local"] = {n: p.detach().numpy().copy() for n, p in params.items()}
    out["sharded"] = sorted(n for n, p in params.items() if hasattr(p, "tp_grid"))
    out["summary"] = tp.tp_param_summary(model, grid.mp if grid is not None else 1)
    if checkpoint_dir is not None:
        out.update(tp_checkpoint(case, grid, model, optimizer, checkpoint_dir))
    return out


def tp_checkpoint(case, grid, model, optimizer, checkpoint_dir):
    """tp_steps' checkpoint round trip on `grid` (see there)."""
    from coda_neurips2023_tpu_torch.datasets import config
    from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
    from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
    from coda_neurips2023_tpu_torch.optimizer import build_optimizer
    from coda_neurips2023_tpu_torch.parallel import ddp, tp
    from coda_neurips2023_tpu_torch.utils import io

    def local(m, opt):
        return dict(params={n: p.detach().numpy().copy() for n, p in m.named_parameters()},
                    mu=[t.numpy().copy() for t in opt.mu], nu=[t.numpy().copy() for t in opt.nu],
                    count=opt.count)

    out = {"trained": local(model, optimizer)}
    path = io.save_checkpoint(checkpoint_dir, model, optimizer, epoch=3)
    out["wrote"] = path is not None
    out["moments"] = {k: {n: t.numpy().copy() for n, t in v.items()}
                      for k, v in tp.gather_optimizer_tp(grid, optimizer).items() if k != "count"}
    fresh = CoDA3DETR(config.SunrgbdAnonymousConfig(), **case["model"])
    reset_parameters(fresh, torch.Generator().manual_seed(100 + grid.dp_rank))
    opt, _ = build_optimizer(types.SimpleNamespace(**case["args"]), fresh, 600)
    tp.shard_state_tp(grid, fresh, opt)
    ddp.broadcast_state(fresh)
    out["broadcast"] = {k: v.numpy().copy() for k, v in tp.gather_state_tp(grid, fresh).items()}
    pdist.barrier()  # process 0's file is whole before anyone reads it
    out["epoch"] = io.resume_if_possible(checkpoint_dir, fresh, opt)[0]
    out["resumed"] = local(fresh, opt)
    return out


def tensor_parallel(out_dir, grid_cases, pair_cases, pair_urls):
    """tests/test_torch_port_tp.py's ranks: on the (dp 2, mp 2) grid of the
    four processes, the scans of each batch of a RankLoader over
    grid_cases["loader"]'s synthetic scenes (2 rows a dp block), the tiny
    CLIP's slices and grid_cases' steps; then
    processes 0-1 and 2-3 each join a process group of two at pair_urls[0]
    and [1], and run pair_cases[0] and [1] on its (dp 1, mp 2) grid; then,
    outside any process group, process p steps the p-th of the pair cases in
    one process ("one").  Writes <out_dir>/rank<process>.pkl."""
    from coda_neurips2023_tpu_torch.datasets import config
    from coda_neurips2023_tpu_torch.datasets.loader import make_loader, shard
    from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset
    from coda_neurips2023_tpu_torch.models.clip import CLIP
    from coda_neurips2023_tpu_torch.parallel import tp
    from coda_neurips2023_tpu_torch.utils.weights import to_torch

    process = pdist.process_rank()
    result = {}
    grid = tp.make_tp_grid(2)
    result["layout"] = dict(dp=grid.dp, mp=grid.mp, dp_rank=grid.dp_rank, mp_rank=grid.mp_rank,
                          world=pdist.get_world_size(), rank=pdist.get_rank(),
                          primary=pdist.is_primary())
    result["loader"] = [b["scan_idx"].tolist() for b in shard(make_loader(
        SyntheticDetectionDataset(config.SunrgbdAnonymousConfig(), **grid_cases["loader"]),
        2 * grid.dp, shuffle=True, seed=5, num_workers=1))]
    clip = CLIP(**grid_cases["clip"]["config"])
    clip.load_state_dict(to_torch(grid_cases["clip"]["state"]), strict=True)
    tp.shard_state_tp(grid, clip)
    result["clip_slices"] = {n: p.detach().numpy().copy() for n, p in clip.named_parameters()
                             if hasattr(p, "tp_grid")}
    result["clip_whole"] = {k: v.numpy().copy() for k, v in tp.gather_state_tp(grid, clip).items()}
    for name, case in grid_cases["steps"].items():
        result[name] = tp_steps(case, grid, os.path.join(out_dir, name))
    pdist.shutdown()
    pdist.init("gloo", pair_urls[process // 2], 2, process % 2)
    grid = tp.make_tp_grid(2)
    for name, case in pair_cases[process // 2].items():
        result[name] = tp_steps(case, grid)
    pdist.shutdown()
    cases = [(name, case) for pair in pair_cases for name, case in pair.items()]
    result["one"] = {name: tp_steps(case) for name, case in cases[process::4]}
    with open(os.path.join(out_dir, f"rank{process}.pkl"), "wb") as f:
        pickle.dump(result, f)
