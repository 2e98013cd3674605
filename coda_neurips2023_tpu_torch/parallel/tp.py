"""Tensor parallelism: Megatron-style sharding of the transformer blocks over
a (dp, mp) grid of processes.

Counterpart of coda_neurips2023_tpu/parallel/tp.py.  The JAX package lays a
2-D ("dp", "mp") mesh over its devices and places each state leaf by path
regex (`_MP_RULES`): the attention heads (q/k/v kernels and biases on their
head axis, the out kernel on its input head axis) and the FFN hidden
dimension (linear1 / c_fc column-parallel with their biases, linear2 /
c_proj row-parallel) are sharded over "mp", in the detector and in both CLIP
towers; every other leaf, the AdamW moments' unmatched ones too, is
replicated, and a leaf whose axis mp does not divide stays replicated.
GSPMD then inserts the collectives.

The port runs one process a rank (parallel/ddp.py) and places them by hand:

  * `make_tp_grid(mp)`: process r = d * mp + m is dp block d and shard m,
    the JAX mesh's device order (`make_tp_mesh`, np.reshape(n // mp, mp)).
    Every process builds every mp group {d * mp + m : m} and dp group
    {d * mp + m : d}, each with a gloo twin for host objects, and probes
    each with one all-reduce; from then on parallel/dist.py reduces over the
    dp group (BatchNorm's sums, the criterion's normalizers, the logged
    losses, the gradient all-reduce, the row rule, the step generator's
    rank), so each block's rows count once.
  * The rules are `_MP_RULES`, verbatim, over flax paths.  A port parameter
    reaches its flax leaves through the weight bridge (utils/weights.py):
    each shardable block's flax subtree is built at the block's shapes and
    passed through the bridge's own `_mha` / `_linear`, once with each
    element's shard number, so the port tensor's elements carry the shard
    that the JAX placement gives them.  The port keeps q, k and v packed in
    `in_proj_weight` (3C, C): its shard is three row blocks, heads
    [m H / mp, (m + 1) H / mp) of each, which the bridge finds by itself.
  * `shard_state_tp(grid, module, optimizer)` replaces each sharded
    parameter by this process's slice (a new nn.Parameter carrying
    `tp_grid`, `tp_axis` and `tp_owner`), slices the AdamW moments alike
    and switches the blocks to the grid; `gather_state_tp` puts the full
    tensors back together (jax.device_get of a sharded state), and
    `gather_optimizer_tp` AdamW's moments: utils/io.py writes a checkpoint
    under a grid with whole tensors, as the JAX package's does, and cuts a
    checkpoint it reads back to this process's slices (`local_slices`).
  * Megatron's f and g: `copy_to_mp` (identity forward, all-reduce of the
    gradient over the mp group backward) on the input of every
    column-parallel product; `reduce_from_mp` (all-reduce forward, identity
    backward) after every row-parallel product, whose bias is added once,
    after the sum (`row_parallel`).  A replicated parameter so ends the
    backward with its whole gradient on each of a block's processes, a
    shard with its own, and the optimizer's global norm counts each shard
    once (optimizer.py).  The frozen CLIP teacher, under no_grad, makes only
    the forward all-reduces.

`constrain_train_step` has no counterpart: GSPMD may gather a sharded
output between steps unless told not to, while here a shard is a tensor of
its own process and stays one.  engine.make_train_step and
StageContext.make_fused_train_step take a sharded model and optimizer as
they are, through the hooks above.

Kernels D, D-bf16, E and E-bf16 run at the local head count (H / mp); the
attention-weight dropout is one (Sq, Skv) mask shared by every head
(ops/masked_attention.py), so each process draws the one-process mask.  The
FFN's dropout draws the full-width mask from the step's generator and keeps
this process's columns (helpers.dropout), so a grid's step with dropout is
the one-process step.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist
import torch.nn.functional as F

from coda_neurips2023_tpu_torch.parallel import dist as pdist
from coda_neurips2023_tpu_torch.utils import weights

# (path regex, rank, sharded dim), JAX parallel/tp.py:47-72
_MP_RULES: Sequence[tuple[str, int, int]] = (
    (r"/(self_attn|multihead_attn)/(query|key|value)/kernel$", 3, 1),
    (r"/(self_attn|multihead_attn)/(query|key|value)/bias$", 2, 0),
    (r"/(self_attn|multihead_attn)/out/kernel$", 3, 0),
    (r"/linear1/kernel$", 2, 1),
    (r"/linear1/bias$", 1, 0),
    (r"/linear2/kernel$", 2, 0),
    (r"/attn/(query|key|value)/kernel$", 3, 1),
    (r"/attn/(query|key|value)/bias$", 2, 0),
    (r"/attn/out/kernel$", 3, 0),
    (r"/c_fc/kernel$", 2, 1),
    (r"/c_fc/bias$", 1, 0),
    (r"/c_proj/kernel$", 2, 0),
)

# the mp all-reduces since the last reset_counts, each with its bytes:
# "forward" (reduce_from_mp), "backward" (copy_to_mp's gradient) and "norm"
# (the optimizer's sum of squares over the shards, Grid.mp_sum)
COUNTS = dict.fromkeys(("forward", "forward_bytes", "backward", "backward_bytes", "norm",
                        "norm_bytes"), 0)


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


@dataclass(eq=False)
class Grid:
    """This process's place on a (dp, mp) grid and its groups (None on the
    trivial grid of one process)."""

    dp: int = 1
    mp: int = 1
    dp_rank: int = 0
    mp_rank: int = 0
    mp_group: Any = None
    mp_host_group: Any = None
    dp_group: Any = None
    dp_host_group: Any = None

    def mp_sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """`tensor` summed over this block's mp processes, outside autograd."""
        return tensor if self.mp == 1 else _all_reduce(tensor.detach(), self, "norm")


def make_tp_grid(mp: int = 2) -> Grid:
    """The (dp, mp) grid over the process group: dp = processes // mp.
    Raises where mp does not divide the processes (outside a process group,
    unless mp is 1: the trivial grid) or a group does not form.  From then
    on, until pdist.shutdown(), parallel/dist.py's reductions in this
    process run over its dp group (pdist.use_data_parallel_groups)."""
    mp = int(mp)
    world, rank = pdist.process_count(), pdist.process_rank()
    if mp < 1 or world % mp:
        raise ValueError(f"mp={mp} does not divide {world} process(es)")
    if world == 1:
        return Grid()
    dp = world // mp
    d, m = divmod(rank, mp)
    nccl = tdist.get_backend() == "nccl"
    device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    mine = {}
    # every process makes every group, in the same order
    for kind, blocks in (("mp", [[b * mp + j for j in range(mp)] for b in range(dp)]),
                         ("dp", [[b * mp + j for b in range(dp)] for j in range(mp)])):
        for ranks in blocks:
            groups = (tdist.new_group(ranks), tdist.new_group(ranks, backend="gloo"))
            if rank in ranks:
                mine[kind] = groups
    for kind, size in (("mp", mp), ("dp", dp)):
        for group, dev in zip(mine[kind], (device, torch.device("cpu"))):
            probe = torch.ones((), device=dev)
            tdist.all_reduce(probe, group=group)
            if int(probe) != size:
                raise RuntimeError(f"the {kind} group of process {rank} summed {int(probe)} "
                                   f"ones, not {size}")
    pdist.use_data_parallel_groups(*mine["dp"])
    return Grid(dp=dp, mp=mp, dp_rank=d, mp_rank=m, mp_group=mine["mp"][0],
                mp_host_group=mine["mp"][1], dp_group=mine["dp"][0],
                dp_host_group=mine["dp"][1])


def shard_spec(path: str, shape, mp: int) -> Optional[int]:
    """The dim of flax leaf `path` (a "/"-joined flax path) of `shape` that
    the rules shard over mp, or None: replicated, as JAX `partition_spec`
    (tp.py:100-111) gives P() for an unmatched leaf and for a matched one
    whose axis mp does not divide."""
    for pat, rank, dim in _MP_RULES:
        if re.search(pat, path) and len(shape) == rank:
            return dim if shape[dim] % mp == 0 else None
    return None


# ---------------------------------------------------------------- the blocks


def _blocks(module):
    """(module path, kind, submodule, flax subtree of leaf shapes) of every
    block the rules may shard: an attention (its packed in_proj and
    out_proj, `weights._mha`) or an FFN product (linear1, linear2, c_fc,
    c_proj: `weights._linear`)."""
    for name, sub in module.named_modules():
        if hasattr(sub, "in_proj_weight"):
            heads = getattr(sub, "nhead", None) or sub.heads
            c3, c_in = sub.in_proj_weight.shape
            d = c3 // 3 // heads
            c_out = sub.out_proj.weight.shape[0]
            tree = {n: {"kernel": (c_in, heads, d), "bias": (heads, d)}
                    for n in ("query", "key", "value")}
            tree["out"] = {"kernel": (heads, d, c_out), "bias": (c_out,)}
            yield name, "mha", sub, tree
        elif name.rsplit(".", 1)[-1] in ("linear1", "linear2", "c_fc", "c_proj"):
            out_dim, in_dim = sub.weight.shape[:2]
            yield name, "linear", sub, {"kernel": (in_dim, out_dim), "bias": (out_dim,)}


def _bridge(kind: str, tree: dict) -> dict:
    """A block's flax subtree of arrays -> {its parameter's local name: the
    port array}, through the weight bridge."""
    sd = {}
    if kind == "mha":
        weights._mha(tree, sd, "")
        return sd
    weights._linear(tree, sd, "")  # ".weight", ".bias"
    return {k[1:]: v for k, v in sd.items()}


def _leaves(tree: dict, prefix: str = ""):
    """(path below the block, shape) of each leaf of a subtree of shapes."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def _arrays(tree: dict, fn, prefix: str = "") -> dict:
    """The subtree with each leaf replaced by fn(path, shape)."""
    return {k: _arrays(v, fn, f"{prefix}/{k}") if isinstance(v, dict) else fn(f"{prefix}/{k}", v)
            for k, v in tree.items()}


def _path(name: str, leaf: str) -> str:
    """The path the rules read: the block's module path, then the flax leaf
    (the rules name only the block and the leaf, which are flax's own)."""
    return "/" + name.replace(".", "/") + leaf


def _flax_leaves(kind: str, tree: dict) -> dict:
    """{local parameter name: the flax leaves it is made of, in tree order}:
    each element of a subtree of leaf numbers, through the bridge."""
    paths = [p for p, _ in _leaves(tree)]
    number = {p: i for i, p in enumerate(paths)}
    port = _bridge(kind, _arrays(tree, lambda p, shape: np.full(shape, number[p])))
    return {local: [paths[i] for i in np.unique(a)] for local, a in port.items()}


def _owners(name: str, kind: str, tree: dict, mp: int) -> dict:
    """{local parameter name: int array of its shape}: the shard each port
    element belongs to under the rules, -1 where replicated."""
    def owner(path, shape):
        dim = shard_spec(_path(name, path), shape, mp)
        if dim is None:
            return np.full(shape, -1, np.int64)
        line = np.arange(shape[dim]) // (shape[dim] // mp)
        return np.broadcast_to(line.reshape([-1 if i == dim else 1 for i in range(len(shape))]),
                               shape).copy()

    return _bridge(kind, _arrays(tree, owner))


def _axis_owner(owner: np.ndarray):
    """(axis, the owners along it) of a port tensor whose shard varies along
    one axis only; None where every element is replicated."""
    if (owner < 0).all():
        return None
    for axis in range(owner.ndim):
        rows = np.moveaxis(owner, axis, 0).reshape(owner.shape[axis], -1)
        if (rows == rows[:, :1]).all() and (rows[:, 0] >= 0).all():
            return axis, rows[:, 0]
    raise ValueError("the rules shard this tensor along more than one axis")


def flax_specs(module, mp: int) -> dict:
    """{port parameter name: {its flax leaves' paths below the block: the
    sharded dim or None}} for the parameters of the shardable blocks; every
    other parameter is one flax leaf that no rule shards."""
    specs = {}
    for name, kind, _, tree in _blocks(module):
        shapes = dict(_leaves(tree))
        for local, paths in _flax_leaves(kind, tree).items():
            specs[f"{name}.{local}"] = {p: shard_spec(_path(name, p), shapes[p], mp)
                                        for p in paths}
    return specs


def tp_param_summary(module, mp: int, optimizer=None):
    """(n_sharded, n_total) flax leaves under the rules, as JAX
    `tp_param_summary` counts them: over the parameters' flax leaves (an
    attention's packed in_proj_weight and in_proj_bias are three leaves
    each); with `optimizer`, over the JAX TrainState's leaves (the step,
    the parameters, AdamW's count, mu and nu, and the BatchNorm statistics
    and constants, one leaf a buffer but num_batches_tracked)."""
    specs = flax_specs(module, mp)
    n_sharded = sum(dim is not None for s in specs.values() for dim in s.values())
    n_total = sum(len(specs[n]) if n in specs else 1 for n, _ in module.named_parameters())
    if optimizer is None:
        return n_sharded, n_total
    buffers = sum(1 for n, _ in module.named_buffers() if not n.endswith("num_batches_tracked"))
    return 3 * n_sharded, 3 * n_total + buffers + 2


def shard_state_tp(grid: Grid, module, optimizer=None):
    """Replace every parameter the rules shard over grid.mp by this
    process's slice, a fresh nn.Parameter (with `optimizer`, in its
    parameter list too, and its mu and nu sliced alike), and switch the
    blocks that hold one to the grid; returns `module`.  On a trivial grid,
    or where the rules shard nothing, nothing changes."""
    if grid.mp == 1:
        return module
    index = {id(p): i for i, p in enumerate(optimizer.params)} if optimizer is not None else {}
    for name, kind, sub, tree in list(_blocks(module)):
        owners = _owners(name, kind, tree, grid.mp)
        sharded = False
        for local, owner in owners.items():
            found = _axis_owner(owner)
            if found is None:
                continue
            axis, line = found
            holder = sub.get_submodule(local.rsplit(".", 1)[0]) if "." in local else sub
            attr = local.rsplit(".", 1)[-1]
            old = getattr(holder, attr)
            keep = torch.as_tensor(np.nonzero(line == grid.mp_rank)[0], device=old.device)
            new = torch.nn.Parameter(old.detach().index_select(axis, keep).clone(),
                                     requires_grad=old.requires_grad)
            new.tp_grid, new.tp_axis, new.tp_owner = grid, axis, line
            setattr(holder, attr, new)
            i = index.get(id(old))
            if i is not None:
                optimizer.params[i] = new
                for moments in (optimizer.mu, optimizer.nu):
                    moments[i] = moments[i].index_select(axis, keep).clone()
            sharded = True
        if sharded:
            # an attention runs its local heads; an FFN product's layer (its
            # parent) its local hidden units
            runner = sub if kind == "mha" else module.get_submodule(name.rsplit(".", 1)[0])
            runner.grid = grid
    return module


def local_columns(param) -> torch.Tensor:
    """The positions, along its sharded axis, of this process's slice of a
    sharded parameter (on its device)."""
    return torch.as_tensor(np.nonzero(param.tp_owner == param.tp_grid.mp_rank)[0],
                           device=param.device)


def gather_shard(grid: Grid, tensor: torch.Tensor, param) -> torch.Tensor:
    """The whole tensor of which `tensor` is this process's shard, laid out
    as sharded parameter `param` (its gradient, a moment): an all-gather
    over the mp group's gloo twin, on every process of the block."""
    axis, line = param.tp_axis, param.tp_owner
    local = tensor.detach().cpu().contiguous()
    parts = [torch.empty_like(local) for _ in range(grid.mp)]
    tdist.all_gather(parts, local, group=grid.mp_host_group)
    shape = list(local.shape)
    shape[axis] = len(line)
    full = torch.empty(shape, dtype=local.dtype)
    for m, part in enumerate(parts):
        full.index_copy_(axis, torch.as_tensor(np.nonzero(line == m)[0]), part)
    return full.to(tensor.device)


@torch.no_grad()
def gather_state_tp(grid: Grid, module) -> dict:
    """The module's state dict with every shard put back together (an
    all-gather over the mp group's gloo twin), on every process: the
    counterpart of jax.device_get of a sharded state, and what a checkpoint
    written under a grid must hold."""
    return {name: gather_shard(grid, t, t) if hasattr(t, "tp_grid") else t.detach()
            for name, t in module.state_dict(keep_vars=True).items()}


def grid_of(module) -> Optional[Grid]:
    """The grid `module`'s sharded parameters lie on, or None."""
    return next((p.tp_grid for p in module.parameters() if hasattr(p, "tp_grid")), None)


@torch.no_grad()
def gather_optimizer_tp(grid: Grid, optimizer) -> dict:
    """The optimizer's state dict with every moment of a sharded parameter
    put back together, on every process (gather_shard)."""
    sd = optimizer.state_dict()
    for key in ("mu", "nu"):
        sd[key] = {name: gather_shard(grid, t, p) if hasattr(p, "tp_grid") else t
                   for (name, t), p in zip(sd[key].items(), optimizer.params)}
    return sd


def local_slices(state: dict, named: dict) -> dict:
    """`state` (whole tensors by name) with the entry of each sharded
    parameter in `named` (name -> parameter) cut to this process's slice."""
    return {k: v.index_select(named[k].tp_axis, local_columns(named[k]).to(v.device))
            if hasattr(named.get(k), "tp_grid") else v for k, v in state.items()}


# ------------------------------------------------------- Megatron's f and g


def _all_reduce(tensor: torch.Tensor, grid: Grid, kind: str) -> torch.Tensor:
    out = tensor.contiguous().clone()
    tdist.all_reduce(out, group=grid.mp_group)
    COUNTS[kind] += 1
    COUNTS[kind + "_bytes"] += out.numel() * out.element_size()
    return out


class _CopyToMP(torch.autograd.Function):
    """f: identity forward, the gradient summed over the mp group backward."""

    @staticmethod
    def forward(ctx, tensor, grid):
        ctx.grid = grid
        return tensor

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.grid, "backward"), None


class _ReduceFromMP(torch.autograd.Function):
    """g: the partial sums summed over the mp group forward, identity
    backward."""

    @staticmethod
    def forward(ctx, tensor, grid):
        return _all_reduce(tensor, grid, "forward")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_mp(*tensors, grid: Optional[Grid]):
    """Each tensor as the input of a column-parallel product (the same
    object given twice passes f once); the tensors themselves off a grid."""
    if grid is None or grid.mp == 1:
        return tensors
    out = []
    for i, t in enumerate(tensors):
        same = next((out[j] for j in range(i) if tensors[j] is t), None)
        out.append(same if same is not None else _CopyToMP.apply(t, grid))
    return tuple(out)


def reduce_from_mp(tensor: torch.Tensor, grid: Grid) -> torch.Tensor:
    return _ReduceFromMP.apply(tensor, grid)


def row_parallel(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 dtype: torch.dtype, grid: Grid) -> torch.Tensor:
    """x @ weight^T summed over the mp group, then the bias: a row-parallel
    product whose local weight holds this process's input columns, at
    compute dtype `dtype` (models/helpers.py `linear`).  In bf16 each
    process's partial product of the bf16 operands is kept in fp32 and the
    sum rounded to bf16 once, as the one-process product rounds, before the
    bf16 bias."""
    w = weight.reshape(weight.shape[0], -1)
    if dtype in (torch.float32, torch.float64):
        y = reduce_from_mp(F.linear(x, w), grid)
        return y if bias is None else y + bias
    y = torch.matmul(x.to(dtype).float(), w.to(dtype).float().t())
    y = reduce_from_mp(y, grid).to(dtype)
    return y if bias is None else y + bias.to(dtype)
