"""Process-level collectives of the data-parallel port.

Counterpart of coda_neurips2023_tpu/parallel/dist.py:1-76 (get_world_size,
get_rank, is_distributed, is_primary, barrier, all_reduce_average,
reduce_dict, all_gather_dict).  The JAX package runs one program over a mesh
and needs these only across hosts; the port runs one process a rank
(parallel/ddp.py starts them), so they carry every cross-rank value.

Two groups: the default group (NCCL on the card, gloo on the CPU) carries
tensors on the rank's device: the gradients, BatchNorm's statistics and the
loss normalizers.  A gloo group beside it (`dist.new_group(backend="gloo")`)
carries host objects: string fields, eval outputs already copied back,
metrics, and the barrier.  Outside a process group every function is what it
is in one process: the identity, a no-op, rank 0 of 1.

The ranks these collectives reduce over are the data-parallel ones.  In a
plain data-parallel run they are every process.  Under a tensor-parallel
grid (parallel/tp.py, `make_tp_grid`) process r = d * mp + m holds shard m of
the model for data block d, and `use_data_parallel_groups` narrows
`get_world_size`, `get_rank` and every reduction to the dp group of r's
block peers {m, mp + m, ...} and its gloo twin: each block's rows count
once, not once a shard.  `process_rank` / `process_count` stay the
process group's own, and so do `is_primary` (process 0 writes) and the
barrier.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as tdist

_HOST_GROUP = None
# under a tensor-parallel grid: (device group, gloo group) of this process's
# data-parallel peers; (None, None) is the whole process group
_DP_GROUPS = (None, None)


def init(backend: str, init_method: str, world_size: int, rank: int) -> None:
    """Join the process group and make the host (gloo) group beside it."""
    global _HOST_GROUP
    tdist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    _HOST_GROUP = tdist.new_group(backend="gloo")


def shutdown() -> None:
    global _HOST_GROUP, _DP_GROUPS
    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()
    _HOST_GROUP, _DP_GROUPS = None, (None, None)


def use_data_parallel_groups(group, host_group) -> None:
    """Reduce over `group` (device tensors) and `host_group` (host objects)
    from now on: a tensor-parallel grid's dp group of this process."""
    global _DP_GROUPS
    _DP_GROUPS = (group, host_group)


def data_parallel_group():
    """The device group the data-parallel reductions run over (None: the
    whole process group)."""
    return _DP_GROUPS[0]


def _initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def process_count() -> int:
    """The processes of the process group (1 outside one)."""
    return tdist.get_world_size() if _initialized() else 1


def process_rank() -> int:
    return tdist.get_rank() if _initialized() else 0


def get_world_size() -> int:
    """The data-parallel ranks: the processes, or a grid's dp blocks."""
    return tdist.get_world_size(_DP_GROUPS[0]) if _initialized() else 1


def get_rank() -> int:
    """This process's data-parallel rank: its process rank, or its grid's dp
    block."""
    return tdist.get_rank(_DP_GROUPS[0]) if _initialized() else 0


def data_parallel_rank(process: int) -> int:
    """The data-parallel rank of process `process`: process // mp on a grid
    of mp shards a block (r = d * mp + m), the process itself without one."""
    return process // (process_count() // get_world_size())


def is_distributed() -> bool:
    return get_world_size() > 1


def is_primary() -> bool:
    """Whether this process writes logs, checkpoints and eval files: process
    0 of a process group, and the one process of any other."""
    return process_rank() == 0


def barrier() -> None:
    if process_count() > 1:
        tdist.barrier(group=_HOST_GROUP)


def global_sum(tensor: torch.Tensor) -> torch.Tensor:
    """The sum of `tensor` over the ranks, outside autograd (a normalizer
    that no gradient flows through: counts, masks, class weights)."""
    if not is_distributed():
        return tensor
    out = tensor.detach().clone()
    tdist.all_reduce(out, group=_DP_GROUPS[0])
    return out


class _GlobalSum(torch.autograd.Function):
    """all_reduce(SUM) forward, all_reduce(SUM) of the gradient backward."""

    @staticmethod
    def forward(ctx, tensor):
        out = tensor.clone()
        tdist.all_reduce(out, group=_DP_GROUPS[0])
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        tdist.all_reduce(grad, group=_DP_GROUPS[0])
        return grad


def differentiable_global_sum(tensor: torch.Tensor) -> torch.Tensor:
    """The sum of `tensor` over the ranks, whose backward sums the gradient
    over the ranks: each rank's input moves every rank's loss through the
    sum, so its gradient is the sum of every rank's."""
    if not is_distributed():
        return tensor
    return _GlobalSum.apply(tensor)


def all_reduce_average(tensor: torch.Tensor) -> torch.Tensor:
    """Mean over the ranks."""
    if not is_distributed():
        return tensor
    return global_sum(tensor) / get_world_size()


def reduce_dict(input_dict: dict, average: bool = True) -> dict:
    """Each 0-d tensor's mean (or sum) over the ranks, in one all-reduce of
    the values stacked in sorted-key order."""
    if not is_distributed():
        return dict(input_dict)
    keys = sorted(input_dict)
    stacked = global_sum(torch.stack([input_dict[k].reshape(()) for k in keys]))
    if average:
        stacked = stacked / get_world_size()
    return dict(zip(keys, stacked.unbind()))


def all_gather_dict(data: dict) -> dict:
    """Every rank's dict of host arrays, each key concatenated on its first
    axis in rank order (lists joined), on every rank."""
    if not is_distributed():
        return data
    parts = [None] * get_world_size()
    tdist.all_gather_object(parts, data, group=_DP_GROUPS[1] or _HOST_GROUP)
    return {k: _concat([p[k] for p in parts]) for k in data}


def sum_over_ranks(value):
    """A host number or numpy array summed over the ranks, on every rank."""
    if not is_distributed():
        return value
    parts = [None] * get_world_size()
    tdist.all_gather_object(parts, value, group=_DP_GROUPS[1] or _HOST_GROUP)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _concat(values: list):
    if isinstance(values[0], list):
        return [x for v in values for x in v]
    return np.concatenate([np.asarray(v) for v in values], axis=0)
