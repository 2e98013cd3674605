"""Data parallelism over ranks: the world-size rule, the launcher, the row
rule, the row transport and the gradient all-reduce.

Counterpart of coda_neurips2023_tpu/parallel/mesh.py (`make_mesh`,
`shard_batch`).  The JAX package runs one program over a 1-D "dp" mesh of
min(--ngpus, devices) chips: the global batch of batchsize_per_gpu x R rows
is sharded over the mesh in contiguous blocks (P("dp")), parameters are
replicated, and XLA inserts the collectives.  The port runs one process a
rank instead, and does by hand what the mesh does:

  * the world-size rule (`world_size`): R = min(--ngpus, cards) on the card,
    min(--ngpus, cpu_devices) on the CPU, as the JAX package's
    make_mesh(min(args.ngpus, len(jax.devices())));
  * the launcher (`launch`): torch.multiprocessing.spawn of R processes, each
    on its device (one card a rank, `torch.cuda.set_device`), joined into one
    process group (NCCL on the card, gloo on the CPU; parallel/dist.py); a
    failure to initialise raises, there is no fallback;
  * the row rule (`rows`): rank r owns rows [r*B, (r+1)*B) of the global
    batch, the mesh's contiguous P("dp") blocks (mesh.py:40-74), not
    DistributedSampler's strided i % R;
  * the row transport (`send_rows`, `receive_rows`): rank 0 runs the global
    batch's loader (datasets/loader.py :: RankLoader) and hands every other
    rank its rows through a queue in shared memory: rank r's arrays are
    copied once into one shared-memory buffer a batch, and the queue
    carries its file descriptor, so no rank builds a sample twice;
  * the gradient all-reduce (`all_reduce_gradients`): one flat bucket of the
    detector's gradients summed over the ranks after the backward, before
    the optimizer (each rank's loss is its share of the global loss), and
    `broadcast_state`, rank 0's parameters and buffers to every rank, as DDP
    does when it wraps a model.

Tensor parallelism is parallel/tp.py: on its (dp, mp) grid "the ranks" of
the row rule and the gradient all-reduce are the dp blocks (parallel/dist.py
narrows the reductions to a process's dp group): rank 0 sends block d's rows
to each of its mp processes, and the gradient all-reduce runs over the dp
group.  `broadcast_state` sends a shard over its dp group from block 0's
process of that shard, and the rest from process 0.
"""

from __future__ import annotations

import pickle
import socket

import numpy as np
import torch
import torch.distributed as tdist

from coda_neurips2023_tpu_torch.parallel import dist as pdist

_DEVICE = None  # this rank's device, set by the launcher
_ROW_QUEUES = None  # rank -> the queue its rows arrive on from rank 0


def world_size(ngpus: int, device, cpu_devices: int | None = None) -> int:
    """R = min(--ngpus, the devices of `device`'s type): the cards torch
    sees, or `cpu_devices` CPU "devices" (1 when None)."""
    device = torch.device(device)
    available = torch.cuda.device_count() if device.type == "cuda" else (cpu_devices or 1)
    return max(1, min(int(ngpus), int(available)))


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device() -> torch.device:
    """The device of this rank (set by `launch`)."""
    if _DEVICE is None:
        raise RuntimeError("not inside a rank started by parallel.ddp.launch")
    return _DEVICE


def free_url() -> str:
    """A tcp://localhost rendezvous on a port free at the time of the call."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def launch(fn, world: int, *args, devices, backend: str, dist_url: str):
    """fn(*args) in `world` processes, rank r on devices[r], in one process
    group of `backend` at `dist_url`; returns rank 0's return value (which
    must pickle).  A rank that raises stops every
    rank and the error is raised here; a rank that exits with a code (the
    finiteness abort's 1) makes this process exit with it."""
    import queue

    ctx = torch.multiprocessing.get_context("spawn")
    queues = [None] + [ctx.Queue() for _ in range(1, world)]
    result = ctx.Queue()
    procs = torch.multiprocessing.spawn(
        _rank_entry, args=(world, backend, dist_url, [str(d) for d in devices], queues, result,
                           fn, args),
        nprocs=world, join=False)
    payload = None
    try:
        done = False
        while not done:
            done = procs.join(timeout=0.5)
            # read while rank 0 runs: its queue's feeder flushes before it exits
            while payload is None:
                try:
                    payload = result.get_nowait()
                except queue.Empty:
                    break
    except torch.multiprocessing.ProcessExitedException as e:
        if e.exit_code is not None and e.exit_code > 0:
            raise SystemExit(e.exit_code) from e
        raise
    return pickle.loads(payload) if payload is not None else None


def _rank_entry(rank, world, backend, dist_url, devices, queues, result, fn, args):
    global _DEVICE, _ROW_QUEUES
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # a CPU "device" is one core: ranks whose thread pools spin-wait on
        # cores that other ranks (or other work) hold stall each other
        torch.set_num_threads(1)
    _DEVICE, _ROW_QUEUES = device, queues
    pdist.init(backend, dist_url, world, rank)
    try:
        # one collective on the device first: a backend that cannot run here
        # (NCCL without a card of its own) raises now, not in the first step
        probe = torch.ones((), device=device)
        tdist.all_reduce(probe)
        if int(probe) != world:
            raise RuntimeError(f"{backend} all-reduce over {world} ranks gave {int(probe)}")
        out = fn(*args)
        if rank == 0:
            result.put(pickle.dumps(out))
    finally:
        # a spawned process joins its children before its atexit hooks run,
        # so the AP pool's workers are stopped here or the rank never exits
        from coda_neurips2023_tpu_torch.utils import ap_calculator

        ap_calculator.close_pool()
        pdist.shutdown()


def rows(batch: dict, rank: int, world: int) -> dict:
    """Rank `rank`'s rows [r*B, (r+1)*B) of a global batch of world*B rows
    (arrays and list fields alike)."""
    n = len(next(iter(batch.values())))
    if n % world:
        raise ValueError(f"a global batch of {n} rows does not split over {world} ranks")
    b = n // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def send_rows(rank: int, batch_rows: dict) -> None:
    """Rank 0: put rank `rank`'s rows on its queue: the arrays packed into one
    shared-memory buffer (the queue carries its one file descriptor and the
    layout), the list fields as they are."""
    arrays = {k: np.ascontiguousarray(v) for k, v in batch_rows.items()
              if isinstance(v, np.ndarray)}
    layout, offset = [], 0
    for k, v in arrays.items():
        layout.append((k, offset, v.dtype.str, v.shape))
        offset += -(-v.nbytes // 64) * 64
    buffer = torch.empty(max(offset, 1), dtype=torch.uint8).share_memory_()
    flat = buffer.numpy()
    for k, start, _, _ in layout:
        flat[start:start + arrays[k].nbytes] = arrays[k].reshape(-1).view(np.uint8)
    others = {k: v for k, v in batch_rows.items() if k not in arrays}
    _ROW_QUEUES[rank].put((buffer, layout, others, list(batch_rows)))


def receive_rows() -> dict:
    """Rank r > 0: the next rows rank 0 sent it, as numpy arrays (views of
    the shared buffer) and lists, in the batch's key order."""
    buffer, layout, others, keys = _ROW_QUEUES[pdist.process_rank()].get()
    flat = buffer.numpy()
    for k, start, dtype, shape in layout:
        dtype = np.dtype(dtype)
        others[k] = flat[start:start + int(np.prod(shape)) * dtype.itemsize].view(dtype).reshape(shape)
    return {k: others[k] for k in keys}


def all_reduce_gradients(params) -> int:
    """Sum every parameter's gradient over the data-parallel ranks, in place,
    in one flat all-reduce (a missing gradient counts as zeros, as AdamW
    reads it); returns the bytes all-reduced (0 in one process, and on a
    grid of one dp block).  On a tensor-parallel grid a replicated
    parameter's gradient is already whole on each of a block's mp processes
    (tp.copy_to_mp summed it) and a shard's is its own, so the dp group's sum
    is the global gradient of each."""
    if not pdist.is_distributed():
        return 0
    params = list(params)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    tdist.all_reduce(flat, group=pdist.data_parallel_group())
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)
    return flat.numel() * flat.element_size()


@torch.no_grad()
def broadcast_state(module: torch.nn.Module) -> None:
    """Process 0's parameters and buffers, copied into every process's
    `module` (one broadcast a dtype).  On a tensor-parallel grid a shard
    comes from block 0's process of the same shard, over this process's dp
    group, and every other tensor from process 0."""
    if pdist.process_count() == 1:
        return
    groups = {}
    for t in [*module.parameters(), *module.buffers()]:
        groups.setdefault((t.dtype, getattr(t, "tp_grid", None)), []).append(t)
    for (_, grid), tensors in groups.items():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        if grid is None:
            tdist.broadcast(flat, 0)
        else:  # block 0's process of this shard: process mp_rank
            tdist.broadcast(flat, grid.mp_rank, group=grid.dp_group)
        for t, piece in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(piece.view_as(t))
