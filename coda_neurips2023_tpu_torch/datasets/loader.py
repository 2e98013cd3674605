"""Batch loader: host-side prefetching collate over map-style datasets, and
the copy of a batch to the card.

Counterpart of coda_neurips2023_tpu/datasets/loader.py, copied: `collate`,
`Loader` and `make_loader`.  One loader builds the whole global batch, as
the JAX package's single controller does; over several ranks `shard`
wraps it in a `RankLoader`, which gives each rank its rows (below).  String
fields stay lists on the host.

Two worker backends:
  * threads (the default): numpy releases the GIL for the heavy ops;
  * processes (use_processes=True): forkserver workers assembling samples
    in parallel, like the reference's 4-worker DataLoader.

Every backend builds each batch under a deterministic task seed against a
shallow copy of the dataset carrying its own generator, so augmentations
are the same whatever the scheduling or backend.  `pad_last` pads the last
short batch by repeating its last sample and marks the real rows in
"pad_mask", so every batch has one shape and every sample is evaluated.
`prefetch` bounds the batches in flight.

`RankLoader` is the data-parallel loader (parallel/ddp.py): rank r takes
rows [r*B, (r+1)*B) of each global batch, bit for bit the rows of the batch
the JAX package's loader builds at batchsize_per_gpu x R.  A rank cannot
build its rows alone: `_build_batch` draws every sample of a batch in turn
from one generator seeded by the batch's task seed, so rank r's rows depend
on the draws of rows 0 .. r*B - 1.  So rank 0 runs the global batch's loader
(its workers do each sample's work once, as the JAX package's) and hands
every other rank its rows through shared memory (`ddp.send_rows`): rank 0's
host pays one copy of the other ranks' rows a batch, and no rank builds a
sample twice.  The epoch counter, the task seeds and len() are the global
loader's.

`to_device` is the one piece with no JAX counterpart: it copies a batch's
arrays to the device, from pinned host memory and non-blocking on a card.
"""

from __future__ import annotations

import concurrent.futures as cf
import copy
import multiprocessing as mp
from typing import Iterator, Optional

import numpy as np

_STRING_KEYS = ("im_name", "pseudo_box_path", "calib_name")


def collate(samples: list) -> dict:
    batch = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if k in _STRING_KEYS or isinstance(vals[0], str):
            batch[k] = list(vals)
        else:
            batch[k] = np.stack([np.asarray(v) for v in vals])
    return batch


# ---- process workers (forkserver: the dataset is pickled to each worker
# once, by the pool's initializer; batches come back pickled once.
# forkserver, not fork: the parent has CUDA and torch's threads, and forking
# after threads can deadlock.  Workers do host numpy work only and never
# touch the card) ----
_WORKER_DATASET = None


def _proc_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _build_batch(dataset, idxs, batch_size, pad_last, task_seed):
    if task_seed is not None and hasattr(dataset, "rng"):
        # per-task generator on a SHALLOW COPY: thread workers share the
        # dataset object, so mutating dataset.rng in place would race
        dataset = copy.copy(dataset)
        dataset.rng = np.random.default_rng(task_seed)
    samples = [dataset[i] for i in idxs]
    n_valid = len(samples)
    if pad_last and n_valid < batch_size:
        samples = samples + [samples[-1]] * (batch_size - n_valid)
    batch = collate(samples)
    if pad_last:
        mask = np.zeros(len(samples), np.bool_)
        mask[:n_valid] = True
        batch["pad_mask"] = mask
    return batch


def _proc_build_batch(args):
    idxs, batch_size, pad_last, task_seed = args
    return _build_batch(_WORKER_DATASET, idxs, batch_size, pad_last, task_seed)


class Loader:
    def __init__(self, dataset, batch_size, shuffle=False, seed=0, drop_last=True,
                 num_workers=4, pad_last=False, use_processes=False, prefetch=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        # pad_last: one batch shape while evaluating every sample (the
        # reference's eval loaders never drop the tail): the last short batch
        # repeats its last sample and "pad_mask" marks the real rows, which
        # engine.evaluate keeps before the AP meter
        self.pad_last = pad_last and not drop_last
        self.use_processes = use_processes and num_workers > 1
        self.prefetch = prefetch if prefetch is not None else max(2 * num_workers, 2)
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        epoch = self.epoch
        self.epoch += 1
        end = n - (n % self.batch_size) if self.drop_last else n
        out = []
        for bi, start in enumerate(range(0, end, self.batch_size)):
            task_seed = (self.seed * 1_000_003 + epoch * 131_071 + bi) & 0x7FFFFFFF
            out.append((order[start : start + self.batch_size], task_seed))
        return out

    def __iter__(self) -> Iterator[dict]:
        tasks = self._index_batches()
        if self.use_processes:
            yield from self._iter_processes(tasks)
        elif self.num_workers > 1:
            yield from self._iter_threads(tasks)
        else:
            for idxs, task_seed in tasks:
                yield _build_batch(
                    self.dataset, idxs, self.batch_size, self.pad_last, task_seed
                )

    def _iter_threads(self, tasks):
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            futures = []
            for idxs, task_seed in tasks:
                futures.append(
                    pool.submit(
                        _build_batch, self.dataset, idxs, self.batch_size,
                        self.pad_last, task_seed,
                    )
                )
                while len(futures) > self.prefetch:
                    yield futures.pop(0).result()
            for f in futures:
                yield f.result()

    def _iter_processes(self, tasks):
        try:
            ctx = mp.get_context("forkserver")
            # never preload __main__ (the stdlib default): a launching script
            # that sets up CUDA at its top level would replay that inside the
            # forkserver, and every worker would fork from its threads.  No
            # task needs __main__: tasks are tuples and the callables live in
            # this importable module.
            ctx.set_forkserver_preload([])  # no-op if the server is already up
        except ValueError:  # platform without forkserver
            yield from self._iter_threads(tasks)
            return
        args = [
            (idxs, self.batch_size, self.pad_last, task_seed)
            for idxs, task_seed in tasks
        ]
        from collections import deque

        try:
            pool_cm = ctx.Pool(self.num_workers, initializer=_proc_init,
                               initargs=(self.dataset,))
        except Exception:
            # a dataset the forkserver cannot take: threads instead
            yield from self._iter_threads(tasks)
            return
        with pool_cm as pool:
            # at most `prefetch` batches in flight, so a slow consumer cannot
            # pile finished batches up in host memory
            pending = deque()
            for a_ in args:
                pending.append(pool.apply_async(_proc_build_batch, (a_,)))
                while len(pending) >= self.prefetch:
                    yield pending.popleft().get()
            while pending:
                yield pending.popleft().get()


def make_loader(dataset, batch_size, shuffle=False, seed=0, drop_last=True,
                num_workers=4, pad_last=False, use_processes=False, prefetch=None):
    return Loader(dataset, batch_size, shuffle, seed, drop_last, num_workers,
                  pad_last=pad_last, use_processes=use_processes, prefetch=prefetch)


class RankLoader:
    """This rank's rows of each batch of `loader`, a loader of the global
    batch (world x the per-rank batch): rank 0 iterates `loader` and sends
    each other rank its rows; the others receive theirs, len(loader) times."""

    def __init__(self, loader):
        from coda_neurips2023_tpu_torch.parallel import dist as pdist

        self.loader = loader
        self.rank, self.world = pdist.get_rank(), pdist.get_world_size()

    @property
    def epoch(self):
        return self.loader.epoch

    @epoch.setter
    def epoch(self, value):
        self.loader.epoch = value

    def __len__(self):
        return len(self.loader)

    def __iter__(self) -> Iterator[dict]:
        from coda_neurips2023_tpu_torch.parallel import ddp

        if self.rank != 0:
            for _ in range(len(self.loader)):
                yield ddp.receive_rows()
            return
        for batch in self.loader:
            for r in range(1, self.world):
                ddp.send_rows(r, ddp.rows(batch, r, self.world))
            yield ddp.rows(batch, 0, self.world)


def shard(loader):
    """`loader` itself in one process; over several ranks, a RankLoader of it."""
    from coda_neurips2023_tpu_torch.parallel import dist as pdist

    return RankLoader(loader) if pdist.is_distributed() else loader


def to_device(batch: dict, device) -> dict:
    """The batch's arrays as tensors on `device`; list fields (strings) and
    "pad_mask" stay on the host as they are.  On a card each array is put in
    pinned host memory and copied with non_blocking=True, so the copy runs on
    the current stream behind the work already queued and the host goes on."""
    import torch

    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if isinstance(v, list) or k == "pad_mask":
            out[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out
