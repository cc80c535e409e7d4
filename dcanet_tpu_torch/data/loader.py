"""Host-side batching, per-process sharding and device prefetch (port of
dcanet_tpu/data/loader.py).

  * `shard_for_host`: the epoch-seeded permutation strided by rank
    (DistributedSampler semantics), so that each process feeds only its
    share of the global batch.
  * `Loader`: epoch-seeded shuffling, thread-pool decode, fixed-shape
    batches of numpy arrays, the next batch assembled while the current one
    is consumed; each process iterates its `shard_for_host` share, by its
    place on the data axis where it is given (`shard`: the disp ranks of a
    row of a (data, disp) grid load the same rows).
  * `device_prefetch`: the torch twin of the JAX package's device_prefetch
    (loader.py:157-194): batches become tensors on the device `depth` steps
    ahead, copied from pinned host memory on a side CUDA stream, so the copy
    overlaps the step that runs.
  * `waited`: counts the batches a consumer takes from an iterator and the
    host seconds it waits for them (`BATCHES`, `WAIT_S`;
    utils/profiling.py::counters), as `cmd_train` does around
    `device_prefetch`.

Eval padding is `data/submission.py::pad_to_multiple` and the per-dataset
eval geometry `data/eval_protocol.py::eval_transform`.

With W processes and a per-process batch b, rank r's batch k holds the
permutation's entries r, r + W, ... of [k W b, (k + 1) W b): together the
ranks' batch k is the one-process batch k of W b samples, as a set.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import time
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from dcanet_tpu_torch.parallel import distributed


def shard_for_host(
    num_samples: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    seed: int = 0,
    shuffle: bool = True,
) -> np.ndarray:
    """Rank-sharded, epoch-seeded permutation (DistributedSampler semantics):
    padded with its own head to a multiple of the process count, so that
    every rank takes as many steps; the rank and count default to this
    process's."""
    pi = distributed.process_index() if process_index is None else process_index
    pc = distributed.process_count() if process_count is None else process_count
    idx = np.arange(num_samples)
    if shuffle:
        idx = np.random.default_rng(seed).permutation(idx)
    pad = (-len(idx)) % pc
    if pad:
        idx = np.concatenate([idx, idx[:pad]])
    return idx[pi::pc]


class Loader:
    """Iterates fixed-shape batches with background decode.

    dataset: StereoDataset-like (len + __getitem__ -> dict of arrays). All
    samples of a batch must share shapes (training crops do; for eval use
    batch_size=1 or pre-padded datasets). Batches of `batch_size` are cut
    from the `shard_for_host` share of `shard` = (index, count), by default
    (process_index(), process_count()) (with one process: the whole epoch
    permutation).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 8, drop_last: bool = True, shard: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard = shard or (distributed.process_index(), distributed.process_count())
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "reseed"):
            self.dataset.reseed(self.seed + epoch)

    def __len__(self) -> int:
        n, pc = len(self.dataset), self.shard[1]
        n = n // pc if self.drop_last else -(-n // pc)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = shard_for_host(len(self.dataset), *self.shard, seed=self.seed + self.epoch, shuffle=self.shuffle)
        # len(self) batches: with drop_last the padded tail of a share that
        # the JAX package would yield as one more batch is dropped, so every
        # global batch is a one-process batch
        nb = len(self)
        # two pools: `batch_pool` assembles the next batch while the caller
        # consumes the current one; `decode_pool` decodes its samples (one
        # shared pool would deadlock: a fetch would starve its own map)
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as decode_pool, \
                cf.ThreadPoolExecutor(max_workers=1) as batch_pool:

            def fetch(bi):
                batch_idx = indices[bi * self.batch_size : (bi + 1) * self.batch_size]
                samples = list(decode_pool.map(self.dataset.__getitem__, batch_idx))
                return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

            pending = None
            for bi in range(nb):
                fut = batch_pool.submit(fetch, bi)
                if pending is not None:
                    yield pending.result()
                pending = fut
            if pending is not None:
                yield pending.result()


def device_prefetch(
    iterator: Iterable[Dict[str, np.ndarray]], device: torch.device, depth: int = 2
) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of numpy arrays -> dicts of tensors on `device`, `depth` ahead.

    On CUDA each batch is copied into pinned host memory and sent with
    non-blocking copies on a side stream; the consumer's stream waits on the
    copy's event before the batch is handed over, and the tensors are
    recorded on that stream so their memory is not reused too early. On the
    CPU the arrays are wrapped as they are.
    """
    device = torch.device(device)
    it = iter(iterator)
    if device.type != "cuda":
        for batch in it:
            yield {k: torch.from_numpy(v) for k, v in batch.items()}
        return
    side = torch.cuda.Stream(device)
    queue = collections.deque()

    def put(batch):
        with torch.cuda.stream(side):
            out = {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True) for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    for batch in it:
        queue.append(put(batch))
        if len(queue) >= depth:
            break
    while queue:
        out, ready = queue.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(ready)
        for t in out.values():
            t.record_stream(consumer)
        nxt = next(it, None)
        if nxt is not None:
            queue.append(put(nxt))
        yield out


BATCHES = 0
WAIT_S = 0.0


def waited(batches: Iterable) -> Iterator:
    """The items of `batches`, each wait for the next one added to
    `WAIT_S` and each item taken to `BATCHES` (the wait for the end too)."""
    global BATCHES, WAIT_S
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        WAIT_S += time.perf_counter() - t0
        if batch is None:
            return
        BATCHES += 1
        yield batch
